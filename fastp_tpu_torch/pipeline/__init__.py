"""Device step and host processors of the PyTorch port."""
