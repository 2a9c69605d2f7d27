"""Several processes or devices on one job (counterparts of fastp_tpu/parallel)."""
