"""fastp_tpu_torch: the PyTorch/CUDA port of fastp_tpu.

It reuses fastp_tpu's JAX-free host layers (options, evaluator, FASTQ IO,
native routing, reports) by import and never imports JAX.
"""
