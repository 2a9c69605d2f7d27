"""fastp_tpu_torch: the PyTorch/CUDA port of fastp_tpu.

The package stands on its own: it keeps its own copies of fastp_tpu's
JAX-free host layers (options, evaluator, FASTQ IO, native routing,
reports) under the same relative names, and imports neither JAX nor
fastp_tpu.
"""
