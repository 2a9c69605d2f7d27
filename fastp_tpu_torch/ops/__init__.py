"""Batched read ops on torch tensors (counterparts of fastp_tpu/ops)."""
