"""Tensor ops of the port (counterparts of scae_tpu/ops)."""
