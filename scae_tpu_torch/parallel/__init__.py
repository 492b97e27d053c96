"""The eval step (counterpart of scae_tpu/parallel)."""
