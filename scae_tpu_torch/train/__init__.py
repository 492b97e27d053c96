"""Data helpers (counterpart of scae_tpu/train)."""
