"""Runnable examples of the port (counterparts of the repository's
``examples/`` scripts): ``python -m scae_tpu_torch.examples.<name>``."""
