"""SCAE modules as torch.nn.Modules (counterparts of scae_tpu/models)."""
