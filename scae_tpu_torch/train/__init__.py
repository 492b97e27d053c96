"""Training harness: data, checkpoints, metrics, the Trainer and its CLI
(counterpart of scae_tpu/train)."""
