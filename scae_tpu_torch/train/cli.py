"""Training CLI: python -m scae_tpu_torch.train.cli [overrides...]

The counterpart of ``python -m scae_tpu.train.cli``, with the same
override spelling: group swaps (``optimizer=radam``) and dotted keys
(``trainer.max_epochs=5``, ``data_loader.batch_size=64``); ``+key=value``
is taken as ``key=value`` (overrides create keys by default).
``mode=test`` evaluates the best checkpoint on the test split;
``resume=true`` continues from the latest one. ``trainer.debug_nans=true``
turns on ``torch.autograd.set_detect_anomaly``, which raises at the
operator whose backward made a NaN. The run is on the CUDA card;
``main(argv, device="cpu")`` runs it on the CPU.

Examples:
  python -m scae_tpu_torch.train.cli trainer.max_epochs=2
  python -m scae_tpu_torch.train.cli optimizer=radam use_lookahead=true
  python -m scae_tpu_torch.train.cli model=mnist data_loader.batch_size=64
"""

import sys

import torch

from scae_tpu_torch.config import load_config
from scae_tpu_torch.train.loop import Trainer


def main(argv=None, device=None):
    """Run the CLI on ``argv`` (default: the command line). Returns the
    final TrainState, or the test metrics with ``mode=test``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a.lstrip("+") for a in argv if "=" in a]
    cfg = load_config("config", overrides=overrides)
    if (cfg.get("trainer") or {}).get("debug_nans"):
        torch.autograd.set_detect_anomaly(True)
    trainer = Trainer(cfg, device=device)
    try:
        if cfg.get("mode", "train") == "test":
            return trainer.run_test()
        return trainer.run(resume=bool(cfg.get("resume", False)))
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
