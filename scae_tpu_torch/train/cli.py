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

On several processes, launched by ``torch.distributed.run`` (torchrun),
each process forms the process group before it builds the Trainer, and
``trainer.mesh`` lays the processes out (``n_data`` null: all of them on
the data axis). The group's backend is NCCL on the card and gloo on the
CPU; ``trainer.mesh.backend=gloo`` asks for gloo on the card (several
processes on one card, which NCCL refuses).

Examples:
  python -m scae_tpu_torch.train.cli trainer.max_epochs=2
  python -m scae_tpu_torch.train.cli optimizer=radam use_lookahead=true
  python -m scae_tpu_torch.train.cli model=mnist data_loader.batch_size=64
  python -m torch.distributed.run --nproc_per_node 2 \
      -m scae_tpu_torch.train.cli trainer.mesh.n_data=2
"""

import sys

import torch

from scae_tpu_torch.config import load_config
from scae_tpu_torch.parallel import mesh
from scae_tpu_torch.train.loop import Trainer


def main(argv=None, device=None):
    """Run the CLI on ``argv`` (default: the command line). Returns the
    final TrainState, or the test metrics with ``mode=test``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    overrides = [a.lstrip("+") for a in argv if "=" in a]
    cfg = load_config("config", overrides=overrides)
    backend = ((cfg.get("trainer") or {}).get("mesh") or {}).get("backend")
    if backend is None and device is not None and \
            torch.device(device).type != "cuda":
        backend = "gloo"
    # a multi-process launch forms its group before the first use of the
    # card
    if mesh.maybe_initialize_distributed(backend) and \
            mesh.is_process_zero():
        import torch.distributed as dist

        print(f"[scae_tpu_torch] distributed: process {dist.get_rank()}/"
              f"{dist.get_world_size()} ({dist.get_backend()})")
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
