"""One-process pool runner: train or calibrate many members back to back.

    python -m scae_tpu_torch.tools.pool_inprocess train      [--device cpu]
    python -m scae_tpu_torch.tools.pool_inprocess calibrate  [--device cpu]

The counterpart of tools/pool_inprocess.py, with its members (``MEMBERS``:
the round-5 pool, seeds 500-612 of the flagship recipe ``FLAG`` and
200-280 of ``model=mnist28``), its evaluation overrides and its skip
rules: a member whose log directory holds ``DONE`` is not trained again,
one whose calibrated directory exists is not calibrated again. Each member
trains through the port's ``Trainer`` (stdout appended to its log
directory's ``stdout.log``) and is calibrated by
``tools/probe_calibrate.py`` in this process.

The JAX runner exists to share compiled programs across members through
JAX's persistent compilation cache, which it enables first; the port
compiles no programs and has no counterpart of that call. What members
share here is the process: the CUDA context, the kernels built from
``csrc/`` and loaded once (``kernels/_build.py``), and the cuDNN and
cuBLAS handles. Each member captures its own CUDA graphs (a new model and
optimizer are new tensors).

Determinism is untouched: a member's initialisation, noise and data
streams key off its own seed (``Trainer.init_state``,
``data.load_datasets``), not process state, so a member trained here is
step for step the same recipe trained alone (with cuDNN's deterministic
algorithms on the card).
"""

import argparse
import contextlib
import gc
import os

from scae_tpu_torch.config import load_config
from scae_tpu_torch.train.loop import Trainer

FLAG = [
    "model=mnist",
    "data_loader.source=digits",
    "data_loader.split_seed=7",
    "trainer.monitor=val_accuracy",
    "trainer.monitor_mode=max",
    "trainer.eval_every_epochs=50",
    "lr_scheduler.decay_rate=0.99994",
    "trainer.seed_probe.n=16",
]

MEMBERS = [
    *[(f"f{s}", 4000, [f"seed={s}"]) for s in range(500, 613, 16)],
    *[(f"s{s}", 2000, [f"seed={s}", "model=mnist28",
                       "trainer.augment.max_shift=0"])
      for s in range(200, 281, 16)],
]

EVAL_OVERRIDES = [
    "data_loader.source=digits", "data_loader.split_seed=7",
    "trainer.monitor=val_accuracy", "trainer.monitor_mode=max",
]

DONE = "DONE"


def train_members(members=MEMBERS, log_root="logs/r5_pool",
                  ckpt_root="checkpoints/r5_pool", base_overrides=None,
                  device=None):
    """Train each (name, epochs, overrides) member of ``members`` on
    ``base_overrides`` (default ``FLAG``) on ``device`` (CUDA unless
    given), skipping those already marked ``DONE``."""
    base = FLAG if base_overrides is None else base_overrides
    for name, epochs, extra in members:
        log_dir = os.path.join(log_root, name)
        done = os.path.join(log_dir, DONE)
        if os.path.exists(done):
            print(f"== {name} already done, skipping", flush=True)
            continue
        os.makedirs(log_dir, exist_ok=True)
        print(f"== train {name} (in-process)", flush=True)
        cfg = load_config("config", overrides=base + extra + [
            f"trainer.max_epochs={epochs}",
            f"trainer.log_dir={log_dir}",
            f"trainer.checkpoint_dir={os.path.join(ckpt_root, name)}",
        ])
        with open(os.path.join(log_dir, "stdout.log"), "a") as f, \
                contextlib.redirect_stdout(f):
            trainer = Trainer(cfg, device=device)
            try:
                trainer.run(max_epochs=epochs)
            finally:
                trainer.close()
        del trainer
        gc.collect()
        with open(done, "w"):
            pass
        print(f"== {name} done", flush=True)


def calibrate_members(members=MEMBERS, ckpt_root="checkpoints/r5_pool",
                      out_root="checkpoints/r5_calibrated",
                      log_path="logs/r5_calibrated/calibrate.log",
                      device=None):
    """Bake a probe into each member's posterior head
    (``tools.probe_calibrate``) on ``device``, skipping members whose
    calibrated directory exists."""
    from scae_tpu_torch.tools import probe_calibrate

    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    for name, _, extra in members:
        out = os.path.join(out_root, name)
        if os.path.isdir(out):
            print(f"== {name} already calibrated, skipping", flush=True)
            continue
        print(f"== calibrate {name} (in-process)", flush=True)
        model_extra = [o for o in extra if o.startswith("model=")]
        argv = [os.path.join(ckpt_root, name), "--out", out]
        if device is not None:
            argv += ["--device", str(device)]
        with open(log_path, "a") as f, contextlib.redirect_stdout(f):
            probe_calibrate.main(argv + ["--", *model_extra,
                                         *EVAL_OVERRIDES])
        gc.collect()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="train",
                    choices=["train", "calibrate"])
    ap.add_argument("--device", default=None,
                    help="device of every member (default: cuda)")
    args = ap.parse_args(argv)
    if args.mode == "train":
        train_members(device=args.device)
    else:
        calibrate_members(device=args.device)


if __name__ == "__main__":
    main()
