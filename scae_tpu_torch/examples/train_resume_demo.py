"""Train + resume demo: the script twin of the reference's Colab notebook
(``torch_scae_experiments/mnist/train.ipynb``: train a few epochs,
interrupt, resume from the checkpoint), on the port. The counterpart of
examples/train_resume_demo.py.

Runs the port's Trainer twice on a small config:
  1. train for 2 epochs, checkpointing as it goes;
  2. "interrupt", then resume from the latest checkpoint and finish at
     epoch 4, consuming exactly the data order an uninterrupted run would
     (deterministic resume).

    python -m scae_tpu_torch.examples.train_resume_demo [WORKDIR] \
        [--device cpu]

On the card unless ``--device`` says otherwise. Artifacts land in
WORKDIR (default /tmp/scae_demo): logs/metrics.jsonl, the reconstruction
and template grids under logs/images/, and the checkpoints under ckpt/.
"""

import argparse
import pathlib

from scae_tpu_torch.config import load_config
from scae_tpu_torch.train.loop import Trainer

# a small-but-real model so the demo runs anywhere in minutes
OVERRIDES = [
    "data_loader.batch_size=32",
    "data_loader.synthetic_train=512",
    "data_loader.synthetic_test=64",
    "data_loader.val_size=128",
    "trainer.log_every_steps=5",
    "trainer.max_eval_batches=2",
    "trainer.augment.canvas=28",
    "trainer.augment.max_shift=2",
    "model.image_shape=[1,28,28]",
    "model.n_part_caps=16",
    "model.n_obj_caps=8",
    "model.pcae_cnn_encoder_params.out_channels=[32,32,32,32]",
    "model.pcae_template_generator_params.template_size=[8,8]",
    "model.ocae_encoder_set_transformer_params.dim_hidden=16",
    "model.ocae_encoder_set_transformer_params.dim_out=32",
    "model.ocae_decoder_capsule_params.dim_caps=16",
    "model.ocae_decoder_capsule_params.hidden_sizes=[32]",
]


def overrides(workdir) -> list:
    """OVERRIDES with the checkpoint and log directories under
    ``workdir``."""
    return OVERRIDES + [f"trainer.checkpoint_dir={workdir}/ckpt",
                        f"trainer.log_dir={workdir}/logs"]


def make_trainer(workdir, device=None) -> Trainer:
    return Trainer(load_config("config", overrides=overrides(workdir)),
                   device=device)


def main(argv=None):
    """Both phases; returns the final TrainState."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="/tmp/scae_demo")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: cuda)")
    args = ap.parse_args(argv)
    workdir = pathlib.Path(args.workdir)

    # phase 1: train 2 epochs from scratch
    print(f"[demo] phase 1: training 2 epochs -> {workdir}")
    trainer = make_trainer(workdir, args.device)
    state = trainer.run(max_epochs=2)
    trainer.close()
    print(f"[demo] interrupted at step {int(state.step)}; checkpoints: "
          f"{sorted(p.name for p in (workdir / 'ckpt').iterdir())}")

    # phase 2: a fresh process would do exactly this: resume and finish
    print("[demo] phase 2: resume=True, continuing to epoch 4")
    trainer = make_trainer(workdir, args.device)
    state = trainer.run(max_epochs=4, resume=True)
    trainer.close()
    print(f"[demo] done at step {int(state.step)}. Metrics: "
          f"{workdir}/logs/metrics.jsonl; grids: {workdir}/logs/images/")
    return state


if __name__ == "__main__":
    main()
