"""Evaluate a trained torch-reference checkpoint in the port.

    python -m scae_tpu_torch.tools.port_trained \
        [--ckpt logs/r4_ref_trained/last.pt] [--source digits] \
        [--batch-size 128] [--device cuda]

The counterpart of tools/port_trained.py. A user of the PyTorch reference
(bdsaglam/torch-scae) loads a trained ``state_dict`` straight into the
port: ``torch.load`` reads the file (no reference code needed),
``utils/torch_port.py::port_scae`` maps it to the port's ``state_dict``,
and the port's model, built from the repo's copy of the reference's
``mnist.yaml`` (``configs/model/mnist.yaml``, computed in f32 as the
reference computes), evaluates it on the JAX tool's batch: the first
``min(1024, n) // 128 * 128`` images of the validation split of
``tools/ab_ref_train.py::load_split`` (its seed 42, a fifth of the
dataset held out), centre-padded to 40x40 as ``pad_translate(train=False)``
pads them, taken from the port's own ``train/data.py`` (``real_digits``
for "digits", sklearn-free).

The model carries the compat flags of tools/port_trained.py, so that a
migrated model behaves as the reference it was trained in: the reference's
posterior-classifier defects (``compat_posterior_cls_bug``,
``compat_posterior_gate_bug``) and its cross-entropy on softmax outputs
(``compat_double_softmax_xe``). The capsule noise is off: the reference
applies it at eval too, and it has no trained parameters.

Prints the metrics as a JSON line and then one line a metric, with the
value the reference's training log (``metrics.jsonl`` beside the
checkpoint, its last record's ``val_`` entries, taken with the noise on)
recorded where it has one; returns the metrics. The checkpoint under
``logs/`` is not copied to the card's machine: run it with ``--device
cpu`` where the checkpoint is.
"""

import argparse
import json
import os

import numpy as np
import torch

from scae_tpu_torch import factory
from scae_tpu_torch.config import load_config
from scae_tpu_torch.train import data as data_lib
from scae_tpu_torch.utils import torch_port
from scae_tpu_torch.utils.device import resolve_device

COMPAT = {"compat_posterior_cls_bug": True,
          "compat_posterior_gate_bug": True,
          "compat_double_softmax_xe": True}


def model_config() -> dict:
    """The reference's mnist.yaml as the repo keeps it, in f32, with the
    compat flags and the capsule noise off."""
    mk = load_config("config", ["model=mnist"])["model"]
    mk["pcae_cnn_encoder_params"] = dict(mk["pcae_cnn_encoder_params"],
                                         compute_dtype=None)
    mk["pcae_decoder_params"] = dict(mk["pcae_decoder_params"],
                                     fused_tap_dtype="float32")
    mk["ocae_decoder_capsule_params"] = dict(
        mk["ocae_decoder_capsule_params"], noise_type=None, noise_scale=0.0)
    mk["scae_params"] = dict(mk["scae_params"], **COMPAT)
    return mk


def load_split(seed=42, n_train=12000, val_size=5000, source="digits"):
    """tools/ab_ref_train.py::load_split: (train, val) image and label
    arrays, the validation split a fifth of the dataset where val_size
    does not fit."""
    if source == "digits":
        images, labels, _, _ = data_lib.real_digits(size=28, seed=seed)
    else:
        images, labels = data_lib.synthetic_digits(n_train, seed=seed,
                                                   size=28)
    if val_size >= len(images):
        val_size = max(len(images) // 5, 1)
    perm = np.random.RandomState(seed).permutation(len(images))
    val_idx, train_idx = perm[:val_size], perm[val_size:]
    return ((images[train_idx], labels[train_idx]),
            (images[val_idx], labels[val_idx]))


def eval_batch(source="digits"):
    """The JAX tool's eval batch: centre-padded float images (n, 1, 40,
    40) and int64 labels."""
    _, (images, labels) = load_split(source=source)
    n = max((min(len(images), 1024) // 128) * 128, 128)
    x = data_lib.pad_to_canvas(torch.from_numpy(
        data_lib.to_nchw_float(images[:n])), 40)
    return x, torch.from_numpy(labels[:n].astype(np.int64))


def evaluate(model, images, labels, batch=128) -> dict:
    """The mean over batches of every loss term and the accuracy, from the
    deterministic forward."""
    device = next(model.parameters()).device
    sums, nb = {}, 0
    with torch.inference_mode():
        for lo in range(0, len(images), batch):
            img = images[lo:lo + batch].to(device)
            lbl = labels[lo:lo + batch].to(device)
            res = model(img, deterministic=True)
            _, log = model.loss(res, img, lbl)
            log = dict(log, accuracy=model.calculate_accuracy(res, lbl))
            for k, v in log.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            nb += 1
    return {k: v / nb for k, v in sums.items()}


def logged_val(ckpt: str) -> dict:
    """The last ``val_`` record of the training log beside ``ckpt``
    (keys without the prefix), or {}."""
    path = os.path.join(os.path.dirname(ckpt), "metrics.jsonl")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    last = next((r for r in reversed(records)
                 if any(k.startswith("val_") for k in r)), {})
    return {k[4:]: v for k, v in last.items() if k.startswith("val_")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default="logs/r4_ref_trained/last.pt")
    ap.add_argument("--source", default="digits",
                    choices=["synthetic", "digits"])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="device of the eval (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mk = model_config()
    model = factory.make_scae(mk, device=device, seed=0)
    sd = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    model.load_state_dict(torch_port.port_scae(sd, mk["n_obj_caps"]),
                          strict=True)
    images, labels = eval_batch(args.source)
    got = evaluate(model, images, labels, args.batch_size)
    print("[port_trained] scae_tpu_torch ported eval:",
          json.dumps({k: round(v, 4) for k, v in sorted(got.items())}))
    logged = logged_val(args.ckpt)
    for k in sorted(got):
        seen = f" logged={logged[k]:12.4f}" if k in logged else ""
        print(f"[port_trained] {k:40s} port={got[k]:12.4f}{seen}")
    print(f"[port_trained] {len(got)} metrics on {len(images)} val images "
          f"({os.path.basename(args.ckpt)}, {device.type})")
    return got


if __name__ == "__main__":
    main()
