"""Check a serving artifact's readout on the run's own test split.

    python -m scae_tpu_torch.tools.verify_serving_readout ARTIFACT_DIR \
        [--expect 0.8990 --tol 0.002] [--ckpt CKPT_DIR] [--device cuda] \
        -- <config overrides matching the run>

The counterpart of tools/verify_serving_readout.py, on the port's
artifacts (``serve.export_serving``). The artifact serves ``prediction``,
the posterior head's argmax: the head that ``trainer.head_refit`` and
``probe_calibrate`` rewrite. The tool evaluates that output over the run's
held-out test split, in batches of the manifest's batch (128 for a
polymorphic artifact; the last padded with zero images, its rows dropped),
and compares the accuracy with ``--expect`` within ``--tol``, exiting
non-zero when it misses. ``--ckpt`` (the run's checkpoint directory)
supplies ``train_seed.json``, so that the test split is derived as
``mode=test`` derives it. The last line is a JSON object with the JAX
tool's keys. The artifact runs on ``--device`` (CUDA unless given).
"""

import argparse
import json
import os

import numpy as np
import torch

from scae_tpu_torch import serve
from scae_tpu_torch.config import load_config
from scae_tpu_torch.tools.ensemble_pool import split_args
from scae_tpu_torch.train import data as data_lib
from scae_tpu_torch.train import loop
from scae_tpu_torch.utils.device import resolve_device


def main(argv=None) -> dict:
    argv, overrides = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", help="exported artifact dir")
    ap.add_argument("--ckpt", default=None,
                    help="run checkpoint dir (for train_seed.json)")
    ap.add_argument("--expect", type=float, default=None,
                    help="expected test accuracy (e.g. the member's "
                         "probe number)")
    ap.add_argument("--tol", type=float, default=0.002)
    ap.add_argument("--device", default=None,
                    help="device the artifact runs on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config("config", overrides=overrides)
    seed = cfg.get("seed", 42)
    split_seed = cfg["data_loader"].get("split_seed")
    if args.ckpt:
        with open(os.path.join(args.ckpt, "train_seed.json")) as f:
            rec = json.load(f)
        seed = int(rec["seed"])
        if rec.get("split_seed") is not None:
            split_seed = int(rec["split_seed"])
        print(f"[verify_serving] recorded training seed {seed} "
              f"split_seed {split_seed}")
    _, _, test_ds, source = loop.load_run_datasets(cfg, seed, split_seed)

    model = serve.load_serving(args.artifact, device=device)
    B = model.input_shape[0] or 128
    h = cfg["model"]["image_shape"][1]
    imgs = data_lib.pad_to_canvas(torch.from_numpy(
        data_lib.to_nchw_float(test_ds.images)), h)
    labels = np.asarray(test_ds.labels)
    n = len(labels)
    imgs = torch.cat([imgs, imgs.new_zeros(((-n) % B, *imgs.shape[1:]))])
    preds = [model(imgs[i:i + B])["prediction"].cpu().numpy()
             for i in range(0, len(imgs), B)]
    acc = float(np.mean(np.concatenate(preds)[:n] == labels))

    result = {"artifact": args.artifact, "source": source,
              "n_test": int(n), "test_accuracy": round(acc, 6)}
    if args.expect is not None:
        result["expect"] = args.expect
        result["ok"] = bool(abs(acc - args.expect) <= args.tol)
    print(json.dumps(result))
    if args.expect is not None and not result["ok"]:
        raise SystemExit(
            f"serving readout mismatch: artifact test acc {acc:.4f} vs "
            f"expected {args.expect:.4f} (tol {args.tol})")
    return result


if __name__ == "__main__":
    main()
