"""Batch inference from a trained checkpoint: the serving path. The
counterpart of examples/infer_demo.py, on the port.

It restores the best (else the latest) port checkpoint, serves batches
through ``serve.make_infer_fn`` (on the card a CUDA graph replayed per
batch size: the batch stays fixed and the tail is padded, so one graph
serves every batch) and writes per-image class predictions with
confidences, plus a reconstruction grid.

    python -m scae_tpu_torch.examples.infer_demo \
        trainer.checkpoint_dir=./ckpt data_loader.source=digits \
        [model=... etc.] [--out=./infer_out] [--device=cpu]

The same dotted overrides as the training CLI. The data split is the one
the checkpoints were trained on: the seed recorded beside them
(train_seed.json), the config's split_seed and tint. On the card unless
``--device=`` says otherwise. A checkpoint of scae_tpu (JAX) is read
after ``tools/import_jax_checkpoint.py``.

Outputs, under --out (default ./infer_out):
    predictions.jsonl   one record per image: predicted class,
                        classifier confidence, true label, capsule
                        presence mass
    inference_grid.png  row 1 originals, row 2 reconstructions
"""

import json
import os
import sys

import numpy as np
import torch

from scae_tpu_torch import serve
from scae_tpu_torch.config import load_config
from scae_tpu_torch.train import data as data_lib
from scae_tpu_torch.train.loop import Trainer, load_run_datasets
from scae_tpu_torch.utils.png import make_grid, write_png


def main(argv=None) -> dict:
    """Returns {"records": [...], "accuracy": float, "step": int}."""
    argv = sys.argv[1:] if argv is None else argv
    out_dir, device = "./infer_out", None
    overrides = []
    for a in argv:
        if a.startswith("--out="):
            out_dir = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            overrides.append(a)

    cfg = load_config("config", overrides=overrides)
    trainer = Trainer(cfg, device=device)

    # the split must match training: the recorded training seed
    seed = trainer._recorded_seed()
    if seed is None:
        seed = cfg.get("seed", 42)
    train_ds, _, test_ds, source = load_run_datasets(cfg, seed)

    steps_per_epoch = max(len(train_ds) // trainer.batch_size, 1)
    trainer.build_steps(steps_per_epoch)
    state = trainer.init_state(seed)
    if trainer.ckpt.latest_step is None:
        raise FileNotFoundError(f"no checkpoint to serve in "
                                f"{trainer.ckpt.directory}")
    step = trainer.ckpt.best_step or trainer.ckpt.latest_step
    state = trainer.ckpt.restore(state, step=step)
    print(f"[infer] restored checkpoint {step} from "
          f"{trainer.ckpt.directory} (data: {source}, seed {seed})")

    infer = serve.make_infer_fn(trainer.model, with_reconstruction=True,
                                device=trainer.device)
    os.makedirs(out_dir, exist_ok=True)
    B = trainer.batch_size
    n = min(len(test_ds), 4 * B)
    images = data_lib.pad_to_canvas(torch.from_numpy(
        data_lib.to_nchw_float(test_ds.images[:n])), trainer.canvas)
    labels = np.asarray(test_ds.labels[:n])

    records, correct = [], 0
    first_out = None
    for i in range(0, n, B):
        batch = images[i:i + B]
        k = len(batch)
        # a fixed shape: one graph
        batch = torch.cat([batch, batch.new_zeros((B - k, *batch.shape[1:]))])
        out = infer(batch)
        cls_prob = out.get("posterior_cls_prob", out.get("prior_cls_prob"))
        out = {"pred": cls_prob.argmax(-1), "confidence": cls_prob.max(-1)
               .values, "presence_mass": out["caps_presence"].sum(-1),
               "recon": out["reconstruction"]}
        out = {key: v.cpu().numpy() for key, v in out.items()}
        out["padded"] = batch.numpy()
        if first_out is None:
            first_out = out
        for j in range(k):
            rec = {
                "index": i + j,
                "pred": int(out["pred"][j]),
                "confidence": round(float(out["confidence"][j]), 4),
                "label": int(labels[i + j]),
                "capsule_presence_mass":
                    round(float(out["presence_mass"][j]), 3),
            }
            correct += rec["pred"] == rec["label"]
            records.append(rec)
    trainer.close()

    with open(os.path.join(out_dir, "predictions.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")

    # row 1 originals, row 2 reconstructions: m bounded by the first
    # batch's real (unpadded) image count so the rows stay aligned
    m = min(16, B, len(records))
    grid = make_grid(np.concatenate([first_out["padded"][:m],
                                     first_out["recon"][:m]]), n_cols=m)
    write_png(os.path.join(out_dir, "inference_grid.png"), grid)

    accuracy = correct / len(records)
    print(f"[infer] {len(records)} images -> {out_dir}/predictions.jsonl"
          f" + inference_grid.png; accuracy {accuracy:.4f}"
          f" (supervised-classifier head on {source} test split)")
    return {"records": records, "accuracy": accuracy, "step": step}


if __name__ == "__main__":
    main()
