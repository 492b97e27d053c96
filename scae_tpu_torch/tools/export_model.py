"""Export a trained run's best checkpoint as a serving artifact.

    python -m scae_tpu_torch.tools.export_model CKPT_DIR --out DIR \
        [--batch-size 128] [--with-reconstruction] [--device cuda] \
        [--polymorphic-batch] [-- config overrides matching the run]

The counterpart of tools/export_model.py. It restores the checkpoint of
``CKPT_DIR`` that is best by the run's monitor (else the latest), as
``mode=test`` selects it, rebuilds the model on ``fused_impl="xla"``,
writes the artifact with ``scae_tpu_torch.serve.export_serving`` on
``--device`` (CUDA unless given), and checks it: the artifact, loaded back
with ``load_serving``, against the live model's ``make_infer_fn`` on the
same device and a random batch, predictions equal and every other output
within ``--rtol`` / ``--atol``; with ``--polymorphic-batch`` again at
``batch_size // 2 + 1``, the live model on the same rows. The last line
printed is a JSON object of the artifact, the step and the outputs.

The artifact calls the vote head's custom op,
``scae_tpu_torch::capsule_votes_fwd``, on the CPU too: a consumer that
reads it with ``torch.export.load`` instead of ``load_serving`` imports
``scae_tpu_torch.kernels.capsule_votes`` first, which registers the op.
"""

import argparse
import json
import os

import numpy as np
import torch

from scae_tpu_torch import factory, serve
from scae_tpu_torch.config import load_config
from scae_tpu_torch.tools.ensemble_pool import best_params, split_args
from scae_tpu_torch.utils.device import resolve_device


def check_outputs(got, want, rtol, atol, where=""):
    """Raise unless every prediction of ``got`` equals ``want``'s and every
    other output is within rtol / atol; print each output's gap."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"outputs {sorted(got)} != {sorted(want)}")
    for k in sorted(want):
        g, v = got[k].cpu().numpy(), want[k].cpu().numpy()
        if k.endswith("prediction"):
            n_diff = int(np.sum(g != v))
            print(f"[export]   {k}{where}: {n_diff}/{g.size} predictions "
                  "differ")
            if n_diff:
                raise AssertionError(f"{k}{where}: artifact predictions "
                                     "diverge")
        else:
            denom = np.maximum(np.abs(v), 1e-6)
            print(f"[export]   {k}{where}: max_abs="
                  f"{np.max(np.abs(g - v)):.2e} "
                  f"max_rel={np.max(np.abs(g - v) / denom):.2e}")
            np.testing.assert_allclose(g, v, rtol=rtol, atol=atol,
                                       err_msg=f"{k}{where}")


def main(argv=None) -> dict:
    argv, overrides = split_args(argv)
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="The artifact calls scae_tpu_torch::capsule_votes_fwd: to "
               "read it with torch.export.load rather than load_serving, "
               "import scae_tpu_torch.kernels.capsule_votes first.")
    ap.add_argument("ckpt_dir", help="run checkpoint directory")
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--with-reconstruction", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device to export and check on (default: cuda)")
    ap.add_argument("--rtol", type=float, default=1e-4)
    ap.add_argument("--atol", type=float, default=1e-5)
    ap.add_argument("--polymorphic-batch", action="store_true",
                    help="export with a symbolic batch dim: one artifact "
                         "serves any batch size (checked at --batch-size "
                         "and --batch-size//2+1)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config("config", overrides=overrides)
    mk = dict(cfg["model"])
    pd = dict(mk.get("pcae_decoder_params") or {})
    pd["fused_impl"] = "xla"
    mk["pcae_decoder_params"] = pd
    model = factory.make_scae(mk, device=device)

    params, step = best_params(cfg, args.ckpt_dir)
    model.load_state_dict(params)
    print(f"[export] {args.ckpt_dir}: restored step {step} (monitor="
          f"{cfg['trainer'].get('monitor', 'val_loss')}/"
          f"{cfg['trainer'].get('monitor_mode', 'min')})")

    out = serve.export_serving(
        model, image_shape=mk["image_shape"], batch_size=args.batch_size,
        out_dir=args.out, with_reconstruction=args.with_reconstruction,
        device=device, model_config=mk,
        polymorphic_batch=args.polymorphic_batch)
    size = os.path.getsize(os.path.join(out, serve.ARTIFACT_NAME))
    print(f"[export] wrote {out} ({size / 1e6:.1f} MB, device={device})")

    served = serve.load_serving(out, device=device)
    c, h, w = mk["image_shape"]
    batch = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch_size, c, h, w).astype(np.float32))
    infer = serve.make_infer_fn(
        model, with_reconstruction=args.with_reconstruction, device=device)
    want = infer(batch)
    check_outputs(served(batch), want, args.rtol, args.atol)
    pred = want.get("prediction", torch.zeros(1)).cpu().numpy()
    print(f"[export] VERIFIED: {len(want)} outputs match the live model "
          f"(sample predictions: {pred[:8].tolist()})")
    if args.polymorphic_batch:
        # a symbolic-batch artifact must serve other batch sizes too. The
        # live model runs that batch as well: on the card cuDNN may take
        # other algorithms at another batch size (with bf16 convolutions,
        # part poses then move by up to 6e-2 against the rows of a
        # batch-128 call), so rows of the full batch are no reference
        b2 = args.batch_size // 2 + 1
        check_outputs(served(batch[:b2]), infer(batch[:b2]), args.rtol,
                      args.atol, where=f" at batch {b2}")
        print(f"[export] VERIFIED polymorphic batch: outputs also match "
              f"at batch {b2}")
    result = {"artifact": out, "step": int(step),
              "outputs": served.manifest["outputs"]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
