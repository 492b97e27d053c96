"""Inference throughput of a serving artifact.

    python -m scae_tpu_torch.tools.bench_serving ARTIFACT_DIR \
        [--repeats 20] [--device cuda]

The counterpart of tools/bench_serving.py, on the port's artifacts
(``serve.export_serving``). It loads the artifact and times its call on a
random batch of the manifest's batch size (128 for a polymorphic
artifact), best of ``--repeats`` after one warm-up call, and the same
model driven live (``serve.make_infer_fn`` of the manifest's
``model_config``, random weights from seed 0: the same program as trained
ones) for comparison; a gap means the export lowered something
differently. On the card the device is synchronized before every clock
read. Prints one JSON line with the JAX tool's keys:

  {"artifact_images_per_sec": N, "live_images_per_sec": N,
   "batch_size": B, "backend": "cuda" or "cpu", "outputs": [...]}
"""

import argparse
import json
import time

import numpy as np
import torch

from scae_tpu_torch import factory, serve
from scae_tpu_torch.tools.ensemble_pool import split_args
from scae_tpu_torch.utils.device import resolve_device


def time_fn(fn, batch, repeats, device) -> float:
    """Best-of seconds of ``fn(batch)`` over ``repeats`` calls, after one
    warm-up call; on the card the device is synchronized before every
    clock read."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(batch)
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn(batch)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> dict:
    argv, _ = split_args(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact_dir")
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="device the artifact runs on (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    served = serve.load_serving(args.artifact_dir, device=device)
    b, c, h, w = served.input_shape
    b = b or 128  # polymorphic-batch artifact: pick a serving batch
    batch = torch.from_numpy(np.random.RandomState(0).rand(
        b, c, h, w).astype(np.float32)).to(device)

    t_art = time_fn(served, batch, args.repeats, device)
    result = {
        "artifact_images_per_sec": round(b / t_art, 1),
        "batch_size": b,
        "backend": device.type,
        "outputs": served.manifest["outputs"],
    }
    mk = served.manifest.get("model_config")
    if mk:
        model = factory.make_scae(dict(mk), device=device, seed=0)
        live = serve.make_infer_fn(
            model, with_reconstruction=served.manifest[
                "with_reconstruction"], device=device)
        t_live = time_fn(live, batch, args.repeats, device)
        result["live_images_per_sec"] = round(b / t_live, 1)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
