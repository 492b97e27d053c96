"""Metrics: JSONL scalars, PNG image grids, an optional TensorBoard mirror
and a profiler hook (counterpart of scae_tpu/train/metrics.py).

  * scalars are appended to <dir>/metrics.jsonl, one JSON object per event,
    with the JAX package's keys letter for letter (the reference's loss-term
    names: rec_ll_loss, log_prob_loss, the prior_/posterior_ sparsity
    terms, cpr_dynamic_reg_loss, prior_cls_xe, posterior_cls_xe);
  * image grids are written as PNGs under <dir>/images/;
  * the same scalars and grids go to TensorBoard event files under
    <dir>/tb/ where ``torch.utils.tensorboard`` imports (skipped otherwise,
    or when SCAE_TPU_NO_TENSORBOARD is set);
  * ``Profiler`` traces chosen steps with ``torch.profiler`` and writes a
    Chrome trace under <dir>/profile/.
"""

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from scae_tpu_torch.utils.png import make_grid, write_png


def _make_tb_writer(log_dir: str):
    """TensorBoard SummaryWriter if available; None otherwise."""
    if os.environ.get("SCAE_TPU_NO_TENSORBOARD"):
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:   # absent, or a broken TensorBoard install
        return None
    try:
        return SummaryWriter(os.path.join(log_dir, "tb"))
    except Exception:   # the mirror is optional; the JSONL is the record
        return None


def _host(v) -> np.ndarray:
    """A tensor (on any device), numpy array or number as a numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MetricsWriter:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        self.image_dir = os.path.join(log_dir, "images")
        os.makedirs(self.image_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a",
                       buffering=1)
        self._tb = _make_tb_writer(log_dir) if tensorboard else None

    def scalars(self, step: int, values: Dict[str, float],
                prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            rec[f"{prefix}{k}"] = float(_host(v))
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, global_step=int(step))

    def images(self, step: int, name: str, batch_nchw,
               n_cols: int = 8) -> None:
        """Write an (N, C, H, W) image batch as one PNG grid."""
        grid = make_grid(_host(batch_nchw), n_cols=n_cols)
        write_png(os.path.join(self.image_dir,
                               f"{name}_step{int(step):08d}.png"), grid)
        if self._tb is not None:
            g = np.asarray(grid)
            if g.ndim == 2:
                g = g[..., None]
            self._tb.add_image(name, g, global_step=int(step),
                               dataformats="HWC")

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class Profiler:
    """torch.profiler over steps [start, start + count): the Chrome trace
    goes to <log_dir>/profile/trace_step<start>.json."""

    def __init__(self, log_dir: str, start_step: int = -1, n_steps: int = 3):
        self.trace_dir = os.path.join(log_dir, "profile")
        self.start_step = start_step
        self.end_step = start_step + n_steps
        self._prof = None

    def maybe_start(self, step: int) -> bool:
        """Returns True while the trace is active (the train loop then
        syncs each chunk eagerly so traces don't bleed across chunks)."""
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
        return self._prof is not None

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self.end_step:
            prof, self._prof = self._prof, None
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"trace_step{self.start_step}.json"))


def viz_grid_tensors(res, n: int):
    """The small tensors the three grids need, from a forward result: the
    first ``n`` reconstruction modes (and the alternatives' where the
    model made them), the raw templates and the first example's
    transformed templates. Only these are rendered and moved to the
    host."""
    out = {
        "rec_mode": res.rec.pdf.mode()[:n],
        "raw_templates": res.raw_templates[0],        # (M, C, Ht, Wt)
        "transformed_templates": res.transformed_templates[0],
    }
    if res.bottom_up_rec is not None:
        out["bottom_up_mode"] = res.bottom_up_rec.pdf.mode()[:n]
    if res.top_down_rec is not None:
        out["top_down_mode"] = res.top_down_rec.pdf.mode()[:n]
    return out


def write_reconstruction_grids(writer: MetricsWriter, step: int, viz: dict,
                               images, max_n: int = 8) -> None:
    """The reference's three validation grids (base_experiment.py:152-182):
    originals + reconstruction modes (+ alternatives), raw templates,
    transformed templates. ``viz`` is ``viz_grid_tensors``' dict."""
    viz = {k: _host(v) for k, v in viz.items()}
    images = _host(images)
    n = min(max_n, images.shape[0])
    rows = [images[:n], viz["rec_mode"][:n]]
    if "bottom_up_mode" in viz:
        rows.append(viz["bottom_up_mode"][:n])
    if "top_down_mode" in viz:
        rows.append(viz["top_down_mode"][:n])
    writer.images(step, "reconstructions", np.concatenate(rows), n_cols=n)

    raw = viz["raw_templates"]  # (M, C, Ht, Wt)
    writer.images(step, "templates", raw, n_cols=raw.shape[0])

    tt = viz["transformed_templates"]  # (M+1, C, H, W)
    writer.images(step, "transformed_templates", tt, n_cols=tt.shape[0])
