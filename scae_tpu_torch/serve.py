"""Deterministic inference (counterpart of scae_tpu/serve.py::make_infer_fn;
export of a serving artifact comes later)."""

from typing import Callable

import torch

from scae_tpu_torch.utils.device import check_model_device, resolve_device


def make_infer_fn(model, with_reconstruction: bool = False,
                  device=None) -> Callable:
    """``infer(image) -> dict`` on ``device`` (CUDA unless given), where
    ``model`` must already live.

    image (B, C, H, W) float in [0, 1] -> {part_presence, part_pose,
    caps_presence[, prior_cls_prob, posterior_cls_prob, prediction,
    prior_prediction][, reconstruction]}. ``prediction`` is the posterior
    classifier's argmax; ``reconstruction`` is the mixture mode.
    """
    device = resolve_device(device)
    check_model_device(model, device)

    @torch.inference_mode()
    def infer(image):
        image = torch.as_tensor(image).to(device=device, dtype=torch.float32)
        res = model(image, deterministic=True)
        out = {
            "part_presence": res.part_presence,
            "part_pose": res.part_pose,
            "caps_presence": res.obj.caps_presence,
        }
        if res.posterior_cls_prob is not None:
            out["prior_cls_prob"] = res.prior_cls_prob
            out["posterior_cls_prob"] = res.posterior_cls_prob
            out["prediction"] = torch.argmax(res.posterior_cls_prob, dim=-1)
            out["prior_prediction"] = torch.argmax(res.prior_cls_prob, dim=-1)
        if with_reconstruction:
            out["reconstruction"] = res.rec.pdf.mode()
        return out

    return infer
