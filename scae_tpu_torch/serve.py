"""Deterministic inference and serving artifacts (counterpart of
scae_tpu/serve.py).

``make_infer_fn`` is the live inference surface. ``export_serving`` turns a
model and its weights into a self-contained artifact with
``torch.export``: a directory of

    model.pt2       ``torch.export.save`` of the ExportedProgram of the
                    inference function, parameters inside
    manifest.json   input spec, output names, device, versions, the custom
                    ops the program calls, and the model config

that ``load_serving``, or ``torch.export.load`` alone, reads back and calls
without the model's source. Both surfaces compute

    image (B, C, H, W) float32 in [0, 1]  ->
      {part_presence, part_pose, caps_presence[, prior_cls_prob,
       posterior_cls_prob, prediction, prior_prediction][, reconstruction]}

through one function, ``infer_outputs``. ``prediction`` is the posterior
classifier's argmax; ``reconstruction`` (opt-in) is the mixture mode.

Exports default to what the caller built; ``tools/export_model.py``
rebuilds on ``fused_impl="xla"``, as the JAX package's tool does (an
inference forward reads no likelihood, so the choice changes nothing
there). A model with the set transformer's ``use_pallas_attention`` exports
a program that calls K6 by name, ``torch.ops.scae_tpu_torch.attention_fwd``
(``kernels/attention.py``): the manifest lists it under ``custom_ops``, and
loading it needs ``scae_tpu_torch`` importable, which ``load_serving``
imports. A program with no custom op loads with ``torch`` alone.

A trace records device literals (a tensor made on the templates' device,
for one), so export on the device you serve on. ``load_serving(...,
device=)`` moves a program to another device with
``torch.export.passes.move_to_device_pass``.
"""

import json
import os
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from scae_tpu_torch.utils.device import check_model_device, resolve_device

ARTIFACT_NAME = "model.pt2"
MANIFEST_NAME = "manifest.json"


def infer_outputs(res, with_reconstruction: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """The serving outputs of a deterministic forward's ``SCAEResult``."""
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


def make_infer_fn(model, with_reconstruction: bool = False,
                  device=None) -> Callable:
    """``infer(image) -> dict`` on ``device`` (CUDA unless given), where
    ``model`` must already live; the outputs are ``infer_outputs``'."""
    device = resolve_device(device)
    check_model_device(model, device)

    @torch.inference_mode()
    def infer(image):
        image = torch.as_tensor(image).to(device=device, dtype=torch.float32)
        return infer_outputs(model(image, deterministic=True),
                             with_reconstruction)

    return infer


class _Serving(nn.Module):
    """The exported function: ``image -> infer_outputs``."""

    def __init__(self, model, with_reconstruction: bool):
        super().__init__()
        self.model = model
        self.with_reconstruction = with_reconstruction

    def forward(self, image):
        return infer_outputs(self.model(image, deterministic=True),
                             self.with_reconstruction)


def custom_ops(program) -> list:
    """The names of the operators outside PyTorch's own that an
    ExportedProgram calls, sorted."""
    return sorted({n.target.name() for n in program.graph.nodes
                   if isinstance(n.target, torch._ops.OpOverload)
                   and n.target.namespace not in ("aten", "prims")})


def export_serving(model, *, image_shape: Sequence[int],
                   batch_size: Optional[int], out_dir: str,
                   with_reconstruction: bool = False, device=None,
                   model_config: Optional[dict] = None, mesh=None,
                   batch_axis: str = "data",
                   polymorphic_batch: bool = False) -> str:
    """Export ``model`` with its weights as a serving artifact in
    ``out_dir``, traced on ``device`` (CUDA unless given), where the model
    must live. ``image_shape`` is the model's (C, H, W). Returns
    ``out_dir``.

    ``polymorphic_batch=True`` exports with a symbolic batch dimension
    (``torch.export.Dim("b", min=1)``): one artifact serves any batch
    size; ``batch_size`` is then unused and may be None (the manifest
    records the batch as None). Otherwise the artifact serves
    ``batch_size`` only. The model is batch-parallel on the inference
    path, so the symbolic trace is exact.

    ``mesh`` (a data-sharded artifact in the JAX package, its batch split
    over ``batch_axis``) is refused: with ``polymorphic_batch`` by
    ValueError, as there; on its own by NotImplementedError, until the
    port's serving export is ported to its mesh (ROADMAP, queue 1). The
    model's weights are its own (the JAX function takes them as
    ``params``).
    """
    from scae_tpu_torch import __version__

    if mesh is not None:
        if polymorphic_batch:
            raise ValueError(
                "polymorphic_batch and mesh are mutually exclusive: a "
                "serialized sharding pins the batch partitioning")
        raise NotImplementedError(
            "a data-sharded serving artifact (mesh=) is not in the port's "
            "parallel layer yet (ROADMAP, queue 1: export_serving on a "
            "mesh)")
    device = resolve_device(device)
    check_model_device(model, device)
    c, h, w = image_shape
    example = torch.zeros(
        (2 if polymorphic_batch else batch_size, c, h, w),
        dtype=torch.float32, device=device)
    dynamic = {"image": {0: torch.export.Dim("b", min=1)}} \
        if polymorphic_batch else None
    with torch.no_grad():
        program = torch.export.export(_Serving(model, with_reconstruction),
                                      (example,), dynamic_shapes=dynamic)
    # the output dict's keys, from the trace (a call would launch kernels)
    out_names = sorted(program.call_spec.out_spec.context)

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT_NAME))
    manifest = {
        # batch None = symbolic: the artifact serves any batch size
        "input": {"shape": [None if polymorphic_batch else batch_size,
                            c, h, w], "dtype": "float32",
                  "layout": "NCHW", "range": "[0, 1]"},
        "outputs": out_names,
        "device": str(device),
        "batch_axis": None,
        "polymorphic_batch": polymorphic_batch,
        "with_reconstruction": with_reconstruction,
        "custom_ops": custom_ops(program),
        "torch_version": torch.__version__,
        "scae_tpu_torch_version": __version__,
        "model_config": model_config,
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


class ServingModel:
    """A loaded serving artifact: ``model(image) -> dict``.

    ``program`` is the ExportedProgram; the call runs its module on
    ``device`` after checking the image's shape against the manifest."""

    def __init__(self, program, manifest: dict, device: torch.device):
        self.program = program
        self.manifest = manifest
        self.device = device
        self._call = program.module()

    @property
    def input_shape(self):
        """(B, C, H, W); B is None for a polymorphic-batch artifact."""
        return tuple(self.manifest["input"]["shape"])

    def __call__(self, image) -> Dict[str, torch.Tensor]:
        image = torch.as_tensor(image).to(device=self.device,
                                          dtype=torch.float32)
        want = self.input_shape
        if image.dim() != 4 or any(
                w is not None and g != w for g, w in zip(image.shape, want)):
            raise ValueError(f"the artifact takes images of shape {want} "
                             f"(None: any batch), got {tuple(image.shape)}")
        with torch.inference_mode():
            return self._call(image)


def load_serving(artifact_dir: str, device=None) -> ServingModel:
    """Load an artifact of ``export_serving``: on the device it was
    exported on, or moved to ``device``. A program that calls custom ops
    (the manifest's ``custom_ops``) needs them registered first: this
    imports ``scae_tpu_torch.kernels.attention``, which registers K6's."""
    with open(os.path.join(artifact_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest["custom_ops"]:
        try:
            import scae_tpu_torch.kernels.attention  # noqa: F401
        except ImportError as e:
            raise ImportError(
                f"the artifact calls {manifest['custom_ops']}: loading it "
                "needs scae_tpu_torch.kernels.attention (scae_tpu_torch on "
                "the path)") from e
    program = torch.export.load(os.path.join(artifact_dir, ARTIFACT_NAME))
    exported_on = torch.device(manifest["device"])
    device = exported_on if device is None else resolve_device(device)
    if device != exported_on:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ServingModel(program, manifest, device)
