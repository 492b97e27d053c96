"""Deterministic inference and serving artifacts (counterpart of
scae_tpu/serve.py).

``make_infer_fn`` is the live inference surface. ``export_serving`` turns a
model and its weights into a self-contained artifact with
``torch.export``: a directory of

    model.pt2       ``torch.export.save`` of the ExportedProgram of the
                    inference function, parameters inside
    manifest.json   input spec, output names, device, versions, the custom
                    ops the program calls, and the model config

that ``load_serving``, or ``torch.export.load`` after importing
``scae_tpu_torch.kernels``, reads back and calls without the
model's source. Both surfaces compute

    image (B, C, H, W) float32 in [0, 1]  ->
      {part_presence, part_pose, caps_presence[, prior_cls_prob,
       posterior_cls_prob, prediction, prior_prediction][, reconstruction]}

through one function, ``infer_outputs``. ``prediction`` is the posterior
classifier's argmax; ``reconstruction`` (opt-in) is the mixture mode.

Exports default to what the caller built; ``tools/export_model.py``
rebuilds on ``fused_impl="xla"``, as the JAX package's tool does (an
inference forward reads no likelihood, so the choice changes nothing
there). Every program calls the object capsules' vote head by name,
``torch.ops.scae_tpu_torch.capsule_votes_fwd`` (V1f on the card), and a
model with the set transformer's ``use_pallas_attention`` calls K6 too,
``torch.ops.scae_tpu_torch.attention_fwd``: the manifest lists them under
``custom_ops``, and loading needs ``scae_tpu_torch`` importable:
``load_serving`` imports ``scae_tpu_torch.kernels``, which registers every
op of the package.

A trace records device literals (a tensor made on the templates' device,
for one), so export on the device you serve on. ``load_serving(...,
device=)`` moves a program to another device with
``torch.export.passes.move_to_device_pass``.

On a mesh (``parallel/mesh.py``, one process per card) the artifact serves
a global batch split over the mesh's data ranks, as the JAX package's
data-sharded artifact does. The exported program is the per-rank function
at ``batch_size // n_data`` rows, with no collective in it; the manifest
records the global batch, ``batch_axis``, the mesh's shape and
``nr_devices`` (the mesh's size). ``load_serving``, called by every
process of a group of that size, returns a ``ServingModel`` that takes the
global batch on every rank, runs its rows and all-gathers the outputs in
rank order over the data group, so that every rank returns the global
batch's outputs; model ranks replicate.

On the card both surfaces replay a CUDA graph per batch size
(``parallel.graphs.CallGraphs``), the counterpart of the JAX package's one
compiled program a call: the first call at a batch size (and dtype) runs
``graphs.WARMUP_STEPS`` eager calls on a side stream and captures one, all
of a surface's graphs in one memory pool; every call copies the image into
the graph's static input, replays and returns fresh tensors (clones of the
static outputs). The graphs are keyed by ``graphs.tensors_key`` of the
tensors the call reads (the model's parameters and buffers, or the
program's), so a model whose tensors are replaced, not written in place, is
captured again. A call does not walk the module for that key: it checks a
snapshot of the slots the graphs read (``graphs.Slots``), and walks the
module in full (the counter ``graphs.rekeys``) only at the first call and
after the check has seen a change. A capture that fails raises; nothing
falls back to the eager call. A replay calls no kernel wrapper, so a
kernel's launch count grows only at the warm-up and the capture (K6 4
times each with the attention flag); what a replay runs shows in
torch.profiler's device records. Keep the batch fixed (pad the tail) for
one graph. On the CPU both surfaces run eagerly. The eager call stays
reachable for comparison: ``infer.eager`` and ``ServingModel.eager``.

Under a recording profiler a call is the span ``serve.call``, the root of
its request, with ``serve.input`` (the image on the device, the shape
check) and the graphs' spans inside (``utils/trace.py``);
``export_serving`` adds the seconds of ``torch.export.export`` to the
counter ``export.seconds``.
"""

import json
import os
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from scae_tpu_torch.parallel import mesh as mesh_lib
from scae_tpu_torch.parallel.graphs import CallGraphs
from scae_tpu_torch.utils import trace
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


def _graphed(fn, module, device, mesh=None) -> Optional[CallGraphs]:
    """``fn``, which reads the tensors of ``module``, replayed from a CUDA
    graph per batch size on the card (``CallGraphs``; under a mesh the
    graphs let the process group's threads query the card meanwhile); None
    on the CPU, where ``fn`` runs as it is."""
    if device.type != "cuda":
        return None
    return CallGraphs(fn, module, device, capture_error_mode=None
                      if mesh is None else "thread_local")


def make_infer_fn(model, with_reconstruction: bool = False,
                  device=None) -> Callable:
    """``infer(image) -> dict`` on ``device`` (CUDA unless given), where
    ``model`` must already live; the outputs are ``infer_outputs``'. On
    the card a call replays a CUDA graph per batch size (the module's
    docstring); ``infer.eager`` is the same function op by op, and
    ``infer.graphs`` the ``CallGraphs`` (None on the CPU)."""
    device = resolve_device(device)
    check_model_device(model, device)

    def forward(image):
        return infer_outputs(model(image, deterministic=True),
                             with_reconstruction)

    graphs = _graphed(forward, model, device)

    def on_device(fn):
        @torch.inference_mode()
        def run(image):
            with trace.span("serve.call"):
                with trace.span("serve.input"):
                    image = torch.as_tensor(image).to(device=device,
                                                      dtype=torch.float32)
                return fn(image)
        return run

    infer = on_device(graphs or forward)
    infer.eager = on_device(forward)
    infer.graphs = graphs
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

    ``mesh`` (a live ``parallel.mesh.Mesh``; every process of its group
    calls this) exports the data-sharded artifact: ``batch_size``, the
    global batch, must split over the mesh's data ranks (ValueError
    otherwise); each process traces the per-rank program at ``batch_size
    // n_data`` rows, process 0 writes the artifact while the others wait
    at a barrier, and the manifest records ``batch_axis``, the mesh's shape
    and ``nr_devices``. With ``polymorphic_batch`` it is refused by
    ValueError, as in the JAX package. The model's weights are its own
    (the JAX function takes them as ``params``).
    """
    from scae_tpu_torch import __version__

    if mesh is not None:
        if polymorphic_batch:
            raise ValueError(
                "polymorphic_batch and mesh are mutually exclusive: a "
                "serialized sharding pins the batch partitioning")
        if mesh.size > 1 and not mesh.distributed:
            raise ValueError(f"a {mesh.n_data}x{mesh.n_model} mesh that "
                             "spans no process group")
        if batch_size % mesh.n_data:
            raise ValueError(f"a global batch of {batch_size} does not "
                             f"split over the mesh's {mesh.n_data} data "
                             "ranks")
    device = resolve_device(device)
    check_model_device(model, device)
    c, h, w = image_shape
    rows = 2 if polymorphic_batch else batch_size // (
        1 if mesh is None else mesh.n_data)
    example = torch.zeros((rows, c, h, w), dtype=torch.float32,
                          device=device)
    dynamic = {"image": {0: torch.export.Dim("b", min=1)}} \
        if polymorphic_batch else None
    with torch.no_grad(), trace.timed("export.seconds"):
        program = torch.export.export(_Serving(model, with_reconstruction),
                                      (example,), dynamic_shapes=dynamic)
    # the output dict's keys, from the trace (a call would launch kernels)
    out_names = sorted(program.call_spec.out_spec.context)

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
    if mesh is not None:
        manifest.update(batch_axis=batch_axis, nr_devices=mesh.size,
                        mesh={"n_data": mesh.n_data,
                              "n_model": mesh.n_model})
    if mesh is None or mesh_lib.is_process_zero():
        os.makedirs(out_dir, exist_ok=True)
        torch.export.save(program, os.path.join(out_dir, ARTIFACT_NAME))
        with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2)
    if mesh is not None:
        mesh_lib.barrier()
    return out_dir


class ServingModel:
    """A loaded serving artifact: ``model(image) -> dict``.

    ``program`` is the ExportedProgram; the call runs its module on
    ``device`` after checking the image's shape against the manifest, on
    the card from a CUDA graph per batch size (``graphs``; the module's
    docstring), on the CPU eagerly; ``eager(image)`` runs it op by op
    anywhere. With ``mesh`` (a mesh artifact) the image is the global
    batch, the same on every rank: each rank runs its rows and the outputs
    are gathered over the data group, so every rank returns the global
    batch's. The graph holds the local program alone; the gather runs
    after the replay, outside it (gloo's collectives cannot be captured:
    ``graphs.captures_collectives``)."""

    def __init__(self, program, manifest: dict, device: torch.device,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.program = program
        self.manifest = manifest
        self.device = device
        self.mesh = mesh
        self._call = program.module()
        self.graphs = _graphed(self._call, self._call, device, mesh)

    @property
    def input_shape(self):
        """(B, C, H, W), B the global batch; None for a polymorphic-batch
        artifact."""
        return tuple(self.manifest["input"]["shape"])

    def __call__(self, image) -> Dict[str, torch.Tensor]:
        return self._run(self.graphs or self._call, image)

    def eager(self, image) -> Dict[str, torch.Tensor]:
        """The call op by op, with no graph."""
        return self._run(self._call, image)

    def _run(self, call, image) -> Dict[str, torch.Tensor]:
        with trace.span("serve.call"):
            with trace.span("serve.input"):
                image = torch.as_tensor(image).to(device=self.device,
                                                  dtype=torch.float32)
                want = self.input_shape
                if image.dim() != 4 or any(w is not None and g != w for g, w
                                           in zip(image.shape, want)):
                    raise ValueError(
                        f"the artifact takes images of shape {want} (None: "
                        f"any batch), got {tuple(image.shape)}")
            with torch.inference_mode():
                if self.mesh is None:
                    return call(image)
                out = call(mesh_lib.local_rows(image, mesh=self.mesh))
                return {k: mesh_lib.gather_rows(v, self.mesh)
                        for k, v in out.items()}


def load_serving(artifact_dir: str, device=None) -> ServingModel:
    """Load an artifact of ``export_serving``: on the device it was
    exported on, or moved to ``device``. A program that calls custom ops
    (the manifest's ``custom_ops``) needs them registered first: this
    imports ``scae_tpu_torch.kernels``, which registers every op of the
    package.

    A mesh artifact (``batch_axis`` set) is loaded by every process of a
    group of ``nr_devices`` processes, which lays them out as the mesh it
    was exported for (``parallel.mesh.make_mesh``); on the card each
    process takes its current card unless ``device`` is given. ValueError
    where the group's size differs (no group: one process)."""
    with open(os.path.join(artifact_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    mesh = None
    if manifest["batch_axis"] is not None:
        import torch.distributed as dist

        n = manifest["nr_devices"]
        layout = manifest["mesh"]
        if not dist.is_initialized() and n > 1:
            raise ValueError(
                f"{artifact_dir} serves on a {layout['n_data']}x"
                f"{layout['n_model']} mesh of nr_devices={n} processes; "
                "load it under a process group of that size "
                "(torch.distributed.run), not with none")
        if mesh_lib.process_count() != n:
            raise ValueError(
                f"{artifact_dir} serves on a mesh of nr_devices={n} "
                f"processes; this process group has "
                f"{mesh_lib.process_count()}")
        mesh = mesh_lib.make_mesh(**layout)
    if manifest["custom_ops"]:
        try:
            import scae_tpu_torch.kernels  # noqa: F401
        except ImportError as e:
            raise ImportError(
                f"the artifact calls {manifest['custom_ops']}: loading it "
                "needs scae_tpu_torch.kernels (scae_tpu_torch on the "
                "path)") from e
    program = torch.export.load(os.path.join(artifact_dir, ARTIFACT_NAME))
    exported_on = torch.device(manifest["device"])
    if device is not None:
        device = resolve_device(device)
    elif mesh is not None and exported_on.type == "cuda":
        device = resolve_device("cuda")     # this process's card
    else:
        device = exported_on
    if device != exported_on:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return ServingModel(program, manifest, device, mesh)
