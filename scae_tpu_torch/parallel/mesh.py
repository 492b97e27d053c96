"""The (data, model) mesh on ``torch.distributed`` (counterpart of
scae_tpu/parallel/mesh.py).

JAX computes a mesh's step as one program over the global batch: the batch
is split over the "data" axis, the parameters are replicated, and XLA
inserts the gradient all-reduce; the capsule banks of the object decoder
(O independent MLPs stored (O, in, out), ``models/layers.py::StackedMLP``)
may be split over the "model" axis, and XLA carries the (B, O, ...)
sharding through the einsums with no collective until the first reduction
over capsules. The port runs one process per mesh position and makes the
same program by hand:

  * every process holds the same full dataset and index stream, made from
    the shared seed, and takes its own rows of each global batch
    (``local_rows``); random draws are made for the global batch on every
    process and sliced (``global_rows``), so a mesh run draws what the
    single-process run draws;
  * the loss terms that are not means over examples (the between-example
    sparsity terms, which square or take the entropy of the column sum of
    the capsule presences over the batch) sum that column over the data
    group (``batch_sum``, whose backward is a sum too), and the accuracy,
    a maximum of two means, takes the global means first (``batch_mean``);
  * the steps average the gradients and the metrics over the data group in
    one all-reduce (``mean_over_data``);
  * with the banks split (``param_shardings``, ``train_step.shard_state``),
    the capsule layer takes its capsules' features through ``to_model_ranks``
    (identity forward, a sum over the model group backward), runs its O/n
    capsules, and gathers their outputs along the capsule axis
    (``gather_capsules``: all-gather forward, this rank's slice backward)
    before its first reduction over capsules.

The model code reads the mesh that the steps make active (``use``); with
none active every function here is the identity and calls no collective.
The collectives are written from ``all_reduce`` and ``all_gather`` alone,
which gloo has on CUDA tensors too.
"""

import contextlib
import dataclasses
import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# how long a collective waits for a lost rank before every rank raises
TIMEOUT_S = 60
# the launcher's variables (torchrun's), all four needed to form a group
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Form the default process group where a multi-process launch is
    detected (torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT`` and ``LOCAL_RANK``), before the first use of the card.

    Returns False where none of the four is set; True where a group exists
    afterwards: one formed here, or one the caller formed (left as it is).
    Raises ValueError where only some of them are set. ``backend``: NCCL
    where CUDA is available and gloo otherwise, unless given; under NCCL
    the process takes card ``LOCAL_RANK``. A collective that waits longer
    than ``TIMEOUT_S`` for a lost rank raises."""
    if dist.is_initialized():
        return True
    present = [v for v in LAUNCH_VARS if v in os.environ]
    if not present:
        return False
    missing = [v for v in LAUNCH_VARS if v not in os.environ]
    if missing:
        raise ValueError(f"a multi-process launch sets {present} but not "
                         f"{missing}; launch with python -m "
                         "torch.distributed.run")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend=backend, init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def run_local(cmd: Sequence[str], world: int, timeout: float,
              env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run ``cmd`` as ``world`` processes of one group on this host, each
    with torchrun's variables (``RANK`` = ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``) over ``env``
    (default: this process's). Returns each rank's output (stdout and
    stderr). As soon as one rank fails, or at ``timeout`` seconds, the
    others are killed and RuntimeError names the rank with the end of its
    output."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = dict(os.environ if env is None else env)
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = []
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                list(cmd), cwd=cwd, stdout=logs[rank],
                stderr=subprocess.STDOUT,
                env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                         WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port))))
        deadline = time.monotonic() + timeout
        while (any(p.poll() is None for p in procs)
               and all(p.returncode in (None, 0) for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read())
        log.close()
    # the rank that failed first, before the ranks killed after it
    failed = sorted((p.returncode < 0, rank) for rank, p in enumerate(procs)
                    if p.returncode != 0)
    if failed:
        rank = failed[0][1]
        raise RuntimeError(
            f"rank {rank} of {world} exited with {procs[rank].returncode} "
            f"(killed where negative; timeout {timeout} s): {list(cmd)}\n"
            + outputs[rank][-4000:])
    return outputs


def is_process_zero() -> bool:
    """Host side effects (metrics, grids, checkpoints, prints) run only on
    process 0: rank 0, or the only process where no group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    """The processes of the default group (1 where none exists)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier():
    """Wait for every process of the default group (none: return)."""
    if dist.is_initialized():
        dist.barrier()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (n_data, n_model) layout of the processes, row-major as JAX's
    ``reshape(n_data, n_model)``: rank = d * n_model + m. ``data_group``
    holds the ranks of this rank's column (its m, every d), ``model_group``
    those of its row; both None where no process group exists."""

    n_data: int
    n_model: int
    d: int = 0
    m: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    backend: Optional[str] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans a process group (its collectives run,
        even at size 1)."""
        return self.data_group is not None


def mesh_shape(world: int, n_data: Optional[int] = None,
               n_model: int = 1) -> Tuple[int, int]:
    """(n_data, n_model) over ``world`` processes: ``n_data`` None means
    ``world // n_model``. ValueError unless the product is ``world``."""
    n_model = int(n_model)
    if n_model < 1:
        raise ValueError(f"n_model must be at least 1, got {n_model}")
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    return n_data, n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over the default process group (every rank
    must call it, in the same order as its other groups), or a 1x1 mesh
    without groups where no group exists."""
    if not dist.is_initialized():
        return Mesh(*mesh_shape(1, n_data, n_model))
    world, rank = dist.get_world_size(), dist.get_rank()
    n_data, n_model = mesh_shape(world, n_data, n_model)
    d, m = divmod(rank, n_model)
    data_groups = [dist.new_group([dd * n_model + mm for dd in range(n_data)])
                   for mm in range(n_model)]
    model_groups = [dist.new_group([dd * n_model + mm
                                    for mm in range(n_model)])
                    for dd in range(n_data)]
    return Mesh(n_data, n_model, d, m, data_groups[m], model_groups[d],
                dist.get_backend())


def live(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` where it spans a process group, else None: the steps take
    the single-process path for None and for a mesh without groups."""
    return mesh if mesh is not None and mesh.distributed else None


# ----------------------------------------------------- the active mesh

_active: Optional[Mesh] = None


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the model code reads for the block (None: the
    single-process path)."""
    global _active
    previous, _active = _active, live(mesh)
    try:
        yield
    finally:
        _active = previous


def active() -> Optional[Mesh]:
    return _active


# --------------------------------------------------------- batch rows

def local_rows(x, dim: int = 0, mesh: Optional[Mesh] = None):
    """This rank's rows of a global batch ``x`` (a tensor or numpy array)
    along ``dim``: the d-th of n_data equal parts (the counterpart of
    ``make_global_array``'s "each process fills only its shards"). The
    active mesh unless ``mesh`` is given; ``x`` itself without one.
    ValueError unless n_data divides the batch."""
    mesh = _active if mesh is None else mesh
    if mesh is None or mesh.n_data == 1:
        return x
    n = x.shape[dim]
    if n % mesh.n_data:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{mesh.n_data} data ranks")
    b = n // mesh.n_data
    return x[(slice(None),) * dim + (slice(mesh.d * b, (mesh.d + 1) * b),)]


def global_rows(n: int) -> int:
    """The global batch of which a rank's ``n`` rows are a part."""
    return n if _active is None else n * _active.n_data


# -------------------------------------------------------- collectives

class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) forward and backward: each rank computes the same
    function of the sum, and the steps average the gradients over the
    ranks, so each rank's part gets the sum of every rank's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: a replicated input
    that each rank uses a part of (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherRows(torch.autograd.Function):
    """All-gather of a 1-D buffer into (n, L) forward; backward keeps this
    rank's row: every rank computes the same function of the gathered
    tensor, so its gradient is already whole on each (Megatron's g)."""

    @staticmethod
    def forward(ctx, flat, group, rank, size):
        ctx.rank = rank
        parts = [torch.empty_like(flat) for _ in range(size)]
        dist.all_gather(parts, flat.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank].contiguous(), None, None, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active mesh's data group (a column sum over
    the batch becomes the global batch's); its gradient is summed too."""
    if _active is None:
        return x
    return _SumOverGroup.apply(x, _active.data_group)


@torch.no_grad()
def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``x``, a mean over this rank's rows, as the global batch's mean (no
    gradient: for metrics)."""
    if _active is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=_active.data_group)
    return out / _active.n_data


def to_model_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the model group, for each rank to take its
    capsules from; its gradient is summed over the group."""
    if _active is None or _active.n_model == 1:
        return x
    return _ToGroup.apply(x, _active.model_group)


def gather_capsules(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each (lead, O/n, ...) tensor of this rank's capsules as (lead, O,
    ...), the model group's parts in rank order along axis 1, in one
    all-gather; each gradient keeps this rank's part."""
    mesh = _active
    n = mesh.n_model
    flat = torch.cat([t.reshape(-1) for t in tensors])
    rows = _GatherRows.apply(flat, mesh.model_group, mesh.m, n)   # (n, L)
    out = []
    for t, part in zip(tensors, rows.split([t.numel() for t in tensors], 1)):
        part = part.reshape(n, *t.shape).movedim(0, 1)   # (lead, n, O/n, ..)
        out.append(part.reshape(t.shape[0], n * t.shape[1], *t.shape[2:]))
    return out


@torch.no_grad()
def mean_over_data(tensors: Sequence[torch.Tensor],
                   mesh: Mesh) -> List[torch.Tensor]:
    """``tensors`` (one dtype) averaged over ``mesh``'s data group, in one
    all-reduce of one flat buffer."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise TypeError(f"mean_over_data takes one dtype, got {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.n_data
    return [part.view(t.shape) for t, part in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


# ------------------------------------------------------ capsule banks

def bank_axis(name: str, shape: Sequence[int], n_model: int
              ) -> Optional[int]:
    """The axis over which parameter ``name`` of ``shape`` splits over
    ``n_model`` model ranks, or None (JAX's ``_capsule_bank_spec`` with its
    divisibility rule): the capsule layer's StackedMLP ``kernel_*`` and
    ``bias_*`` (O, ...) on axis 0, its ``cpr_static`` and ``caps_bias_*``
    (1, O, ...) on axis 1; only where ``n_model`` divides that axis."""
    parts = name.split(".")
    if n_model <= 1 or "capsule_layer" not in parts:
        return None
    leaf = parts[-1]
    if leaf.startswith(("kernel_", "bias_")):
        axis = 0
    elif leaf == "cpr_static" or leaf.startswith("caps_bias_"):
        axis = 1
    else:
        return None
    return axis if shape[axis] % n_model == 0 else None


def param_shardings(mesh: Mesh, model: torch.nn.Module,
                    shard_capsule_banks: bool = True) -> Dict[str, int]:
    """{name: axis} of the parameters of ``model`` that split over the
    mesh's model group (the others stay whole on every rank)."""
    if not shard_capsule_banks:
        return {}
    axes = {}
    for name, p in model.named_parameters():
        axis = bank_axis(name, p.shape, mesh.n_model)
        if axis is not None:
            axes[name] = axis
    return axes


def shard_tensor(t: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """This rank's share of a full tensor: the m-th of n_model equal parts
    along ``axis``, as a contiguous copy."""
    n = t.shape[axis] // mesh.n_model
    return t.narrow(axis, mesh.m * n, n).contiguous()


@torch.no_grad()
def gather_tensor(t: torch.Tensor, mesh: Mesh, axis: int) -> torch.Tensor:
    """The full tensor of which each model rank holds its share ``t`` along
    ``axis`` (every rank of the model group must call it)."""
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim=axis)
