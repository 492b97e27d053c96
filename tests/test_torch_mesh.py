"""The port's mesh (scae_tpu_torch/parallel/mesh.py and the ``mesh=`` of
parallel/train_step.py) against scae_tpu's, on the CPU:

  * ``maybe_initialize_distributed`` against torchrun's variables, with
    ``init_process_group`` stubbed: the cases of
    tests/test_mesh_distributed.py (no variables, variables parsed, an
    address without the counts, idempotent, a group formed by the caller);
  * ``make_mesh``'s row-major layout (rank = d * n_model + m) and its
    groups, its errors, the rows of a (K, B) index chunk, and the capsule
    banks' axes (split only where n_model divides them), as
    tests/test_parallel.py holds JAX's;
  * against JAX: the same flax parameters and batch, the between-example
    sparsity weights on (0.35 and 0.2, mnist.yaml's); JAX on the
    8-device CPU mesh of tests/conftest.py laid out 4x2 with its banks
    split, ``make_eval_step(model, mesh)`` and ``jax.value_and_grad`` of
    ``loss_fn`` (deterministic); the port on 2x1, 1x2 and 2x2 meshes of
    gloo processes (this file's ``__main__`` is the rank worker): every
    eval term within 1e-5 relative (tests/test_parallel.py's tolerance for
    the loss) and every gradient, the split banks' gathered, within 1e-4 of
    its largest entry and 1e-6 absolute (tests/test_torch_train.py's f32
    tolerance), on every rank;
  * without a process group, a mesh calls no collective: the steps, the
    scans and a CLI run on a mesh that spans no group call no function of
    ``torch.distributed``, and compute what they compute without a mesh.

  * the host-side helpers of the mesh's last features: ``agree`` (the
    seed probe's winner), ``from_process_zero`` (the head refit's fit) and
    ``gather_rows`` (a mesh artifact's outputs), without a group and on
    two gloo processes.

Each multi-process case runs its ranks under a timeout of its own, beside
the group's (``parallel.mesh.TIMEOUT_S``), and kills them when one fails.
"""

import datetime
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scae_tpu_torch.factory import make_scae as t_make_scae  # noqa: E402
from scae_tpu_torch.optim import make_optimizer  # noqa: E402
from scae_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from scae_tpu_torch.parallel import train_step as ts  # noqa: E402

torch.set_num_threads(1)
B = 8
LR = 3e-5
RANKS_TIMEOUT = 120      # seconds for one multi-process case
MODEL = dict(
    image_shape=(1, 24, 24), n_classes=10, n_part_caps=8, n_obj_caps=4,
    pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
    pcae_template_generator_params=dict(template_size=(5, 5)),
    ocae_encoder_set_transformer_params=dict(dim_hidden=8, dim_out=16),
    ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)),
    scae_params=dict(reconstruct_alternatives=False,
                     prior_between_example_sparsity_weight=0.35,
                     posterior_between_example_sparsity_weight=0.2))
BANKS = {f"obj_decoder.capsule_layer.{n}": axis for n, axis in (
    ("mlps.kernel_0", 0), ("mlps.bias_0", 0), ("mlps.kernel_1", 0),
    ("mlps.bias_1", 0), ("caps_mlps.kernel_0", 0), ("caps_mlps.kernel_1", 0),
    ("cpr_static", 1), ("caps_bias_0", 1), ("caps_bias_1", 1),
    ("caps_bias_2", 1), ("caps_bias_3", 1))}


def batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 1, 24, 24).astype(np.float32),
            rng.randint(0, 10, (B,)).astype(np.int64))


def rank_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                SCAE_TPU_NO_TENSORBOARD="1")


# ------------------------------------------- maybe_initialize_distributed

@pytest.fixture
def launch(monkeypatch):
    """No launcher variables, and a stubbed ``init_process_group`` that
    records its arguments and forms a stand-in group."""
    for var in (*mesh_lib.LAUNCH_VARS, "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    calls, formed = [], []

    def init_process_group(**kwargs):
        calls.append(kwargs)
        formed.append(True)

    monkeypatch.setattr(mesh_lib.dist, "init_process_group",
                        init_process_group)
    monkeypatch.setattr(mesh_lib.dist, "is_initialized", lambda: bool(formed))
    return calls, formed


def set_launch_vars(monkeypatch, rank=2, world=4, local=1):
    monkeypatch.setenv("RANK", str(rank))
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    monkeypatch.setenv("LOCAL_RANK", str(local))


def test_no_launch_no_group(launch):
    calls, _ = launch
    assert mesh_lib.maybe_initialize_distributed() is False
    assert calls == []


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_launch_vars_parsed(launch, monkeypatch, backend):
    calls, _ = launch
    devices = []
    monkeypatch.setattr(torch.cuda, "set_device", devices.append)
    set_launch_vars(monkeypatch)
    assert mesh_lib.maybe_initialize_distributed(backend) is True
    assert calls == [dict(backend=backend, init_method="env://", rank=2,
                          world_size=4,
                          timeout=datetime.timedelta(seconds=60))]
    # NCCL takes the card LOCAL_RANK names; gloo leaves the device alone
    assert devices == ([1] if backend == "nccl" else [])


def test_launch_default_backend_is_gloo_without_cuda(launch, monkeypatch):
    calls, _ = launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    set_launch_vars(monkeypatch)
    assert mesh_lib.maybe_initialize_distributed() is True
    assert calls[0]["backend"] == "gloo"


def test_launch_without_counts_raises(launch, monkeypatch):
    calls, _ = launch
    monkeypatch.setenv("MASTER_ADDR", "host")
    monkeypatch.setenv("MASTER_PORT", "99")
    with pytest.raises(ValueError, match=r"\['RANK', 'WORLD_SIZE'\]"):
        mesh_lib.maybe_initialize_distributed()
    assert calls == []


def test_idempotent(launch, monkeypatch):
    calls, _ = launch
    set_launch_vars(monkeypatch)
    assert mesh_lib.maybe_initialize_distributed("gloo") is True
    assert mesh_lib.maybe_initialize_distributed("gloo") is True
    assert len(calls) == 1


def test_a_group_formed_by_the_caller_is_kept(launch, monkeypatch):
    calls, formed = launch
    formed.append(True)
    set_launch_vars(monkeypatch)
    assert mesh_lib.maybe_initialize_distributed() is True
    assert calls == []


# ------------------------------------------------------- layout and rows

def test_mesh_shape_and_its_errors():
    assert mesh_lib.mesh_shape(4) == (4, 1)
    assert mesh_lib.mesh_shape(4, None, 2) == (2, 2)
    assert mesh_lib.mesh_shape(4, 2, 2) == (2, 2)
    assert mesh_lib.mesh_shape(1) == (1, 1)
    for args in ((4, 3, 1), (2, None, 3), (4, 2, 1), (4, None, 0)):
        with pytest.raises(ValueError):
            mesh_lib.mesh_shape(*args)


def test_make_mesh_without_a_group():
    mesh = mesh_lib.make_mesh()
    assert (mesh.n_data, mesh.n_model, mesh.d, mesh.m) == (1, 1, 0, 0)
    assert not mesh.distributed and mesh_lib.live(mesh) is None
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        mesh_lib.make_mesh(n_data=2)


@pytest.mark.parametrize("rank", range(4))
def test_make_mesh_lays_ranks_out_row_major(monkeypatch, rank):
    """2x2 over a stand-in group of 4: rank = d * n_model + m; the data
    group is the rank's column, the model group its row, and every rank
    asks for every group in the same order."""
    made = []
    monkeypatch.setattr(mesh_lib.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_lib.dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(mesh_lib.dist, "get_rank", lambda: rank)
    monkeypatch.setattr(mesh_lib.dist, "get_backend", lambda: "gloo")
    monkeypatch.setattr(mesh_lib.dist, "new_group",
                        lambda ranks: made.append(tuple(ranks)) or
                        tuple(ranks))
    mesh = mesh_lib.make_mesh(n_model=2)
    d, m = divmod(rank, 2)
    assert (mesh.n_data, mesh.n_model, mesh.d, mesh.m) == (2, 2, d, m)
    assert mesh.data_group == (m, 2 + m)
    assert mesh.model_group == (2 * d, 2 * d + 1)
    assert made == [(0, 2), (1, 3), (0, 1), (2, 3)]
    assert mesh.backend == "gloo" and mesh.distributed
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4


@pytest.mark.parametrize("d", range(2))
def test_a_chunk_gives_each_data_rank_its_columns(d):
    idxs = np.arange(24).reshape(3, 8)
    for m in range(2):
        mesh = mesh_lib.Mesh(2, 2, d, m)
        want = idxs[:, 4 * d:4 * d + 4]
        np.testing.assert_array_equal(
            mesh_lib.local_rows(idxs, dim=1, mesh=mesh), want)
        assert torch.equal(mesh_lib.local_rows(torch.from_numpy(idxs),
                                               dim=1, mesh=mesh),
                           torch.from_numpy(want))
    assert mesh_lib.local_rows(idxs, dim=1) is idxs   # no active mesh
    with pytest.raises(ValueError, match="global batch of 7"):
        mesh_lib.local_rows(np.zeros((2, 7)), dim=1,
                            mesh=mesh_lib.Mesh(2, 1, d))


def test_capsule_banks_split_only_where_n_model_divides():
    model = t_make_scae(MODEL, device="cpu")
    assert mesh_lib.param_shardings(mesh_lib.Mesh(2, 2), model) == BANKS
    assert mesh_lib.param_shardings(mesh_lib.Mesh(4, 1), model) == {}
    # O = 4: three model ranks do not divide the banks, which stay whole
    assert mesh_lib.param_shardings(mesh_lib.Mesh(1, 3), model) == {}
    assert mesh_lib.param_shardings(mesh_lib.Mesh(1, 2), model,
                                    shard_capsule_banks=False) == {}
    state = ts.TrainState(model, make_optimizer(model.parameters(),
                                                "rmsprop", LR, B))
    full = {k: v.clone() for k, v in model.state_dict().items()}
    ts.shard_state(state, mesh_lib.Mesh(1, 2, 0, 1))
    assert state.banks == BANKS
    for name, p in model.named_parameters():
        if name in BANKS:
            want = full[name].narrow(BANKS[name], 2, 2)
        else:
            want = full[name]
        assert torch.equal(p.detach(), want), name
    # the optimizer's state follows its parameters
    assert [tuple(t.shape) for t in state.optimizer.nu] == [
        tuple(p.shape) for p in model.parameters()]
    with pytest.raises(ValueError, match="split already"):
        ts.shard_state(state, mesh_lib.Mesh(1, 2, 0, 1))
    # a layer split over a model group runs only under its mesh
    images, _ = batch()
    with pytest.raises(RuntimeError, match="2 of 4 capsules"):
        model(torch.from_numpy(images))


# ----------------------------------------------------- no group, no call

def test_no_group_calls_no_collective(monkeypatch, tmp_path):
    """The single-process path under a mesh that spans no group, and
    under none: no function of torch.distributed that talks to other
    processes is called, and both compute the same numbers."""
    called = []
    for name in ("all_reduce", "all_gather", "barrier", "broadcast",
                 "new_group", "reduce_scatter_tensor",
                 "all_gather_into_tensor", "init_process_group", "get_rank",
                 "get_world_size"):
        monkeypatch.setattr(mesh_lib.dist, name,
                            lambda *a, _n=name, **k: called.append(_n))
    mesh = mesh_lib.make_mesh()
    from scae_tpu_torch.train import loop

    images, labels = batch()
    data = {"image": torch.from_numpy((images[:, 0] * 255).astype(np.uint8)),
            "label": torch.from_numpy(labels)}
    idxs = np.arange(8).reshape(1, 8)
    augment = loop.make_augment_fn(24, 2)
    results = []
    for m in (None, mesh):
        model = t_make_scae(dict(MODEL, pcae_encoder_params=dict(
            noise_scale=4.0)), device="cpu", seed=3)
        state = ts.TrainState(model, make_optimizer(model.parameters(),
                                                    "rmsprop", LR, B))
        out = [ts.loss_and_grads(model, images, labels, device="cpu",
                                 mesh=m)[0]["loss"],
               ts.make_raw_eval_step(model, device="cpu", mesh=m)(
                   images, labels)["loss"],
               ts.make_fused_eval_step(model, device="cpu", mesh=m)(
                   data, idxs[0])["loss"],
               ts.make_eval_scan(model, device="cpu", mesh=m)(
                   data, idxs)["loss"][0],
               ts.make_raw_train_step(state, augment, device="cpu", mesh=m)(
                   images, labels)["loss"],
               ts.make_fused_train_step(state, augment, device="cpu",
                                        mesh=m)(data, idxs[0])["loss"],
               ts.make_train_scan(augment, device="cpu", mesh=m)(
                   state, data, idxs)[1]["loss"][0]]
        results.append(torch.stack(out))
    assert torch.equal(results[0], results[1])
    from scae_tpu_torch.train import cli

    cli.main(["data_loader.batch_size=8", "data_loader.source=synthetic",
              "data_loader.synthetic_train=24", "data_loader.val_size=8",
              "data_loader.synthetic_test=8", "trainer.max_epochs=1",
              "trainer.log_every_steps=1", "trainer.max_eval_batches=1",
              "trainer.augment.canvas=24", "model.image_shape=[1,24,24]",
              "model.n_part_caps=4", "model.n_obj_caps=4",
              "model.pcae_cnn_encoder_params.out_channels=[8,8,8,8]",
              "model.pcae_template_generator_params.template_size=[5,5]",
              "model.ocae_encoder_set_transformer_params.dim_hidden=8",
              "model.ocae_encoder_set_transformer_params.dim_out=8",
              "model.ocae_decoder_capsule_params.dim_caps=8",
              "model.ocae_decoder_capsule_params.hidden_sizes=[8]",
              f"trainer.checkpoint_dir={tmp_path}/ckpt",
              f"trainer.log_dir={tmp_path}/logs"], device="cpu")
    assert called == []


# ------------------------------------------------------------ against JAX

@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX's eval metrics and gradients on its 8-device CPU mesh (4x2, the
    banks split over "model"), and the inputs the ranks read."""
    import jax
    import jax.numpy as jnp

    from scae_tpu.factory import make_scae as j_make_scae
    from scae_tpu.parallel import mesh as j_mesh
    from scae_tpu.parallel import train_step as j_ts
    from scae_tpu_torch.utils.from_flax import flax_to_state_dict

    jm = j_make_scae(MODEL)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        jnp.zeros((2, 1, 24, 24)), deterministic=False))()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    images, labels = batch()
    mesh = j_mesh.make_mesh(n_data=4, n_model=2)
    placed = jax.device_put(params, j_mesh.param_shardings(mesh, params))
    bank = placed["obj_decoder"]["capsule_layer"]["mlps"]["kernel_0"]
    assert len(bank.sharding.device_set) == 8
    jbatch = jax.device_put(
        {"image": jnp.asarray(images),
         "label": jnp.asarray(labels, jnp.int32)},
        j_mesh.batch_sharding(mesh))
    with mesh:
        metrics = j_ts.make_eval_step(jm, mesh)(placed, jbatch)
        grads = jax.jit(jax.grad(lambda p, b: j_ts.loss_fn(
            jm, p, b, None, deterministic=True)[0]))(placed, jbatch)
    metrics = {k: float(v) for k, v in metrics.items()}
    assert metrics["prior_between_sparsity_loss"] > 0
    grads = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.device_get(grads)))
    out = tmp_path_factory.mktemp("mesh_vs_jax")
    torch.save({"state_dict": flax_to_state_dict(params),
                "images": torch.from_numpy(images),
                "labels": torch.from_numpy(labels)}, out / "inputs.pt")
    return out, metrics, grads


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2), (2, 2)])
def test_mesh_matches_jax(jax_reference, n_data, n_model):
    out, want, want_grads = jax_reference
    world = n_data * n_model
    mesh_lib.run_local([sys.executable, __file__, "vs_jax", str(out),
                        str(n_data), str(n_model)], world, RANKS_TIMEOUT,
                       env=rank_env())
    for rank in range(world):
        got = torch.load(out / f"{n_data}x{n_model}_rank{rank}.pt")
        assert got["banks"] == (BANKS if n_model > 1 else {})
        assert set(got["metrics"]) == set(want)
        for k in want:
            np.testing.assert_allclose(got["metrics"][k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{k} rank {rank}")
        assert set(got["grads"]) == set(want_grads)
        for name, ref in want_grads.items():
            ref = ref.numpy()
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(
                got["grads"][name].numpy(), ref, rtol=0,
                atol=1e-4 * scale + 1e-6, err_msg=f"{name} rank {rank}")


def vs_jax_rank(out, n_data, n_model):
    """A rank of ``test_mesh_matches_jax``: the eval step and the
    gradients on the mesh, the split banks' gathered, written to
    ``out/<mesh>_rank<r>.pt``."""
    import torch.distributed as dist

    assert mesh_lib.maybe_initialize_distributed()
    mesh = mesh_lib.make_mesh(n_data, n_model)
    inputs = torch.load(os.path.join(out, "inputs.pt"))
    model = t_make_scae(MODEL, device="cpu")
    model.load_state_dict(inputs["state_dict"])
    state = ts.TrainState(model, make_optimizer(model.parameters(),
                                                "rmsprop", LR, B))
    ts.shard_state(state, mesh)
    images, labels = inputs["images"], inputs["labels"]
    metrics = ts.make_raw_eval_step(model, device="cpu", mesh=mesh)(
        images, labels)
    _, grads = ts.loss_and_grads(model, images, labels, device="cpu",
                                 mesh=mesh)
    names = [n for n, _ in model.named_parameters()]
    grads = {n: mesh_lib.gather_tensor(g, mesh, state.banks[n])
             if n in state.banks else g for n, g in zip(names, grads)}
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": grads, "banks": state.banks},
               os.path.join(out, f"{n_data}x{n_model}_rank"
                                 f"{dist.get_rank()}.pt"))
    dist.destroy_process_group()


# ------------------------------------------------ the host-side helpers

def test_helpers_without_a_group():
    assert mesh_lib.agree(3, "a count") == 3
    assert mesh_lib.from_process_zero(lambda: "done") == "done"
    x = torch.arange(6.0)
    assert mesh_lib.gather_rows(x, mesh_lib.Mesh(1, 1)) is x


def test_agree_from_process_zero_and_gather_rows_on_two_ranks(tmp_path):
    """``agree`` returns a value the ranks share and raises, naming what,
    where they differ; ``from_process_zero`` runs its function on process 0
    alone and hands every rank its result, or raises on every rank what it
    raised; ``gather_rows`` puts the data ranks' rows back in rank order
    (the counterpart of ``local_rows``)."""
    mesh_lib.run_local([sys.executable, __file__, "helpers", str(tmp_path)],
                       2, RANKS_TIMEOUT, env=rank_env())
    for rank in range(2):
        got = torch.load(tmp_path / f"helpers_{rank}.pt")
        assert got["agreed"] == 7
        assert got["disagreed"] == ("the processes disagree on the rank: "
                                    "[0, 1] (by rank)")
        assert got["ran_on"] == [0]
        assert got["result"] == {"rank": 0, "value": 5}
        assert got["raised"] == (
            "ValueError: boom" if rank == 0
            else "RuntimeError: process 0 failed: ValueError: boom")
        assert torch.equal(got["gathered"], torch.arange(24.0).reshape(8, 3))


def helpers_rank(out):
    """A rank of ``test_agree_from_process_zero_and_gather_rows_on_two_ranks``:
    what each helper gave it, saved to ``out``."""
    import torch.distributed as dist

    assert mesh_lib.maybe_initialize_distributed("gloo")
    rank = dist.get_rank()
    got = {"agreed": mesh_lib.agree(7, "a constant")}
    try:
        mesh_lib.agree(rank, "the rank")
    except RuntimeError as error:
        got["disagreed"] = str(error)
    ran_on = []

    def work():
        ran_on.append(rank)
        return {"rank": rank, "value": 5}

    got["result"] = mesh_lib.from_process_zero(work)
    every = [None, None]
    dist.all_gather_object(every, ran_on)
    got["ran_on"] = sorted(r for ranks in every for r in ranks)

    def fail():
        raise ValueError("boom")

    try:
        mesh_lib.from_process_zero(fail)
    except (ValueError, RuntimeError) as error:
        got["raised"] = f"{type(error).__name__}: {error}"
    mesh = mesh_lib.make_mesh(n_data=2)
    full = torch.arange(24.0).reshape(8, 3)
    got["gathered"] = mesh_lib.gather_rows(
        mesh_lib.local_rows(full, mesh=mesh), mesh)
    torch.save(got, os.path.join(out, f"helpers_{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "vs_jax":
        vs_jax_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1] == "helpers":
        helpers_rank(sys.argv[2])
