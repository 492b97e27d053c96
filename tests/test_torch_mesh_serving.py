"""The port's serving export on a mesh of gloo processes
(``serve.export_serving(mesh=...)``, ``load_serving`` and ``ServingModel``
on a mesh) against the one-process artifact and against JAX, on the CPU,
as tests/test_serve.py holds scae_tpu's data-sharded export:

  * on 2x1 and 1x2 meshes of two processes (this file's ``__main__`` is
    the rank worker, launched as tests/test_torch_mesh.py launches its),
    the mesh artifact of global batch 16, exported by both processes and
    written by process 0, loaded back by both and called with the global
    batch on each: every rank returns the global batch's outputs, whose
    predictions equal the one-process artifact's at batch 16 and whose
    other outputs lie within 1e-5 of it; and within
    test_torch_serve.py's tolerance of JAX's ``make_infer_fn`` on the same
    weights (carried over by ``utils/from_flax.py`` from JAX's seeded
    init);
  * the manifest records ``batch_axis``, the mesh's shape, ``nr_devices``
    and the global batch; the exported program takes the rank's rows;
  * ``load_serving`` refuses the 2-process artifact with no process group
    and under a group of one process, by name; a batch the data ranks do
    not divide is refused on the mesh.
"""

import datetime
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from sample_hparams import small_model_params  # noqa: E402

from scae_tpu_torch import serve as t_serve  # noqa: E402
from scae_tpu_torch.factory import make_scae as t_make_scae  # noqa: E402
from scae_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

torch.set_num_threads(1)
B = 16
TOL = 1e-5              # the mesh artifact against the one-process one
JAX_TOL = 1e-5          # test_torch_serve.py's TOL, the port against JAX
RANKS_TIMEOUT = 180
MK = small_model_params(pcae_decoder_params=dict(fused_impl="xla"))
LAYOUTS = {"2x1": (2, 1), "1x2": (1, 2)}


def rank_env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def images():
    return np.random.RandomState(11).rand(B, 1, 28, 28).astype(np.float32)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX's seeded init and its outputs, the port's one-process artifact
    on the same weights, and each mesh's artifact and every rank's
    outputs."""
    import jax
    import jax.numpy as jnp

    from scae_tpu import serve as j_serve
    from scae_tpu.factory import make_scae as j_make_scae
    from scae_tpu_torch.utils.from_flax import load_flax_params

    out = tmp_path_factory.mktemp("mesh_serving")
    jm = j_make_scae(MK)
    params = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(3)},
        image=jnp.zeros((B, 1, 28, 28), jnp.float32),
        deterministic=True))()["params"]
    x = images()
    want_jax = {k: np.asarray(v) for k, v in jax.jit(
        j_serve.make_infer_fn(jm))(params, jnp.asarray(x)).items()}
    model = t_make_scae(MK, device="cpu")
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    torch.save(model.state_dict(), out / "weights.pt")
    np.save(out / "x.npy", x)
    t_serve.export_serving(model, image_shape=MK["image_shape"],
                           batch_size=B, out_dir=str(out / "single"),
                           device="cpu", model_config=MK)
    single = {k: v.numpy() for k, v in
              t_serve.load_serving(str(out / "single"))(x).items()}
    mesh_lib.run_local([sys.executable, __file__, str(out)], 2,
                       RANKS_TIMEOUT, env=rank_env())
    ranks = {tag: [torch.load(out / f"got_{tag}_{r}.pt") for r in range(2)]
             for tag in LAYOUTS}
    return {"out": out, "jax": want_jax, "single": single, "ranks": ranks}


def check(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.endswith("prediction"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("tag", sorted(LAYOUTS))
def test_mesh_artifact_matches_one_process_and_jax(served, tag):
    for rank, got in enumerate(served["ranks"][tag]):
        assert got["outputs"]["prediction"].shape == (B,)
        check({k: v.numpy() for k, v in got["outputs"].items()},
              served["single"], TOL)
        check({k: v.numpy() for k, v in got["outputs"].items()},
              served["jax"], JAX_TOL)
        # the process group's collectives made every rank's the global
        # batch's outputs, and the program took the rank's rows
        assert got["program_rows"] == B // LAYOUTS[tag][0], rank


@pytest.mark.parametrize("tag", sorted(LAYOUTS))
def test_mesh_manifest(served, tag):
    n_data, n_model = LAYOUTS[tag]
    with open(served["out"] / tag / t_serve.MANIFEST_NAME) as f:
        m = json.load(f)
    assert m["batch_axis"] == "data" and m["nr_devices"] == 2
    assert m["mesh"] == {"n_data": n_data, "n_model": n_model}
    assert m["input"]["shape"] == [B, 1, 28, 28]
    assert m["polymorphic_batch"] is False
    with open(served["out"] / "single" / t_serve.MANIFEST_NAME) as f:
        single = json.load(f)
    assert single["batch_axis"] is None and "nr_devices" not in single
    drop = ("batch_axis", "nr_devices", "mesh")
    assert {k: v for k, v in m.items() if k not in drop} == {
        k: v for k, v in single.items() if k not in drop}
    for got in served["ranks"][tag]:
        assert got["refused"] == ("does not split over the mesh's 2 data "
                                  "ranks" if n_data == 2 else None)


def test_load_serving_refuses_another_world_size(served):
    path = str(served["out"] / "2x1")
    with pytest.raises(ValueError, match="nr_devices=2 processes; load it "
                                         "under a process group"):
        t_serve.load_serving(path)
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="nr_devices=2 processes; this "
                                             "process group has 1"):
            t_serve.load_serving(path)
    finally:
        dist.destroy_process_group()


def mesh_serving_rank(out):
    """A rank of the ``served`` fixture, for each layout in turn: export
    the mesh artifact with the fixture's weights, load it, call it with the
    global batch, and save what it returned."""
    import torch.distributed as dist

    assert mesh_lib.maybe_initialize_distributed("gloo")
    model = t_make_scae(MK, device="cpu")
    model.load_state_dict(torch.load(os.path.join(out, "weights.pt")))
    x = np.load(os.path.join(out, "x.npy"))
    for tag, (n_data, n_model) in LAYOUTS.items():
        mesh = mesh_lib.make_mesh(n_data=n_data, n_model=n_model)
        path = os.path.join(out, tag)
        refused = None
        if n_data > 1:
            try:
                t_serve.export_serving(model, image_shape=MK["image_shape"],
                                       batch_size=B + 1, out_dir=path,
                                       device="cpu", mesh=mesh)
            except ValueError as error:
                refused = str(error).split(f"{B + 1} ")[-1]
            assert not os.path.exists(path)
        t_serve.export_serving(model, image_shape=MK["image_shape"],
                               batch_size=B, out_dir=path, device="cpu",
                               mesh=mesh, model_config=MK)
        loaded = t_serve.load_serving(path)
        program_rows = [n.meta["val"].shape[0] for n in
                        loaded.program.graph.nodes
                        if n.op == "placeholder" and n.name == "image"][0]
        torch.save({"outputs": loaded(x), "refused": refused,
                    "program_rows": program_rows},
                   os.path.join(out, f"got_{tag}_{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    mesh_serving_rank(sys.argv[1])
