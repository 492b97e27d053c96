"""The port's training harness pieces against scae_tpu's, on the CPU:

  * data (scae_tpu_torch/train/data.py, the numpy half): IDX files (plain
    and gzip), MNIST and npz discovery, synthetic digits, sklearn's digits,
    ``to_nchw_float``, ``Dataset.batches`` and ``load_datasets`` (synthetic
    and digits, with and without ``split_seed``) give arrays equal to JAX's
    (``np.array_equal``, dtypes too);
  * PNG and metrics (utils/png.py, train/metrics.py): ``write_png`` and
    ``make_grid`` give JAX's bytes; the JSONL and the grid files match
    scae_tpu's writer (tests/test_checkpoint_metrics.py's cases);
  * checkpoints (train/checkpoint.py): the cases of
    tests/test_checkpoint_metrics.py against the port's manager, Orbax's
    retention rules step by step against scae_tpu's manager on the same
    sequences of saves, and a bit-exact round trip of the model, the
    optimizer (Lookahead over RMSprop: moments, trace, counts and slow
    weights), the step and the seed.
"""

import gzip
import json
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from scae_tpu.train import data as j_data
from scae_tpu.train import metrics as j_metrics
from scae_tpu.utils import png as j_png
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.optim import make_optimizer
from scae_tpu_torch.parallel.train_step import TrainState, make_raw_train_step
from scae_tpu_torch.train import checkpoint as t_ckpt
from scae_tpu_torch.train import data as t_data
from scae_tpu_torch.train import metrics as t_metrics
from scae_tpu_torch.utils import png as t_png

torch.set_num_threads(1)


def assert_same_arrays(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def assert_same_datasets(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert_same_arrays(g.images, w.images)
        assert_same_arrays(g.labels, w.labels)
    assert got[3] == want[3]


# ------------------------------------------------------------------ data

def write_idx(path, array, compress=False):
    array = np.asarray(array, np.uint8)
    blob = struct.pack(">HBB", 0, 0x08, array.ndim) \
        + struct.pack(f">{array.ndim}I", *array.shape) + array.tobytes()
    with (gzip.open if compress else open)(path, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("compress", [False, True])
def test_read_idx_and_find_mnist_match_jax(tmp_path, compress):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (10, 28, 28), np.uint8)
    labels = np.arange(10, dtype=np.uint8)
    suffix = ".gz" if compress else ""
    for name, arr in (("train-images-idx3-ubyte", imgs),
                      ("train-labels-idx1-ubyte", labels),
                      ("t10k-images-idx3-ubyte", imgs[:4]),
                      ("t10k-labels-idx1-ubyte", labels[:4])):
        write_idx(str(tmp_path / (name + suffix)), arr, compress)
    path = str(tmp_path / ("train-images-idx3-ubyte" + suffix))
    assert_same_arrays(t_data._read_idx(path), j_data._read_idx(path))
    got, want = t_data.find_mnist(str(tmp_path)), j_data.find_mnist(
        str(tmp_path))
    assert sorted(got) == sorted(want)
    for k in want:
        assert_same_arrays(got[k], want[k])
    assert_same_datasets(
        t_data.load_datasets(str(tmp_path), val_size=3, source="mnist"),
        j_data.load_datasets(str(tmp_path), val_size=3, source="mnist"))


def test_find_npz_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    for split, n in (("train", 12), ("test", 5)):
        np.savez(tmp_path / f"{split}.npz",
                 images=rng.randint(0, 255, (n, 8, 8, 3), np.uint8),
                 labels=rng.randint(0, 10, n))
    got, want = t_data.find_npz(str(tmp_path)), j_data.find_npz(
        str(tmp_path))
    for k in want:
        assert_same_arrays(got[k], want[k])
    assert_same_datasets(
        t_data.load_datasets(str(tmp_path), val_size=4, n_channels=3),
        j_data.load_datasets(str(tmp_path), val_size=4, n_channels=3))


@pytest.mark.parametrize("n,seed,size,channels", [
    (50, 0, 28, 1), (37, 3, 40, 1), (20, 5, 32, 3), (600, 1, 28, 1)])
def test_synthetic_digits_match_jax(n, seed, size, channels):
    got = t_data.synthetic_digits(n, seed=seed, size=size,
                                  n_channels=channels)
    want = j_data.synthetic_digits(n, seed=seed, size=size,
                                   n_channels=channels)
    for g, w in zip(got, want):
        assert_same_arrays(g, w)


@pytest.mark.parametrize("split_seed", [None, 5])
def test_load_datasets_synthetic_matches_jax(tmp_path, split_seed):
    kw = dict(data_dir=str(tmp_path), val_size=40, synthetic_train=200,
              synthetic_test=30, seed=11, split_seed=split_seed,
              source="synthetic")
    got, want = t_data.load_datasets(**kw), j_data.load_datasets(**kw)
    assert got[3] == "synthetic" and len(got[0]) == 160
    assert_same_datasets(got, want)


@pytest.mark.parametrize("channels,tint,split_seed", [
    (1, None, None), (1, None, 3), (3, "class", None), (3, "example", 2)])
def test_load_datasets_digits_matches_jax(channels, tint, split_seed):
    pytest.importorskip("sklearn")
    kw = dict(val_size=200, seed=4, image_size=24, n_channels=channels,
              source="digits", tint=tint, split_seed=split_seed)
    assert_same_datasets(t_data.load_datasets(**kw),
                         j_data.load_datasets(**kw))


def test_to_nchw_and_batches_match_jax():
    rng = np.random.RandomState(2)
    for shape in ((5, 8, 8), (5, 8, 8, 3)):
        im = rng.randint(0, 255, shape).astype(np.uint8)
        assert_same_arrays(t_data.to_nchw_float(im), j_data.to_nchw_float(im))
    im, lb = j_data.synthetic_digits(50, seed=0)
    got = list(t_data.Dataset(im, lb).batches(16, seed=1))
    want = list(j_data.Dataset(im, lb).batches(16, seed=1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("image", "label"):
            assert_same_arrays(g[k], w[k])
    with pytest.raises(ValueError, match="unknown data source"):
        t_data.load_datasets(source="imagenet")


# ------------------------------------------------------------ png, metrics

@pytest.mark.parametrize("kind", ["gray float", "gray uint8", "rgb float",
                                  "gray (H, W, 1)"])
def test_write_png_bytes_match_jax(tmp_path, kind):
    rng = np.random.RandomState(3)
    img = {"gray float": rng.rand(16, 24),
           "gray uint8": rng.randint(0, 255, (9, 7)).astype(np.uint8),
           "rgb float": rng.rand(6, 5, 3) * 1.2 - 0.1,
           "gray (H, W, 1)": rng.rand(4, 4, 1)}[kind]
    t_png.write_png(str(tmp_path / "t.png"), img)
    j_png.write_png(str(tmp_path / "j.png"), img)
    blob = (tmp_path / "t.png").read_bytes()
    assert blob == (tmp_path / "j.png").read_bytes()
    assert blob[:8] == b"\x89PNG\r\n\x1a\n" and blob[12:16] == b"IHDR"
    w, h = struct.unpack(">II", blob[16:24])
    assert (h, w) == img.shape[:2]
    start = blob.index(b"IDAT") + 4
    length = struct.unpack(">I", blob[start - 8:start - 4])[0]
    channels = 3 if kind == "rgb float" else 1
    assert len(zlib.decompress(blob[start:start + length])) == \
        h * (w * channels + 1)


@pytest.mark.parametrize("n,c,n_cols,pad", [(5, 1, 3, 1), (8, 3, 8, 2),
                                            (1, 1, 4, 0)])
def test_make_grid_matches_jax(n, c, n_cols, pad):
    imgs = np.random.RandomState(4).rand(n, c, 4, 5).astype(np.float32)
    assert_same_arrays(t_png.make_grid(imgs, n_cols=n_cols, pad=pad),
                       j_png.make_grid(imgs, n_cols=n_cols, pad=pad))
    with pytest.raises(ValueError, match="unsupported image shape"):
        t_png.write_png("unused.png", np.zeros((2, 2, 2)))


def test_metrics_writer_jsonl_and_images_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")
    images = np.random.RandomState(5).rand(4, 1, 8, 8)
    for side, mod, loss in (("t", t_metrics, torch.tensor(1.5)),
                            ("j", j_metrics, np.float32(1.5))):
        w = mod.MetricsWriter(str(tmp_path / side))
        w.scalars(10, {"loss": loss, "acc": 0.25}, prefix="val_")
        w.images(10, "recons", images)
        w.close()
    recs = {}
    for side in ("t", "j"):
        with open(tmp_path / side / "metrics.jsonl") as f:
            rec = json.loads(f.readline())
        assert isinstance(rec.pop("time"), float)
        recs[side] = rec
    assert recs["t"] == recs["j"] == {"step": 10, "val_loss": 1.5,
                                      "val_acc": 0.25}
    name = "recons_step00000010.png"
    assert os.listdir(tmp_path / "t" / "images") == [name]
    assert (tmp_path / "t" / "images" / name).read_bytes() == \
        (tmp_path / "j" / "images" / name).read_bytes()


def test_reconstruction_grids_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SCAE_TPU_NO_TENSORBOARD", "1")
    rng = np.random.RandomState(6)
    viz = {"rec_mode": rng.rand(8, 1, 12, 12).astype(np.float32),
           "bottom_up_mode": rng.rand(8, 1, 12, 12).astype(np.float32),
           "top_down_mode": rng.rand(8, 1, 12, 12).astype(np.float32),
           "raw_templates": rng.rand(5, 1, 4, 4).astype(np.float32),
           "transformed_templates": rng.rand(6, 1, 12, 12).astype(
               np.float32)}
    images = rng.rand(8, 1, 12, 12).astype(np.float32)
    for side, mod, v in (("t", t_metrics,
                          {k: torch.from_numpy(a) for k, a in viz.items()}),
                         ("j", j_metrics, viz)):
        w = mod.MetricsWriter(str(tmp_path / side))
        mod.write_reconstruction_grids(w, 3, v, images, max_n=6)
        w.close()
    names = sorted(os.listdir(tmp_path / "j" / "images"))
    assert sorted(os.listdir(tmp_path / "t" / "images")) == names
    assert len(names) == 3
    for name in names:
        assert (tmp_path / "t" / "images" / name).read_bytes() == \
            (tmp_path / "j" / "images" / name).read_bytes()


def test_profiler_writes_a_chrome_trace(tmp_path):
    prof = t_metrics.Profiler(str(tmp_path), start_step=2, n_steps=1)
    assert not prof.maybe_start(1)
    assert prof.maybe_start(2)
    torch.ones(4).sum()
    prof.maybe_stop(2)            # steps [2, 3) are traced: still on
    assert prof.maybe_start(2)
    prof.maybe_stop(3)
    assert not prof.maybe_start(3)
    trace = tmp_path / "profile" / "trace_step2.json"
    assert trace.exists() and "traceEvents" in trace.read_text()


# ------------------------------------------------------------ checkpoint

SMALL = dict(image_shape=(1, 24, 24), n_classes=10, n_part_caps=8,
             n_obj_caps=4, pcae_cnn_encoder_params=dict(out_channels=[8] * 4),
             pcae_template_generator_params=dict(template_size=(5, 5)),
             ocae_encoder_set_transformer_params=dict(dim_hidden=8,
                                                      dim_out=16),
             ocae_decoder_capsule_params=dict(dim_caps=8, hidden_sizes=(16,)),
             scae_params=dict(reconstruct_alternatives=False))


def port_state(seed=0, lookahead=False, name="rmsprop"):
    model = make_scae(SMALL, device="cpu", seed=seed)
    opt = make_optimizer(model.parameters(), name, 1e-3, batch_size=4,
                         use_lookahead=lookahead, lookahead_k=2,
                         lr_decay_rate=0.5, decay_steps=2)
    return TrainState(model, opt, step=0, seed=seed)


def trained(state, steps=3):
    rng = np.random.RandomState(7)
    step = make_raw_train_step(state, device="cpu")
    for _ in range(steps):
        step(rng.randint(0, 256, (4, 24, 24)).astype(np.uint8),
             rng.randint(0, 10, (4,)))
    return state


def flat_optimizer_state(opt):
    out = []
    for name, v in sorted(opt.state_dict().items()):
        if isinstance(v, dict):
            out += [(f"base.{n}", x) for n, x in flat_optimizer_state(
                opt.base)]
        elif isinstance(v, list):
            out += [(f"{name}[{i}]", t) for i, t in enumerate(v)]
        else:
            out.append((name, v))
    return out


@pytest.mark.parametrize("name,lookahead", [("rmsprop", True),
                                            ("adam", False),
                                            ("radam", True)])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, name, lookahead):
    state = trained(port_state(seed=3, lookahead=lookahead, name=name))
    mgr = t_ckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.save(state.step, state, metrics={"loss": 5.0})
    fresh = port_state(seed=9, lookahead=lookahead, name=name)
    restored = mgr.restore(fresh)
    assert restored is fresh
    assert (restored.step, restored.seed) == (3, 3)
    for (n, a), b in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(a, b), n
    got = flat_optimizer_state(restored.optimizer)
    want = flat_optimizer_state(state.optimizer)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), n
    # the restored optimizer keeps updating the restored model's own
    # parameters: one more step on each side gives the same bits
    trained(state, 1)
    trained(restored, 1)
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_save_restore_roundtrip(tmp_path):
    state = port_state()
    mgr = t_ckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.save(1, state, metrics={"loss": 5.0})
    mgr.wait()
    assert mgr.latest_step == 1
    state.step += 1
    assert mgr.save(2, lambda: state, metrics={"loss": 3.0})
    assert mgr.best_step == 2
    assert not mgr.save(2, state, metrics={"loss": 1.0})   # not after 2
    restored = mgr.restore(port_state(seed=1))
    assert restored.step == 1
    a = next(state.model.parameters())
    b = next(restored.model.parameters())
    assert torch.equal(a, b)
    assert mgr.metrics(2) == {"loss": 3.0}
    mgr.close()


def test_restore_params_without_template(tmp_path):
    state = port_state()
    mgr = t_ckpt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state, metrics={"loss": 1.0})
    params = mgr.restore_params()
    want = state.model.state_dict()
    assert sorted(params) == sorted(want)
    for k in want:
        assert torch.equal(params[k], want[k]), k


def jax_state():
    from scae_tpu.optim import make_optimizer as j_make_optimizer
    from scae_tpu.parallel.train_step import create_train_state
    from tests.test_parallel import tiny_model

    batch = {"image": np.zeros((4, 1, 24, 24), np.float32),
             "label": np.zeros((4,), np.int32)}
    return jax.device_get(create_train_state(
        tiny_model(), j_make_optimizer("adam", 1e-4, batch_size=4), batch,
        jax.random.PRNGKey(0)))


RETENTION = {
    "top-2 by loss": (dict(max_to_keep=2),
                      [(1, {"loss": 5.0}), (2, {"loss": 1.0}),
                       (3, {"loss": 4.0}), (4, {"loss": 0.5})]),
    "val_accuracy, max": (dict(max_to_keep=2, monitor="val_accuracy",
                               mode="max"),
                          [(1, {"val_accuracy": 0.2}),
                           (2, {"val_accuracy": 0.85}),
                           (3, {"val_accuracy": 0.7}),
                           (4, {"val_accuracy": 0.4})]),
    "ties and a worse newest": (dict(max_to_keep=2, monitor="val_loss"),
                                [(1, {"val_loss": 2.0}),
                                 (2, {"val_loss": 2.0}),
                                 (5, {"val_loss": 2.0}),
                                 (6, {"val_loss": 9.0})]),
    "a missing monitor ranks worst": (dict(max_to_keep=2,
                                           monitor="val_loss"),
                                      [(1, {"other": 1.0}),
                                       (2, {"val_loss": 3.0}),
                                       (3, {}), (4, {"val_loss": 4.0})]),
}


@pytest.mark.parametrize("case", sorted(RETENTION))
def test_retention_matches_scae_tpu_step_by_step(tmp_path, case):
    from scae_tpu.train.checkpoint import CheckpointManager as JManager

    kw, saves = RETENTION[case]
    j_mgr = JManager(str(tmp_path / "j"), **kw)
    t_mgr = t_ckpt.CheckpointManager(str(tmp_path / "t"), **kw)
    j_state, t_state = jax_state(), port_state()
    try:
        for step, metrics in saves:
            assert t_mgr.save(step, t_state, metrics) == \
                j_mgr.save(step, j_state, metrics)
            j_mgr.wait()
            assert t_mgr.latest_step == j_mgr.latest_step, step
            assert t_mgr.best_step == j_mgr.best_step, step
            assert sorted(t_mgr._metrics) == sorted(j_mgr._mgr.all_steps())
            assert sorted(n for n in os.listdir(tmp_path / "t")
                          if n.isdigit()) == sorted(
                str(s) for s in j_mgr._mgr.all_steps())
    finally:
        j_mgr.close()


def test_checkpoint_monitor_reads_legacy_loss_key(tmp_path):
    state = port_state()
    mgr = t_ckpt.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                                   monitor="loss")
    mgr.save(1, state, metrics={"loss": 5.0})
    mgr.close()
    reopened = t_ckpt.CheckpointManager(str(tmp_path / "ckpt"),
                                        max_to_keep=2, monitor="val_loss")
    assert reopened.latest_step == 1 and reopened.metrics(1) == {"loss": 5.0}
    reopened.save(2, state, metrics={"val_loss": 3.0})
    assert reopened.best_step == 2
    reopened.save(3, state, metrics={"val_loss": 6.0})
    assert reopened.best_step == 2
    assert sorted(reopened._metrics) == [1, 2]


def test_null_manager_keeps_the_directory_and_saves_nothing(tmp_path):
    mgr = t_ckpt.NullCheckpointManager(str(tmp_path / "none"))
    assert os.path.isdir(tmp_path / "none")
    called = []
    assert mgr.save(1, lambda: called.append(1)) is False
    assert not called
    assert mgr.latest_step is None and mgr.best_step is None
    with pytest.raises(AssertionError, match="disabled"):
        mgr.restore(port_state())
    with pytest.raises(ValueError, match="mode"):
        t_ckpt.CheckpointManager(str(tmp_path / "x"), mode="median")
