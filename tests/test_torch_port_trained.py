"""The torch reference's trained checkpoint (logs/r4_ref_trained/last.pt,
made by tools/ab_ref_train.py) in the port:

  * ``scae_tpu_torch/utils/torch_port.py::port_scae`` equals
    ``from_flax(scae_tpu.utils.torch_port.port_scae(sd))`` bit for bit, and
    the port's model loads it strictly;
  * ``scae_tpu_torch/tools/port_trained.py`` evaluates it: on its first
    batch of 128 validation digits every metric within 1e-5 (relative and
    absolute, tests/test_torch_slice.py's tolerance) of scae_tpu's model
    evaluated on ``scae_tpu.utils.torch_port.port_scae`` of the same
    weights, with the same config (the reference's mnist.yaml in f32, the
    compat flags, noise off);
  * the tool's entry point prints its metric lines.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu.factory import make_scae as j_make_scae
from scae_tpu.utils import torch_port as j_torch_port
from scae_tpu_torch.factory import make_scae
from scae_tpu_torch.tools import port_trained
from scae_tpu_torch.utils import torch_port
from scae_tpu_torch.utils.from_flax import flax_to_state_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "logs", "r4_ref_trained", "last.pt")
TOL = 1e-5


@pytest.fixture(scope="module")
def state_dict():
    return torch.load(CKPT, map_location="cpu", weights_only=True)


def test_converter_equals_the_jax_path(state_dict):
    got = torch_port.port_scae(state_dict, 32)
    want = flax_to_state_dict(j_torch_port.port_scae(
        {k: v.numpy() for k, v in state_dict.items()}, n_obj_caps=32))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    model = make_scae(port_trained.model_config(), device="cpu")
    model.load_state_dict(got, strict=True)


def test_port_trained_metrics_match_jax(state_dict):
    mk = port_trained.model_config()
    model = make_scae(mk, device="cpu")
    model.load_state_dict(torch_port.port_scae(state_dict, 32))
    images, labels = port_trained.eval_batch("digits")
    assert images.shape == (256, 1, 40, 40)
    images, labels = images[:128], labels[:128]
    got = port_trained.evaluate(model, images, labels)

    jm = j_make_scae(mk)
    params = j_torch_port.port_scae(
        {k: v.numpy() for k, v in state_dict.items()}, n_obj_caps=32)

    @jax.jit
    def ev(params, img, lbl):
        res = jm.apply({"params": params}, img, deterministic=True)
        _, log = jm.loss(res, img, lbl)
        return dict(log, accuracy=jm.calculate_accuracy(res, lbl))

    want = ev(params, jnp.asarray(images.numpy()),
              jnp.asarray(labels.numpy().astype(np.int32)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def test_port_trained_entry_point(capsys, monkeypatch):
    monkeypatch.setattr(port_trained, "eval_batch",
                        lambda source: tuple(t[:128] for t in
                                             EVAL_BATCH(source)))
    got = port_trained.main(["--ckpt", CKPT, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[port_trained] scae_tpu_torch ported eval:" in out
    assert f"[port_trained] {'rec_ll_loss':40s} port=" in out
    assert "logged=" in out and "accuracy" in got


EVAL_BATCH = port_trained.eval_batch
