"""The port's small remainders against scae_tpu's, on the CPU:

  * ``ops/pooling.py``'s ``soft_attention``, ``attention_pooling_2d_explicit``
    and ``attention_pooling_2d`` against the JAX functions on the same numpy
    inputs, within 1e-6 absolute and relative (one softmax and one sum over
    at most 49 pixels in float32);
  * ``CapsuleLayer``'s ``parent_transform`` and ``parent_presence`` hooks,
    each alone and both together, every field of the result against the
    JAX layer on the same parameters (carried over by ``from_flax.py``)
    within 1e-6; with no hook, the hooks change nothing;
  * ``config.save_config``: what it writes reads back with both packages'
    ``load_config`` (the port's reader and PyYAML) as the config written,
    and what ``scae_tpu.config.save_config`` writes reads back with the
    port's, for the shipped configs and a config of every scalar kind.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scae_tpu import config as j_config
from scae_tpu.models import object_decoder as j_od
from scae_tpu.ops import pooling as j_pool
from scae_tpu_torch import config as t_config
from scae_tpu_torch.models import object_decoder as t_od
from scae_tpu_torch.ops import pooling as t_pool
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
TOL = 1e-6


def close(got, want, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL, err_msg=err_msg)


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- pooling

def test_soft_attention_matches():
    fm, am = rand(3, 5, 7, 6), rand(3, 1, 7, 6, seed=1)
    close(t_pool.soft_attention(torch.from_numpy(fm), torch.from_numpy(am)),
          j_pool.soft_attention(jnp.asarray(fm), jnp.asarray(am)))


def test_attention_pooling_2d_explicit_matches():
    fm, am = rand(2, 4, 5, 5, seed=2), rand(2, 1, 5, 5, seed=3)
    got = t_pool.attention_pooling_2d_explicit(torch.from_numpy(fm),
                                               torch.from_numpy(am))
    assert got.shape == (2, 4, 1, 1)
    close(got, j_pool.attention_pooling_2d_explicit(jnp.asarray(fm),
                                                    jnp.asarray(am)))


@pytest.mark.parametrize("index", [0, 2, 4, -1, 7])
def test_attention_pooling_2d_matches(index):
    fm = rand(2, 5, 6, 4, seed=4)
    got = t_pool.attention_pooling_2d(torch.from_numpy(fm), index)
    assert got.shape == (2, 4, 1, 1)
    close(got, j_pool.attention_pooling_2d(jnp.asarray(fm), index))


# --------------------------------------------------------- CapsuleLayer

ARGS = dict(n_caps=4, dim_feature=9, n_votes=5, dim_caps=6,
            hidden_sizes=(8,), learn_vote_scale=True)
FIELDS = [f.name for f in dataclasses.fields(t_od.CapsuleLayerResult)]


@pytest.fixture(scope="module")
def layers():
    jm, tm = j_od.CapsuleLayer(**ARGS), t_od.CapsuleLayer(**ARGS)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 4, 9)))["params"]
    # nonzero biases and static poses: the init's zeros would hide them
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rand(*p.shape, seed=p.size), params)
    load_flax_params(tm, params)
    return jm, tm, params


def parent_transform(seed=5):
    """(3, O, 1, 3, 3) homogeneous matrices."""
    m = np.zeros((3, 4, 1, 3, 3), np.float32)
    m[..., :2, :] = rand(3, 4, 1, 2, 3, seed=seed)
    m[..., 2, 2] = 1.0
    return m


@pytest.mark.parametrize("hooks", ["none", "transform", "presence", "both"])
def test_capsule_layer_hooks_match(layers, hooks):
    jm, tm, params = layers
    feature = rand(3, 4, 9, seed=6)
    kw = {}
    if hooks in ("transform", "both"):
        kw["parent_transform"] = parent_transform()
    if hooks in ("presence", "both"):
        kw["parent_presence"] = np.random.RandomState(7).rand(
            3, 4, 1).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(feature),
                    deterministic=True,
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tm(torch.from_numpy(feature), deterministic=True,
             **{k: torch.from_numpy(v) for k, v in kw.items()})
    for name in FIELDS:
        close(getattr(got, name), getattr(want, name), err_msg=name)
    plain = tm(torch.from_numpy(feature), deterministic=True)
    same = {name: torch.equal(getattr(got, name), getattr(plain, name))
            for name in FIELDS}
    # each hook replaces what it names and what depends on it
    changed = {"none": set(), "transform": {"vote"},
               "presence": {"vote_presence"},
               "both": {"vote", "vote_presence"}}[hooks]
    assert {n for n, s in same.items() if not s} == changed


# ---------------------------------------------------------- save_config

EVERY_KIND = {
    "a": 1, "b": -2.5, "c": 3e-5, "d": 1e20, "e": True, "f": None,
    "g": "text", "h": "1", "i": "yes", "j": "null", "k": "x: y",
    "l": [1, 2.0, "s"], "m": ["a,b", "[c]"], "n": [[1, 2], [3]],
    "o": [{"p": 1, "q": [2]}, {"r": None}], "s": {}, "t": [],
    "u": {"v": {"w": "it's", "x": "#hash"}}, "y": float("inf"), "z": "",
}


def shipped():
    return [t_config.load_config("config"),
            t_config.load_config("config", ["model=mnist"]),
            *(t_config.load_config("config", [f"model={m[:-5]}"])
              for m in sorted(os.listdir(os.path.join(t_config.CONFIG_DIR,
                                                      "model")))),
            EVERY_KIND]


@pytest.mark.parametrize("index", range(len(shipped())))
def test_save_config_round_trips(tmp_path, index):
    cfg = shipped()[index]
    t_config.save_config(cfg, str(tmp_path / "config.yaml"))
    assert t_config.load_config("config", config_dir=str(tmp_path)) == cfg
    assert j_config.load_config("config", config_dir=str(tmp_path)) == cfg
    with open(tmp_path / "config.yaml") as f:
        assert t_config.read_yaml(f.read()) == cfg


@pytest.mark.parametrize("index", range(len(shipped())))
def test_port_reads_what_scae_tpu_saves(tmp_path, index):
    cfg = shipped()[index]
    j_config.save_config(cfg, str(tmp_path / "config.yaml"))
    assert t_config.load_config("config", config_dir=str(tmp_path)) == cfg


def test_save_config_refuses_what_it_cannot_write(tmp_path):
    path = str(tmp_path / "config.yaml")
    with pytest.raises(TypeError, match="keys must be strings"):
        t_config.save_config({1: "a"}, path)
    with pytest.raises(TypeError, match="cannot write"):
        t_config.save_config({"a": object()}, path)
    with pytest.raises(t_config.YamlSubsetError, match="line break"):
        t_config.save_config({"a": "two\nlines"}, path)
