"""The port's config reader (scae_tpu_torch/config.py) against scae_tpu's,
on the CPU: exact equality, types included.

  * the port's copies of the eight shipped YAML files are the JAX
    package's, byte for byte, and its reader parses each as PyYAML's
    ``safe_load`` does;
  * ``load_config`` equals ``scae_tpu.config.load_config`` for every
    shipped model and optimizer and a set of overrides (group swaps,
    dotted keys, keys the files lack, null, JSON lists and objects);
  * the reader equals ``safe_load`` on snippets of the YAML subset it
    takes, and refuses what lies outside it.
"""

import os

import pytest
import yaml

from scae_tpu import config as j_config
from scae_tpu_torch import config as t_config

FILES = ["config.yaml", "model/mnist.yaml", "model/mnist28.yaml",
         "model/svhn.yaml", "model/cifar10.yaml", "optimizer/rmsprop.yaml",
         "optimizer/adam.yaml", "optimizer/radam.yaml"]


def same(a, b):
    """Equal, and equal in type at every leaf (1 == 1.0 == True is not
    enough)."""
    return a == b and repr(a) == repr(b)


def test_the_port_ships_every_config_file():
    shipped = sorted(
        os.path.relpath(os.path.join(d, f), j_config.CONFIG_DIR)
        for d, _, fs in os.walk(j_config.CONFIG_DIR) for f in fs
        if f.endswith(".yaml"))
    assert shipped == sorted(FILES)


@pytest.mark.parametrize("name", FILES)
def test_shipped_file_is_copied_and_parses_as_pyyaml(name):
    with open(os.path.join(j_config.CONFIG_DIR, name), "rb") as f:
        jax_bytes = f.read()
    with open(os.path.join(t_config.CONFIG_DIR, name), "rb") as f:
        port_bytes = f.read()
    assert port_bytes == jax_bytes
    text = port_bytes.decode("utf-8")
    assert same(t_config.read_yaml(text), yaml.safe_load(text))


OVERRIDES = [
    [],
    ["model=mnist28"],
    ["model=svhn"],
    ["model=cifar10"],
    ["optimizer=adam"],
    ["optimizer=radam", "use_lookahead=true", "lookahead.k=5"],
    ["trainer.max_epochs=5", "data_loader.batch_size=64", "seed=7"],
    ["trainer.new_key=3", "brand.new.branch=x"],
    ["data_loader.source=null", "model.image_shape=[1,24,24]",
     "trainer.augment.max_shift=0",
     "model.pcae_cnn_encoder_params.compute_dtype=null"],
    ["model.scae_params.cpr_dynamic_reg_weight=1e-2",
     "lr_scheduler.decay_rate=none", "init_from=/some/dir"],
    ['trainer.mesh={"n_data": 2, "n_model": 1}', "x.y=hello world",
     "model.pcae_cnn_encoder_params.out_channels=[16,16,16,16]"],
    ["model=cifar10", "optimizer=adam", "model.n_part_caps=8",
     "data_loader.data_dir=./data", "mode=test", "resume=true"],
]


@pytest.mark.parametrize("overrides", OVERRIDES,
                         ids=[" ".join(o) or "none" for o in OVERRIDES])
def test_load_config_matches_jax(overrides):
    got = t_config.load_config("config", overrides)
    want = j_config.load_config("config", overrides)
    assert same(got, want)


def test_group_swap_to_a_missing_file_raises_as_jax():
    with pytest.raises(FileNotFoundError):
        j_config.load_config("config", ["optimizer=sgd"])
    with pytest.raises(FileNotFoundError):
        t_config.load_config("config", ["optimizer=sgd"])


def test_override_into_a_scalar_raises():
    with pytest.raises(ValueError, match="scalar"):
        t_config.load_config("config", ["seed.x=1"])
    with pytest.raises(ValueError, match="key=value"):
        t_config.load_config("config", ["resume"])


SNIPPETS = [
    "a: 1e-2", "a: 3.0e-5", "a: 1.5e+3", "a: 10", "a: -3", "a: +4",
    "a: 1_000", "a: .5", "a: 1.", "a: 0", "a: 0.0", "a: 1.2.3", "a: yes",
    "a: Off", "a: TRUE", "a: ~", "a:", "a: null # c", "a: 'x # y'",
    'a: "q"', "a: 'it''s'", "a: [1, 2.5, x, null, true]", "a: []",
    "a: [1, 2,]", "a: {}", "a:\n- 1\n- 2\nb: 3",
    "a:\n  - x: 1\n    y: 2\n  - z: 3\n", "- 1\n- a: 2\n  b: [3]\n",
    "a: foo:bar", "a: b#c", "a: .inf", "a: -.inf", "a: x y  # z",
    "a:\n  b:\n    c: 1\n  d: 2\ne: 3", "# only\n\na: 1   # trailing\n",
    "a: http://x/y", "a: /abs/path", "'q k': 1", "",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_reader_matches_pyyaml(text):
    assert same(t_config.read_yaml(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: -", "a: 010", "a: 0x1f", "a: 1:30", "a: &x 1", "a: *x",
    "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: {b: 1}", "a: [[1]]",
    "a:\n\tb: 1", "a: 1\n  b: 2", "a:\n  b: 1\n c: 2", "---\na: 1",
    'a: "x\\ny"', "a: [1, 2"])
def test_reader_refuses_what_it_does_not_take(text):
    with pytest.raises(t_config.YamlSubsetError):
        t_config.read_yaml(text)
