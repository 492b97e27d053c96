"""The port's building blocks (scae_tpu_torch/models/layers.py) against
scae_tpu/models/layers.py: flax-initialised weights carried across by
scae_tpu_torch/utils/from_flax.py, the same numpy inputs, f32 on the CPU.

Tolerance: 1e-5 relative and absolute (tests/test_parity_golden.py).
The port's own initialisation is checked against the JAX initialisers'
bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from scae_tpu.models import layers as jl
from scae_tpu_torch.models import layers as tl
from scae_tpu_torch.utils.from_flax import load_flax_params

torch.set_num_threads(1)
TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def init_apply(module, x):
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return params, module.apply({"params": params}, jnp.asarray(x))


def port(module, params):
    return load_flax_params(module, jax.tree_util.tree_map(np.asarray,
                                                           params))


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("precision", [None, "highest"])
def test_torch_linear_matches(precision):
    x = rand(3, 4, 7)
    jp = jax.lax.Precision.HIGHEST if precision else None
    params, want = init_apply(jl.TorchLinear(5, precision=jp), x)
    tm = port(tl.TorchLinear(7, 5, precision=precision), params)
    close(tm(torch.from_numpy(x)), want)


def test_torch_conv2d_matches():
    x = rand(2, 3, 9, 9)
    params, want = init_apply(jl.TorchConv2d(4, 3, stride=2), x)
    tm = port(tl.TorchConv2d(3, 4, 3, stride=2), params)
    close(tm(torch.from_numpy(x)), want)


def test_torch_conv2d_bf16_compute_matches():
    x = rand(2, 3, 9, 9)
    params, want = init_apply(
        jl.TorchConv2d(4, 3, compute_dtype="bfloat16"), x)
    tm = port(tl.TorchConv2d(3, 4, 3, compute_dtype="bfloat16"), params)
    # bf16 operands (8 significant bits): the two frameworks round the
    # products' sums at different points
    close(tm(torch.from_numpy(x)), want, tol=3e-2)


@pytest.mark.parametrize("activate_final", [True, False])
def test_mlp_matches(activate_final):
    x = rand(2, 5, 6)
    params, want = init_apply(
        jl.MLP((6, 8, 3), activate_final=activate_final), x)
    tm = port(tl.MLP((6, 8, 3), activate_final=activate_final), params)
    close(tm(torch.from_numpy(x)), want)


def test_conv2d_stack_matches():
    x = rand(2, 1, 16, 16)
    args = dict(out_channels=(4, 5, 6), kernel_sizes=(3, 3, 3),
                strides=(2, 1, 1))
    params, want = init_apply(jl.Conv2dStack(**args), x)
    tm = port(tl.Conv2dStack(1, **args), params)
    close(tm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("use_bias", [True, False])
def test_stacked_mlp_matches(use_bias):
    x = rand(3, 4, 6)
    params, want = init_apply(
        jl.StackedMLP(n_stack=4, sizes=(6, 9, 5), use_bias=use_bias), x)
    tm = port(tl.StackedMLP(4, (6, 9, 5), use_bias=use_bias), params)
    close(tm(torch.from_numpy(x)), want)
    # extra leading dims, as the JAX einsum allows
    x2 = rand(2, 3, 4, 6, seed=1)
    close(tm(torch.from_numpy(x2)),
          jl.StackedMLP(n_stack=4, sizes=(6, 9, 5), use_bias=use_bias)
          .apply({"params": params}, jnp.asarray(x2)))


def test_layer_norm_matches():
    x = rand(2, 5, 8) * 3 + 1
    params, want = init_apply(fnn.LayerNorm(epsilon=1e-5), x)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rand(*p.shape, seed=2)), params)
    want = fnn.LayerNorm(epsilon=1e-5).apply({"params": params},
                                            jnp.asarray(x))
    ln = torch.nn.LayerNorm(8, eps=1e-5)
    ln.load_state_dict({"weight": torch.tensor(np.asarray(params["scale"])),
                        "bias": torch.tensor(np.asarray(params["bias"]))})
    close(ln(torch.from_numpy(x)), want)


@pytest.mark.parametrize("name", ["relu", "relu1", "sigmoid", "tanh",
                                  "softplus", "elu", "gelu", "identity"])
def test_choose_activation_matches(name):
    x = rand(4, 6) * 2
    close(tl.choose_activation(name)(torch.from_numpy(x)),
          jl.choose_activation(name)(jnp.asarray(x)))


def test_choose_activation_rejects_unknown():
    with pytest.raises(ValueError, match="Unknown activation"):
        tl.choose_activation("swishy")


def test_port_init_mirrors_jax_bounds():
    g = torch.Generator().manual_seed(0)
    lin = tl.TorchLinear(50, 40)
    conv = tl.TorchConv2d(3, 8, 5)
    bank = tl.StackedMLP(6, (30, 20))
    for m in (lin, conv, bank):
        tl.init_parameters(m, g)
    b_lin, b_conv, b_bank = (1 / math.sqrt(50), 1 / math.sqrt(75),
                             1 / math.sqrt(30))
    for t, b in ((lin.weight, b_lin), (lin.bias, b_lin),
                 (conv.weight, b_conv), (conv.bias, b_conv),
                 (bank.kernel_0, b_bank), (bank.bias_0, b_bank)):
        top = float(t.detach().abs().max())
        # within the bound, and a uniform draw fills most of its range
        assert 0.8 * b < top <= b
    # the JAX initialisers draw from the same ranges
    jparams = jl.TorchLinear(40).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 50)))["params"]
    assert float(jnp.abs(jparams["kernel"]).max()) <= b_lin
    again = tl.TorchLinear(50, 40)
    tl.init_parameters(again, torch.Generator().manual_seed(0))
    tl.init_parameters(lin, torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, lin.weight)
