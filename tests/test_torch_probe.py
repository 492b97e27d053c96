"""The port's toolchain probes (scae_tpu_torch/kernels/probe.py, P1 and P2,
and the entry point scae_tpu_torch/tools/probe.py) against the Pallas
kernels of tools/pallas_probe.py, on the CPU.

tools/pallas_probe.py runs its probes when it is imported, on the TPU, so
the test takes its two kernel bodies (``kernel`` and ``mm_kernel``) from its
source and runs them through ``pl.pallas_call`` in interpret mode, on the
probe's own inputs made with numpy. Tolerances: P1 exact (x * 2 is exact,
the sum rounded once on either side); P2 1e-4 absolute, the JAX probe's
own, on f32 sums of 128 products of N(0, 1) entries taken in two orders.
The wrappers' CUDA paths are tested on the card (tests/test_torch_gpu.py).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from scae_tpu_torch.kernels import probe as kp
from scae_tpu_torch.tools import probe as probe_tool
from scae_tpu_torch.utils import trace

torch.set_num_threads(1)
PROBE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "pallas_probe.py")


@pytest.fixture(scope="module")
def pallas_kernels():
    """``kernel`` and ``mm_kernel`` of tools/pallas_probe.py, compiled from
    their source alone (importing the file would run the TPU probe)."""
    with open(PROBE) as f:
        tree = ast.parse(f.read())
    namespace = {"jnp": jnp}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in (
                "kernel", "mm_kernel"):
            exec(compile(ast.Module([node], []), PROBE, "exec"), namespace)
    return namespace["kernel"], namespace["mm_kernel"]


def interpret(kernel, out_shape, *args):
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(*[jnp.asarray(a) for a in args]))


def test_p1_plain_matches_the_pallas_kernel(pallas_kernels):
    x, _, _ = probe_tool.probe_inputs()
    want = interpret(pallas_kernels[0], x.shape, x)
    got = kp.affine_probe(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        kp.affine_probe_plain(torch.from_numpy(x)).numpy(), want)


def test_p2_plain_matches_the_pallas_kernel(pallas_kernels):
    _, a, b = probe_tool.probe_inputs()
    want = interpret(pallas_kernels[1], (256, 256), a, b)
    got = kp.matmul_probe(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (256, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_probe_inputs_are_the_jax_probes():
    x, a, b = probe_tool.probe_inputs()
    np.testing.assert_array_equal(
        x, np.asarray(jnp.arange(8 * 128, dtype=jnp.float32).reshape(8, 128)))
    assert a.shape == (256, 128) and b.shape == (128, 256)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(
        a, np.random.RandomState(0).randn(256, 128).astype(np.float32))


def test_entry_point_on_the_cpu(capsys):
    counted = trace.Since()
    assert probe_tool.main(device="cpu") == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out
    assert "probe ok: True" in out and "probe matmul ok: True" in out
    # the CPU runs the plain versions: no kernel is built or counted
    assert counted.launches("P1", "P2") == (0, 0)


def test_entry_point_reports_a_failed_check(monkeypatch, capsys):
    monkeypatch.setattr(probe_tool, "matmul_probe",
                        lambda a, b: torch.matmul(a, b) + 1e-3)
    assert probe_tool.main(device="cpu") == 1
    assert "probe matmul ok: False" in capsys.readouterr().out


def test_entry_point_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probe_tool.main()


@pytest.mark.parametrize("case", ["float64", "int32", "1-D", "3-D",
                                  "non-contiguous", "empty"])
def test_affine_probe_refuses(case):
    x = torch.ones(8, 128)
    bad = {"float64": x.double(), "int32": x.int(), "1-D": x[0],
           "3-D": x[None], "non-contiguous": x.t(),
           "empty": torch.ones(0, 128)}[case]
    with pytest.raises((TypeError, ValueError)):
        kp.affine_probe(bad)


@pytest.mark.parametrize("case", ["inner sizes", "float64 b", "1-D b",
                                  "non-contiguous a", "devices"])
def test_matmul_probe_refuses(case):
    a, b = torch.ones(4, 3), torch.ones(3, 5)
    args = {"inner sizes": (a, torch.ones(4, 5)),
            "float64 b": (a, b.double()), "1-D b": (a, b[0]),
            "non-contiguous a": (torch.ones(3, 4).t(), b),
            "devices": (a, torch.ones(3, 5, device="meta"))}[case]
    with pytest.raises((TypeError, ValueError)):
        kp.matmul_probe(*args)


def test_matmul_probe_plain_at_ragged_sizes():
    rng = np.random.RandomState(2)
    a = rng.randn(100, 37).astype(np.float32)
    b = rng.randn(37, 53).astype(np.float32)
    got = kp.matmul_probe(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), a @ b, rtol=0, atol=1e-4)
