"""The port imports nothing of JAX, flax, PyYAML, sklearn or scae_tpu, and
never builds a kernel at import.

A fresh interpreter blocks those modules (a ``None`` entry in
``sys.modules`` makes any import of them raise), then imports every module
of scae_tpu_torch and chip_smoke.py, as the GPU machine, which has none of
them, does.
"""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import scae_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "scae_tpu",
           "sklearn")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        scae_tpu_torch.__path__, prefix="scae_tpu_torch."))


def test_port_imports_without_jax_flax_yaml_or_scae_tpu():
    modules = port_modules() + ["chip_smoke"]
    for name in ("kernels.decoder_ll_gather", "kernels.decoder_ll_dense",
                 "kernels.decoder_ll_banded", "kernels.attention",
                 "kernels.probe", "kernels.capsule_votes",
                 "kernels.capsule_likelihood",
                 "ops.decoder_ll", "ops.attention",
                 "config", "train.checkpoint", "train.metrics", "train.cli",
                 "tools.probe", "serve", "tools.export_model",
                 "train.logreg", "parallel.mesh", "tools.ensemble_pool",
                 "tools.ensemble_eval", "tools.probe_eval",
                 "tools.probe_calibrate", "tools.verify_serving_readout",
                 "tools.bench_serving", "utils.torch_port",
                 "tools.port_trained", "tools.pool_inprocess", "examples",
                 "examples.infer_demo", "examples.train_resume_demo",
                 "parallel.graphs"):
        assert f"scae_tpu_torch.{name}" in modules
    code = textwrap.dedent(f"""
        import importlib, os, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        for name in {modules!r}:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and m.split(".")[0] in {BLOCKED!r})
        assert not leaked, leaked
        from scae_tpu_torch.kernels import _build
        assert not os.path.exists(_build.BUILD_DIR) or \\
            os.environ["BUILD_DIR_EXISTED"] == "1"
        print("imported", len({modules!r}))
    """)
    from scae_tpu_torch.kernels import _build

    env = dict(os.environ, PYTHONPATH=REPO,
               BUILD_DIR_EXISTED=str(int(os.path.exists(_build.BUILD_DIR))))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"imported {len(modules)}" in out.stdout


def test_calling_the_ops_imports_no_dynamo():
    """The ops that exported programs call by name, called once on CPU
    tensors, import no ``torch._dynamo`` that ``import
    scae_tpu_torch.kernels`` had not loaded: a ``torch.library.custom_op``
    would import it at its first call, seconds of every process's
    set-up."""
    code = textwrap.dedent("""
        import sys
        import torch
        import scae_tpu_torch.kernels
        from scae_tpu_torch.kernels import (
            attention, capsule_likelihood, capsule_votes)
        loaded = "torch._dynamo" in sys.modules
        B, N, M, O, V = 2, 3, 5, 3, 4
        attention.attention(torch.randn(B, N, 4), torch.randn(B, M, 4),
                            torch.randn(B, M, 6), torch.rand(B, M))
        capsule_votes.capsule_votes(
            torch.randn(B, O, 8 * V + 7), torch.randn(1, O, V, 6),
            torch.randn(1, O, 1, 6), torch.randn(1, O, 1),
            torch.randn(1, O, V), torch.randn(1, O, V), None, None, None,
            False, True, True, None, 0.0)
        vote = torch.randn(B, O, M, 6, requires_grad=True)
        out = capsule_likelihood.capsule_likelihood(
            vote, torch.rand(B, O, M) + 0.5, torch.rand(B, O, M),
            torch.randn(1, 1, M, 6), torch.randn(B, M, 6), torch.rand(B, M))
        out[0].backward()
        print("dynamo", loaded, "torch._dynamo" in sys.modules)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, after = out.stdout.split()[-2:]
    assert after == "False" or loaded == "True", out.stdout


def test_chip_smoke_fails_without_cuda():
    """Where torch finds no CUDA device the smoke run exits non-zero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where CUDA is absent")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    smoke run exits non-zero and prints no result line."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "No module named 'scae_tpu_torch'" in out.stderr
    assert '"ok"' not in out.stdout
