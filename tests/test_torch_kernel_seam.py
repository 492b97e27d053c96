"""The seam between the hand-written kernels and PyTorch, on the CPU: each
wrapper's launch, with the built library swapped for a recording one and
the CUDA stream for a stand-in, passes its launcher exactly the pointers
and ints that ``_build.load`` declares for it, and counts one launch of
its kernel (``utils/trace.py``). No kernel is built or run.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from scae_tpu_torch.kernels import _build
from scae_tpu_torch.kernels import attention as k6
from scae_tpu_torch.kernels import capsule_votes as cv
from scae_tpu_torch.kernels import decoder_ll_banded as k5
from scae_tpu_torch.kernels import decoder_ll_dense as k4
from scae_tpu_torch.kernels import decoder_ll_gather as k1
from scae_tpu_torch.kernels import probe as kp
from scae_tpu_torch.ops.geometry import geometric_transform
from scae_tpu_torch.utils import trace


@pytest.fixture
def launchers(monkeypatch):
    """{symbol: [the args of each call]}: ``_build.load`` hands out a
    launcher that checks its arguments against the declared pointers and
    ints, records them and returns 0."""
    calls = {}

    def load(source, symbol, n_ptr, n_int):
        def fn(*args):
            assert len(args) == n_ptr + n_int + 1, (symbol, len(args))
            ptrs, ints = args[:n_ptr], args[n_ptr:-1]
            assert all(p is None or isinstance(p, int) for p in ptrs), symbol
            assert all(type(i) is int for i in ints), (symbol, ints)
            calls.setdefault(symbol, []).append(args)
            return 0

        return fn, None, None

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    return calls


def likelihood_args(B=2, M=8, C=1, Ht=5, Wt=5, H=16, W=16, alpha_batch=1):
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return [t(rng.rand(B, M, C, Ht, Wt)),
            t(rng.randn(alpha_batch, M, 1, Ht, Wt)),
            geometric_transform(t(rng.randn(B, M, 6) * 0.6)).contiguous(),
            t(rng.rand(B, M)), t(0.3), t(0.7), t(1.0),
            t(rng.rand(B, C, H, W)), (H, W)]


def bwd_call(module, *extra):
    args = likelihood_args(alpha_batch=2 if module is k5 else 1)
    B, C, H, W = args[7].shape
    g = torch.ones(B, C, H, W)
    num, den = torch.zeros(B, C, H * W), torch.zeros(B, 1, H * W)
    return module._bwd_launch(g, num, den, *args, True, *extra)


def banded_fwd():
    args = likelihood_args(alpha_batch=2)
    plan = dict(threads=256, pixels=1, chunk=8)
    return k5._launch(*args, plan=plan)


def votes_args(B=2, O=3, V=4):
    rng = np.random.RandomState(1)
    t = lambda *s: torch.from_numpy(rng.rand(*s).astype(np.float32))  # noqa
    return (t(B, O, 8 * V + 7), t(1, O, V, 6), t(1, O, 1, 6), t(1, O, 1),
            t(1, O, V), t(1, O, V), t(B, O, 1), t(B, O, 1), t(B, O, V),
            False, True, True, "uniform", 4.0)


def votes_bwd():
    args = votes_args()
    outs = cv._launch_fwd(*args)
    return cv._launch_bwd(*args[:9], *outs, *args[9:])


# per kernel: its launcher's symbol and a call that launches it once
CASES = {
    "K1": ("scae_decoder_ll_gather_fwd",
           lambda: k1._launch(*likelihood_args())),
    "K2+K3": ("scae_decoder_ll_gather_bwd", lambda: bwd_call(k1)),
    "K4f": ("scae_decoder_ll_dense_fwd",
            lambda: k4._launch(*likelihood_args())),
    "K4b": ("scae_decoder_ll_dense_bwd", lambda: bwd_call(k4)),
    "K5f": ("scae_decoder_ll_banded_fwd", banded_fwd),
    "K5b": ("scae_decoder_ll_banded_bwd", lambda: bwd_call(k5)),
    "K6": ("scae_attention_fwd", lambda: k6._launch(
        torch.rand(2, 3, 8), torch.rand(2, 5, 8), torch.rand(2, 5, 4),
        torch.rand(2, 5))),
    "V1f": ("scae_capsule_votes_fwd", lambda: cv._launch_fwd(*votes_args())),
    "V1b": ("scae_capsule_votes_bwd", votes_bwd),
    "P2": ("scae_probe_matmul", lambda: kp._matmul_launch(
        torch.rand(4, 8), torch.rand(8, 6), kp.matmul_plan(4, 8, 6))),
}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_launch_passes_the_declared_arguments_and_counts(launchers, kernel):
    symbol, launch = CASES[kernel]
    counted = trace.Since()
    launch()
    (args,) = launchers[symbol]
    assert args[-1] == 7                    # the current stream
    assert counted.launches(kernel) == (1,)
