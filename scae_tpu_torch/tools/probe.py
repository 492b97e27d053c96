"""Toolchain probe: python -m scae_tpu_torch.tools.probe

The counterpart of tools/pallas_probe.py. It builds and runs the two probe
kernels of ``csrc/probe.cu`` on the card: P1, x * 2 + 1 on
``arange(8 * 128)`` as an (8, 128) float32 block, checked with
``allclose``; and P2, a (256, 128) x (128, 256) float32 product of two
seeded normal matrices, checked against numpy's float32 product with
``atol=1e-4``. It prints the device and one line per check, and exits
non-zero if either check fails. ``main(device="cpu")`` runs the plain
versions on the CPU.
"""

import sys

import numpy as np
import torch

from scae_tpu_torch.kernels.probe import affine_probe, matmul_probe
from scae_tpu_torch.utils.device import resolve_device


def probe_inputs():
    """The probes' inputs as float32 numpy arrays: x (8, 128) = arange, a
    (256, 128) and b (128, 256) standard normal from seeds 0 and 1."""
    x = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    a = np.random.RandomState(0).randn(256, 128).astype(np.float32)
    b = np.random.RandomState(1).randn(128, 256).astype(np.float32)
    return x, a, b


def run(device=None):
    """(P1's output, P2's output, P1 ok, P2 ok) on ``device`` (CUDA unless
    given); the outputs as numpy arrays."""
    device = resolve_device(device)
    x, a, b = probe_inputs()
    out = affine_probe(torch.from_numpy(x).to(device)).cpu().numpy()
    mm = matmul_probe(torch.from_numpy(a).to(device),
                      torch.from_numpy(b).to(device)).cpu().numpy()
    return (out, mm, bool(np.allclose(out, x * 2 + 1)),
            bool(np.allclose(mm, a @ b, atol=1e-4)))


def main(argv=None, device=None) -> int:
    del argv  # the probe takes no arguments
    device = resolve_device(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name})")
    _, _, ok, mm_ok = run(device)
    print(f"probe ok: {ok}")
    print(f"probe matmul ok: {mm_ok}")
    return 0 if ok and mm_ok else 1


if __name__ == "__main__":
    sys.exit(main())
