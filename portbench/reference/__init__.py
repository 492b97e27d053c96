"""The plain reference of the benchmark: plain PyTorch, float32, TF32 off.

It imports neither JAX nor the JAX package nor anything of
``scae_tpu_torch``, and takes nothing that the program has made: it is
given the benchmark's seeds, weights and data, and works out again what
the program derived from them (the translations and the noise drawn from
the per-step seeds, every step's parameters, the served outputs).
"""

import contextlib

import torch


@contextlib.contextmanager
def math_mode(tf32=False):
    """TF32 off (or, for the control, on) for cuBLAS and cuDNN inside the
    block; restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
