"""scae_tpu_torch — Stacked Capsule Autoencoders in PyTorch for NVIDIA Hopper.

The PyTorch counterpart of ``scae_tpu``, module for module: ``ops/``,
``models/``, ``parallel/``, ``train/``, ``utils/``, ``factory.py`` and
``serve.py`` mirror the JAX package's layout and names. ``kernels/``
holds the Python wrappers of the hand-written CUDA kernels whose sources
live in ``csrc/``; each kernel replaces one Pallas kernel of the JAX
package and keeps a plain PyTorch version of the same function beside it.

The package imports torch, numpy and the standard library only. Entry
points (``factory.make_scae``, ``parallel.train_step.make_raw_eval_step``,
``serve.make_infer_fn``) run on the CUDA device unless the caller passes
``device="cpu"``.
"""
