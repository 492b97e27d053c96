"""scae_tpu_torch — Stacked Capsule Autoencoders in PyTorch for NVIDIA Hopper.

The PyTorch counterpart of ``scae_tpu``, module for module: ``ops/``,
``models/``, ``parallel/``, ``train/``, ``utils/``, ``factory.py`` and
``serve.py`` mirror the JAX package's layout and names. ``kernels/``
holds the Python wrappers of the hand-written CUDA kernels whose sources
live in ``csrc/``; each kernel replaces one Pallas kernel of the JAX
package and keeps a plain PyTorch version of the same function beside it.

The package imports torch, numpy and the standard library only (sklearn
and scipy inside ``train.data.real_digits``, TensorBoard inside the
metrics writer, where they are installed). It reads its own copy of the
shipped YAML configs (``configs/``) with its own reader (``config.py``).
Entry points (``python -m scae_tpu_torch.train.cli`` and its
``train.loop.Trainer``, ``python -m scae_tpu_torch.tools.probe``,
``python -m scae_tpu_torch.tools.export_model``, ``factory.make_scae``,
the steps and scans of ``parallel.train_step``, ``serve.make_infer_fn``,
``serve.export_serving`` and ``serve.load_serving``) run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"
