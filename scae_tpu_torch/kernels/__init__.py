"""Python wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks its inputs and launches its kernel on the current
CUDA stream through ``_common.launch``, which counts the launch
(``utils/trace.py``: ``kernels.launches.<id>``); for CPU tensors it runs
the plain PyTorch version of the same function, kept in the same module.
``_common.py`` says how a kernel meets PyTorch. Importing this package
registers every op an exported program may call by name
(``scae_tpu_torch::attention_fwd``, ``capsule_votes_fwd`` and
``capsule_votes_bwd``); it builds nothing.
"""

from scae_tpu_torch.kernels import attention, capsule_votes  # noqa: F401
