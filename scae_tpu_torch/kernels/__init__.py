"""Python wrappers of the hand-written CUDA kernels in ``csrc/``.

Each wrapper checks its inputs, launches its kernel on the current CUDA
stream and counts its launches; for CPU tensors it runs the plain PyTorch
version of the same function, kept in the same module.
"""
