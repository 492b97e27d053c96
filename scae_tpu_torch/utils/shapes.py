"""Convolution shape arithmetic (counterpart of scae_tpu/utils/shapes.py).

Only what the port's models call: the part encoder's output size.
"""


def conv_output_size(size: int, kernel: int, stride: int = 1,
                     padding: int = 0, dilation: int = 1) -> int:
    """torch Conv2d output-size arithmetic."""
    return (size + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
