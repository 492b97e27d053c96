"""Dependency-free PNG writer (grayscale/RGB uint8) via zlib (counterpart
of scae_tpu/utils/png.py, byte for byte).

Used by the metrics writer to persist reconstruction/template grids (the
reference's TensorBoard image grids, base_experiment.py:152-182) without
requiring tensorboard or PIL.
"""

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, array: np.ndarray) -> None:
    """Write (H, W) or (H, W, 3) uint8 (or [0,1] float) array as PNG."""
    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2:
        color_type, channels = 0, 1
        arr = arr[..., None]
    elif arr.ndim == 3 and arr.shape[-1] == 1:
        color_type, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[-1] == 3:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"unsupported image shape {arr.shape}")

    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def make_grid(images: np.ndarray, n_cols: int = 8, pad: int = 2,
              pad_value: float = 0.5) -> np.ndarray:
    """Tile (N, C, H, W) images into one (H', W', C) grid (torchvision
    make_grid equivalent for the reference's viz, base_experiment.py:152)."""
    images = np.asarray(images)
    N, C, H, W = images.shape
    n_cols = min(n_cols, N)
    n_rows = -(-N // n_cols)
    grid = np.full((C, pad + n_rows * (H + pad), pad + n_cols * (W + pad)),
                   pad_value, images.dtype)
    for i in range(N):
        r, c = divmod(i, n_cols)
        y, x = pad + r * (H + pad), pad + c * (W + pad)
        grid[:, y:y + H, x:x + W] = images[i]
    out = np.transpose(grid, (1, 2, 0))
    if C == 1:
        out = out[..., 0]
    return out
