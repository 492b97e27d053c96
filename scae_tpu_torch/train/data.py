"""Input pipeline (counterpart of scae_tpu/train/data.py).

The host half is numpy, copied from the JAX package so that it gives the
same arrays bit for bit: MNIST IDX files read from a search path if present
(``find_mnist``, nothing is downloaded), generic ``train.npz`` /
``test.npz`` dumps (``find_npz``), procedurally generated digit-like
images (``synthetic_digits``), sklearn's bundled handwritten digits
(``real_digits``), the in-memory ``Dataset`` and ``load_datasets`` with
its train/val split.

The device half is PyTorch: ``pad_to_canvas`` and the training
augmentations ``random_translate`` and ``random_affine``. Each
augmentation is a draw from an explicit ``torch.Generator`` followed by a
deterministic apply, so that a test can hand the apply the JAX package's
own draws.
"""

import gzip
import math
import os
import struct
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from scae_tpu_torch.ops.warp import affine_warp

_MNIST_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

_SEARCH_PATHS = (
    os.environ.get("SCAE_TPU_DATA_DIR", ""),
    "./data/mnist",
    os.path.expanduser("~/.cache/mnist"),
)


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        assert zero == 0, f"bad IDX magic in {path}"
        assert dtype_code == 0x08, "only ubyte IDX supported"
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def find_mnist(data_dir: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """Locate MNIST IDX files; returns dict of arrays or None."""
    candidates = ([data_dir] if data_dir else []) + [p for p in _SEARCH_PATHS
                                                     if p]
    for root in candidates:
        if not os.path.isdir(root):
            continue
        out = {}
        ok = True
        for key, fname in _MNIST_FILES.items():
            for suffix in ("", ".gz"):
                path = os.path.join(root, fname + suffix)
                if os.path.exists(path):
                    out[key] = _read_idx(path)
                    break
            else:
                ok = False
                break
        if ok:
            return out
    return None


def synthetic_digits(n: int, seed: int = 0, size: int = 28,
                     n_channels: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural digit-like images (uint8 HxW) + pseudo-labels.

    Each sample composes 2-4 oriented bar/arc strokes from a per-class
    stroke bank, giving class-consistent structure for the capsule model to
    discover. Used when real MNIST files are unavailable (zero-egress).
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)

    class_rng = np.random.RandomState(1234)
    # per-class stroke bank: (cx, cy, angle, length, curvature)
    banks = class_rng.uniform(0, 1, size=(10, 4, 5)).astype(np.float32)

    n_pts = 24
    t = np.linspace(-0.5, 0.5, n_pts, dtype=np.float32)
    yy = np.arange(size, dtype=np.float32)
    xx = np.arange(size, dtype=np.float32)

    acc = np.zeros((n, size, size), np.float32)
    max_strokes = 4
    stroke_params = banks[labels]                      # (n, 4, 5)
    n_strokes = 2 + (labels % 3)                       # (n,)
    for s in range(max_strokes):
        active = n_strokes > s                         # (n,)
        if not active.any():
            break
        cx0, cy0, ang0, ln0, cv0 = stroke_params[:, s % 4].T  # (n,) each
        cx = (0.25 + 0.5 * cx0) * size + rng.randn(n) * 1.0
        cy = (0.25 + 0.5 * cy0) * size + rng.randn(n) * 1.0
        ang = ang0 * np.pi + rng.randn(n) * 0.15
        ln = (0.3 + 0.45 * ln0) * size
        curve = cv0[:, None] * 8.0 * (t[None] ** 2 - 0.25 ** 2)  # (n, P)
        px = cx[:, None] + ln[:, None] * t[None] * np.cos(ang)[:, None] \
            - curve * np.sin(ang)[:, None]             # (n, P)
        py = cy[:, None] + ln[:, None] * t[None] * np.sin(ang)[:, None] \
            + curve * np.cos(ang)[:, None]
        # separable gaussian splat: exp(-(dx^2+dy^2)/s2)
        #   = exp(-dx^2/s2) * exp(-dy^2/s2), chunked over samples.
        # s2=5.0 gives MNIST-like ~3px stroke width — thin (1-2px) strokes
        # put SCAE in the explain-everything-as-background local optimum
        # (observed: rec_ll plateaus at the background value).
        s2 = 5.0
        chunk = 512
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            gx = np.exp(-(xx[None, None] - px[lo:hi, :, None]) ** 2
                        / s2)                          # (c, P, W)
            gy = np.exp(-(yy[None, None] - py[lo:hi, :, None]) ** 2
                        / s2)                          # (c, P, H)
            # sum_p gy[c,p,h] * gx[c,p,w] -> (c, H, W)
            contrib = np.einsum("cph,cpw->chw", gy, gx)
            acc[lo:hi] += contrib * active[lo:hi, None, None]

    peak = np.maximum(acc.max(axis=(1, 2), keepdims=True), 1e-6)
    gray = np.clip(acc / peak, 0, 1)
    if n_channels == 1:
        return (gray * 255).astype(np.uint8), labels.astype(np.int64)
    # color variant: per-class tint + mild per-sample hue jitter
    tints = np.random.RandomState(99).uniform(
        0.3, 1.0, size=(10, n_channels)).astype(np.float32)
    jitter = 1.0 + 0.15 * rng.randn(n, n_channels).astype(np.float32)
    color = np.clip(tints[labels] * jitter, 0.0, 1.0)       # (n, C)
    images = gray[..., None] * color[:, None, None, :]
    return (images * 255).astype(np.uint8), labels.astype(np.int64)


def real_digits(size: int = 28, n_channels: int = 1, test_size: int = 297,
                seed: int = 0, tint: str = "class",
                ) -> Tuple[np.ndarray, np.ndarray,
                           np.ndarray, np.ndarray]:
    """Real handwritten digits (sklearn's bundled UCI optdigits, 1797
    samples, 8x8) bilinearly upsampled to `size` x `size`.

    The only *real* handwritten-digit data reachable in a zero-egress
    container — the offline stand-in for the reference's torchvision MNIST
    download (mnist/experiment.py:42-50). Returns
    (train_images, train_labels, test_images, test_labels) as uint8.

    Multichannel (`n_channels>1`) colorization: `tint="class"` (default,
    historical) gives every class a fixed color — a label shortcut that
    inflates classification metrics; `tint="example"` draws an
    independent color per example, so color carries no label information
    and accuracy measures shape learning (the honest mode for color
    QUALITY runs; the tint RNG is keyed off `seed` so the same split
    seed reproduces the same colors).
    """
    from scipy import ndimage
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = d.images.astype(np.float32) / 16.0          # (1797, 8, 8) in [0,1]
    zoom = size / imgs.shape[-1]
    up = ndimage.zoom(imgs, (1.0, zoom, zoom), order=1)
    up = np.clip(up, 0.0, 1.0)
    gray = (up * 255).astype(np.uint8)
    labels = d.target.astype(np.int64)
    if n_channels > 1:
        if tint == "example":
            per_ex = np.random.RandomState(seed + 77).uniform(
                0.3, 1.0, size=(len(up), n_channels)).astype(np.float32)
            imgs_c = up[..., None] * per_ex[:, None, None, :]
        elif tint == "class":
            tints = np.random.RandomState(99).uniform(
                0.3, 1.0, size=(10, n_channels)).astype(np.float32)
            imgs_c = up[..., None] * tints[labels][:, None, None, :]
        else:
            raise ValueError(f"unknown tint mode {tint!r}")
        gray = (np.clip(imgs_c, 0, 1) * 255).astype(np.uint8)
    # deterministic shuffled holdout (the set is ordered by digit batches)
    perm = np.random.RandomState(seed).permutation(len(gray))
    gray, labels = gray[perm], labels[perm]
    return (gray[test_size:], labels[test_size:],
            gray[:test_size], labels[:test_size])


def to_nchw_float(images: np.ndarray) -> np.ndarray:
    """uint8 (B, H, W) or (B, H, W, C) -> float32 (B, C, H, W) in [0,1]."""
    x = images.astype(np.float32) / 255.0
    if x.ndim == 3:
        return x[:, None]
    return np.transpose(x, (0, 3, 1, 2))


class Dataset:
    """In-memory dataset with shuffled mini-batch iteration.

    images: uint8, (N, H, W) grayscale or (N, H, W, C) color.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        assert images.ndim in (3, 4)
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True,
                drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.images)
        idx = np.arange(n)
        if shuffle:
            np.random.RandomState(seed).shuffle(idx)
        end = n - (n % batch_size) if drop_remainder else n
        for start in range(0, end, batch_size):
            sel = idx[start:start + batch_size]
            yield {
                "image": to_nchw_float(self.images[sel]),
                "label": self.labels[sel].astype(np.int32),
            }


def find_npz(data_dir: Optional[str]) -> Optional[Dict[str, np.ndarray]]:
    """Generic dataset dump: <dir>/{train,test}.npz with images/labels
    keys (covers locally prepared SVHN/CIFAR in a zero-egress box).
    Searches the same candidate chain as find_mnist (explicit dir, then
    SCAE_TPU_DATA_DIR and the standard locations)."""
    candidates = ([data_dir] if data_dir else []) + [p for p in _SEARCH_PATHS
                                                     if p]
    for root in candidates:
        if not os.path.isdir(root):
            continue
        out = {}
        for split in ("train", "test"):
            path = os.path.join(root, f"{split}.npz")
            if not os.path.exists(path):
                out = None
                break
            with np.load(path) as z:
                out[f"{split}_images"] = z["images"]
                out[f"{split}_labels"] = z["labels"]
        if out is not None:
            # the implicit search chain can pick up a stray dump far from
            # the requested data_dir — always say which files won
            print(f"[scae_tpu_torch] npz dataset resolved from: {root}")
            return out
    return None


def load_datasets(data_dir: Optional[str] = None, val_size: int = 5000,
                  synthetic_train: int = 12000, synthetic_test: int = 2000,
                  seed: int = 42, image_size: int = 28,
                  n_channels: int = 1, source: Optional[str] = None,
                  split_seed: Optional[int] = None,
                  tint: Optional[str] = None):
    """(train, val, test) Datasets: npz dump > MNIST IDX > synthetic.

    `source` forces a specific origin: "npz"/"mnist" (must be found on
    disk), "digits" (sklearn's real handwritten digits, no files needed),
    or "synthetic". None keeps the on-disk-then-synthetic auto chain.

    `split_seed` decouples the DATA from the run seed: when set, it keys
    dataset content (synthetic generation / the digits holdout) and the
    train/val split, while `seed` keeps keying only model init and noise
    streams. The reference entangles the two (mnist/train.py
    seed_everything keys both the random_split and the model); with
    split_seed, independently-seeded runs see identical train/val/test
    sets — the precondition for honest seed probes (candidates compared
    on one split) and for ensembling runs at test time
    (tools/ensemble_eval.py). None (default) preserves the entangled
    behavior.
    """
    if source not in (None, "auto", "npz", "mnist", "digits", "synthetic"):
        raise ValueError(f"unknown data source {source!r}")
    ss = seed if split_seed is None else int(split_seed)
    want = None if source == "auto" else source
    npz = find_npz(data_dir) if want in (None, "npz") else None
    mnist = (None if npz else find_mnist(data_dir)) \
        if want in (None, "mnist") else None
    if want in ("npz", "mnist") and npz is None and mnist is None:
        raise FileNotFoundError(
            f"data source {want!r} requested but no files found under "
            f"{data_dir or _SEARCH_PATHS}")
    if npz is not None:
        tr_im, tr_lb = npz["train_images"], npz["train_labels"]
        te_im, te_lb = npz["test_images"], npz["test_labels"]
        source = "npz"
    elif mnist is not None:
        tr_im, tr_lb = mnist["train_images"], mnist["train_labels"]
        te_im, te_lb = mnist["test_images"], mnist["test_labels"]
        source = "mnist"
    elif want == "digits":
        tr_im, tr_lb, te_im, te_lb = real_digits(
            size=image_size, n_channels=n_channels, seed=ss,
            tint=tint or "class")
        source = "digits"
    else:
        tr_im, tr_lb = synthetic_digits(synthetic_train, seed=ss,
                                        size=image_size,
                                        n_channels=n_channels)
        te_im, te_lb = synthetic_digits(synthetic_test, seed=ss + 1,
                                        size=image_size,
                                        n_channels=n_channels)
        source = "synthetic"

    # reference: 55000/5000 random_split at seed (mnist/experiment.py:47)
    if val_size >= len(tr_im):  # small real datasets (e.g. digits, N=1500)
        val_size = max(len(tr_im) // 5, 1)
    rng = np.random.RandomState(ss)
    perm = rng.permutation(len(tr_im))
    val_idx, train_idx = perm[:val_size], perm[val_size:]
    return (Dataset(tr_im[train_idx], tr_lb[train_idx]),
            Dataset(tr_im[val_idx], tr_lb[val_idx]),
            Dataset(te_im, te_lb),
            source)


def pad_to_canvas(images: torch.Tensor, canvas: int) -> torch.Tensor:
    """Centre-pad (or centre-crop) (B, C, h, w) images to canvas x canvas."""
    h, w = images.shape[-2:]
    if h > canvas:
        top = (h - canvas) // 2
        images = images[..., top:top + canvas, :]
        h = canvas
    if w > canvas:
        left = (w - canvas) // 2
        images = images[..., left:left + canvas]
        w = canvas
    top, left = (canvas - h) // 2, (canvas - w) // 2
    return F.pad(images, (left, canvas - w - left, top, canvas - h - top))


def draw_translation(batch_size: int, max_shift: int,
                     generator: torch.Generator):
    """Per-sample window offsets (ox, oy), each (B,) int64 in
    [0, 2 max_shift], on the generator's device."""
    shape = (batch_size,)
    kw = dict(generator=generator, device=generator.device)
    ox = torch.randint(0, 2 * max_shift + 1, shape, **kw)
    oy = torch.randint(0, 2 * max_shift + 1, shape, **kw)
    return ox, oy


def translate(images: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor,
              max_shift: int) -> torch.Tensor:
    """Pad (B, C, H, W) images by ``max_shift`` and take each sample's
    H x W window at (oy, ox): ``padded[b, :, oy:oy+H, ox:ox+W]``, as two
    batched gathers, one per spatial axis."""
    B, C, H, W = images.shape
    padded = F.pad(images, (max_shift,) * 4)
    rows = oy[:, None] + torch.arange(H, device=images.device)   # (B, H)
    cols = ox[:, None] + torch.arange(W, device=images.device)   # (B, W)
    out = torch.gather(padded, 2, rows[:, None, :, None].expand(
        B, C, H, padded.shape[-1]))
    return torch.gather(out, 3, cols[:, None, None, :].expand(B, C, H, W))


def random_translate(images: torch.Tensor, generator: torch.Generator,
                     max_shift: int) -> torch.Tensor:
    """Random per-sample integer translation by up to +-``max_shift``
    pixels, zeros shifted in (the reference's pad + RandomAffine(translate)
    augmentation, mnist/experiment.py:27-36)."""
    ox, oy = draw_translation(images.shape[0], max_shift, generator)
    return translate(images, ox, oy, max_shift)


def draw_affine(batch_size: int, degrees: float, scale_jitter: float,
                generator: torch.Generator):
    """Per-sample rotation (radians, from U(-degrees, degrees) degrees) and
    scale (from U(1 - scale_jitter, 1 + scale_jitter)), each (B,) f32."""
    kw = dict(generator=generator, device=generator.device)
    u_th = torch.rand((batch_size,), **kw)
    u_sc = torch.rand((batch_size,), **kw)
    theta = (u_th * (2.0 * degrees) - degrees) * (math.pi / 180.0)
    scale = u_sc * (2.0 * scale_jitter) + (1.0 - scale_jitter)
    return theta, scale


def rotate_scale(images: torch.Tensor, theta: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Rotate by ``theta`` and zoom by ``scale`` about the image centre,
    bilinear with zero padding (the part decoder's ``affine_warp``). The
    pose is the inverse map, output pixel to source pixel:
    (1/s) R(-theta), no translation."""
    B, C, H, W = images.shape
    c = torch.cos(theta) / scale
    sn = torch.sin(theta) / scale
    zero = torch.zeros_like(c)
    pose = torch.stack([c, sn, zero, -sn, c, zero], dim=-1)      # (B, 6)
    return affine_warp(images.to(torch.float32), pose, (H, W))


def random_affine(images: torch.Tensor, generator: torch.Generator,
                  degrees: float = 0.0,
                  scale_jitter: float = 0.0) -> torch.Tensor:
    """Random per-sample rotation and isotropic zoom (the torchvision
    RandomAffine surface; integer translation stays in
    ``random_translate``)."""
    theta, scale = draw_affine(images.shape[0], degrees, scale_jitter,
                               generator)
    return rotate_scale(images, theta, scale)
