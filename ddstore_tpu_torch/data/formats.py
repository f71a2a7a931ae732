"""MNIST idx files and the synthetic MNIST-shaped data (the port's copy
of the MNIST part of ``ddstore_tpu/data/formats.py``).

The idx layout: big-endian magic 0x0801 (labels, 1-D) / 0x0803 (images,
3-D), optionally gzipped. Each reader has a writer, so tests and offline
runs can produce faithful fixtures. The graph readers come with the GNN
slice.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

__all__ = ["read_idx", "write_idx", "find_mnist", "load_mnist",
           "synthetic_mnist"]

def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_idx(path: str) -> np.ndarray:
    """Read an idx-format array (images uint8 (N, R, C); labels (N,))."""
    with _open(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        # Layout: two zero bytes, dtype byte (0x08 = ubyte), ndim byte.
        if magic >> 16 != 0 or ((magic >> 8) & 0xFF) != 0x08:
            raise ValueError(f"{path}: bad idx magic {magic:#x}")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = f.read(int(np.prod(dims)))
    arr = np.frombuffer(data, dtype=np.uint8)
    if arr.size != int(np.prod(dims)):
        raise ValueError(f"{path}: truncated idx payload")
    return arr.reshape(dims)


def write_idx(path: str, arr: np.ndarray) -> None:
    """Write uint8 idx (inverse of read_idx; .gz suffix gzips)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    magic = 0x0800 | arr.ndim
    with _open(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


_MNIST_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def find_mnist(data_dir: str, split: str = "train"
               ) -> Optional[Tuple[str, str]]:
    """Locate the canonical MNIST pair in ``data_dir`` (plain or .gz)."""
    img_name, lbl_name = _MNIST_FILES[split]
    for suffix in ("", ".gz"):
        img = os.path.join(data_dir, img_name + suffix)
        lbl = os.path.join(data_dir, lbl_name + suffix)
        if os.path.exists(img) and os.path.exists(lbl):
            return img, lbl
    return None


def load_mnist(data_dir: str, split: str = "train", normalize: bool = True
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, 784), labels (N,) int32) from the standard idx files.

    ``normalize=True`` gives float32 in [0,1] (the normalization
    torchvision's ToTensor applies). ``normalize=False`` keeps the raw
    uint8 pixels, the fast path: the store holds and the loader stages 4x
    fewer bytes, and the model dequantizes on device with identical
    numerics (uint8/255 is exactly what ToTensor computes)."""
    found = find_mnist(data_dir, split)
    if found is None:
        raise FileNotFoundError(
            f"no MNIST idx files for split {split!r} under {data_dir}")
    img_path, lbl_path = found
    images = read_idx(img_path)
    labels = read_idx(lbl_path)
    if images.ndim != 3 or labels.ndim != 1 or len(images) != len(labels):
        raise ValueError(f"MNIST shape mismatch: {images.shape} vs "
                         f"{labels.shape}")
    flat = images.reshape(len(images), -1)
    if normalize:
        flat = flat.astype(np.float32) / 255.0
    return flat, labels.astype(np.int32)


def synthetic_mnist(n: int, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped data for offline environments: blurry
    class-conditioned blobs as uint8 pixels (the real idx files' dtype),
    same on every rank (like a shared download), and the same arrays as
    the JAX package's generator for the same ``(n, seed)``; stored raw,
    dequantized on the device (see ``models/vae._dequantize``)."""
    g = np.random.default_rng(seed)
    labels = g.integers(0, 10, size=n).astype(np.int32)
    centers = g.random((10, 784), dtype=np.float32)
    x = centers[labels] * 0.8 + 0.2 * g.random((n, 784), dtype=np.float32)
    return np.round(x * 255.0).astype(np.uint8), labels

