"""Datasets for the paper reproduction (Sec. 5).

The paper uses MNIST / Fashion-MNIST / EMNIST-Digits / EMNIST-Letters —
8-bit grayscale 784-pixel images.  With no network at hand, this module provides:

* a **deterministic synthetic generator** with MNIST-like statistics
  (per-class smooth prototypes + elastic jitter + noise, 8-bit quantized,
  balanced classes).  Four presets mirror the four paper datasets' class
  counts and relative difficulty (separation parameter).
* an **IDX loader**: if real MNIST/EMNIST files exist under ``data/<name>/``
  they are used instead, transparently.

What we validate against the paper is the *gap* between LNS and
float/fixed-point baselines (≤ ≈1% for 16-bit LUT training), which is a
property of the arithmetic, not of the specific image distribution.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import struct

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    separation: float       # prototype separation; lower = harder
    n_train: int = 4000
    n_test: int = 1000


# Difficulty ordering mirrors paper Table 1 (MNIST/EMNISTD easy,
# FMNIST harder, EMNISTL hardest: 26 classes).
PRESETS = {
    "mnist": DatasetSpec("mnist", 10, separation=3.0),
    "fmnist": DatasetSpec("fmnist", 10, separation=1.6),
    "emnistd": DatasetSpec("emnistd", 10, separation=2.6),
    "emnistl": DatasetSpec("emnistl", 26, separation=1.8),
}


def _smooth(img, n=2):
    """Cheap separable box blur on a 28x28 image."""
    for _ in range(n):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
               + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def synthetic(spec: DatasetSpec, seed: int = 0):
    """Return (x_train, y_train, x_test, y_test); x in [0,1], 8-bit grid."""
    rng = np.random.default_rng(seed)
    protos = []
    for _ in range(spec.n_classes):
        p = _smooth(rng.normal(size=(28, 28)), 3)
        p = (p - p.min()) / (np.ptp(p) + 1e-9)
        protos.append(p)
    protos = np.stack(protos)  # (C, 28, 28)

    def sample(n, rng):
        y = rng.integers(0, spec.n_classes, size=n)
        base = protos[y] * spec.separation
        # elastic jitter: random shift by up to 2 px
        sx = rng.integers(-2, 3, size=n)
        sy = rng.integers(-2, 3, size=n)
        imgs = np.empty_like(base)
        for i in range(n):
            imgs[i] = np.roll(np.roll(base[i], sx[i], 0), sy[i], 1)
        imgs = imgs + rng.normal(size=imgs.shape)
        # MNIST-like sparsity: ~75% exact-zero background.  (Keeps
        # activation/gradient magnitudes in the regime where the paper's
        # fixed-point formats are trainable at lr=0.01.)
        thresh = np.quantile(imgs, 0.75, axis=(1, 2), keepdims=True)
        imgs = np.maximum(imgs - thresh, 0.0)
        imgs = imgs / (imgs.max(axis=(1, 2), keepdims=True) + 1e-9)
        x8 = np.round(imgs * 255) / 255.0
        return x8.reshape(n, 784).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(spec.n_train, np.random.default_rng(seed + 1))
    x_te, y_te = sample(spec.n_test, np.random.default_rng(seed + 2))
    return x_tr, y_tr, x_te, y_te


def _read_idx(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load(name: str, data_dir: str = "data", seed: int = 0):
    """Real IDX files if present; synthetic preset otherwise."""
    spec = PRESETS[name]
    d = os.path.join(data_dir, name)
    files = {
        "xtr": "train-images-idx3-ubyte",
        "ytr": "train-labels-idx1-ubyte",
        "xte": "t10k-images-idx3-ubyte",
        "yte": "t10k-labels-idx1-ubyte",
    }
    paths = {k: os.path.join(d, v) for k, v in files.items()}
    if all(os.path.exists(p) or os.path.exists(p + ".gz") for p in paths.values()):
        def rd(p):
            return _read_idx(p if os.path.exists(p) else p + ".gz")
        x_tr = rd(paths["xtr"]).reshape(-1, 784).astype(np.float32) / 255.0
        y_tr = rd(paths["ytr"]).astype(np.int32)
        x_te = rd(paths["xte"]).reshape(-1, 784).astype(np.float32) / 255.0
        y_te = rd(paths["yte"]).astype(np.int32)
        return x_tr, y_tr, x_te, y_te, spec
    x_tr, y_tr, x_te, y_te = synthetic(spec, seed)
    return x_tr, y_tr, x_te, y_te, spec


def train_val_split(x, y, ratio: int = 5, seed: int = 0):
    """Hold back validation with a 1:ratio split (paper Sec. 5)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_val = len(x) // (ratio + 1)
    val, tr = idx[:n_val], idx[n_val:]
    return x[tr], y[tr], x[val], y[val]
