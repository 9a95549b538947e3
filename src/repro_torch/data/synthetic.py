"""Synthetic datasets (no MNIST files, no downloads) — numpy, host side.

``make_image_dataset`` — a 10-class, 28×28 MNIST-like classification
task: each class is a mixture of 3 smooth prototype patterns; samples get
random shifts, per-pixel noise and amplitude jitter. A copy of
:func:`repro.data.synthetic.make_image_dataset`: the same seed gives
bitwise-equal arrays.
"""
from __future__ import annotations

import numpy as np


def _smooth_noise(rng, shape, blur: int = 3):
    x = rng.standard_normal(shape)
    for axis in (-2, -1):
        for _ in range(blur):
            x = 0.5 * x + 0.25 * (np.roll(x, 1, axis) + np.roll(x, -1, axis))
    return x


def make_image_dataset(n_train: int = 60_000, n_test: int = 10_000,
                       n_classes: int = 10, seed: int = 0,
                       modes_per_class: int = 3, noise: float = 0.65,
                       max_shift: int = 3):
    """Returns (x_train, y_train, x_test, y_test); images (N, 28, 28) f32."""
    rng = np.random.default_rng(seed)
    protos = _smooth_noise(rng, (n_classes, modes_per_class, 28, 28), blur=4)
    protos /= np.abs(protos).max(axis=(-2, -1), keepdims=True)

    def gen(n, rng):
        y = rng.integers(0, n_classes, n)
        m = rng.integers(0, modes_per_class, n)
        x = protos[y, m].copy()
        sx = rng.integers(-max_shift, max_shift + 1, n)
        sy = rng.integers(-max_shift, max_shift + 1, n)
        for i in range(n):
            if sx[i]:
                x[i] = np.roll(x[i], sx[i], axis=0)
            if sy[i]:
                x[i] = np.roll(x[i], sy[i], axis=1)
        amp = rng.uniform(0.7, 1.3, (n, 1, 1))
        x = amp * x + noise * rng.standard_normal(x.shape)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = gen(n_train, rng)
    x_te, y_te = gen(n_test, np.random.default_rng(seed + 1))
    return x_tr, y_tr, x_te, y_te
