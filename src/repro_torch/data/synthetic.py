"""Synthetic datasets (no MNIST files, no downloads) — numpy, host side.

``make_image_dataset`` — a 10-class, 28×28 MNIST-like classification
task: each class is a mixture of 3 smooth prototype patterns; samples get
random shifts, per-pixel noise and amplitude jitter.
``make_token_dataset`` — synthetic LM token streams (Zipf unigrams with a
deterministic bigram rule) for the model zoo's training.

Copies of :mod:`repro.data.synthetic`: the same seed gives bitwise-equal
arrays.
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


def make_token_dataset(n_tokens: int, vocab: int, seed: int = 0,
                       zipf_a: float = 1.2) -> np.ndarray:
    """Zipf unigrams + a deterministic bigram successor rule on half the
    positions, so a trained LM has signal to learn. int32 (n_tokens,)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-zipf_a)
    p /= p.sum()
    base = rng.choice(vocab, size=n_tokens, p=p).astype(np.int32)
    succ = rng.permutation(vocab).astype(np.int32)  # bigram rule
    use_rule = rng.random(n_tokens) < 0.5
    out = base.copy()
    out[1:][use_rule[1:]] = succ[out[:-1][use_rule[1:]]]
    return out
