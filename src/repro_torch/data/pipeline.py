"""Synthetic data sets, numpy only (counterpart of ``repro/data/pipeline.py``).

The container that builds this repository has no downloads, so MNIST is a
class-conditional stand-in and the regression set a symbolic target.  Both
draw from ``np.random.RandomState`` exactly as the reference does, so the
same arguments give byte-equal arrays.  ``lm_batch`` is not here: it draws
through ``jax.random`` (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import numpy as np


def mnist_like(
    n: int, seed: int = 0, n_classes: int = 10, dim: int = 784,
    noise: float = 0.7, proto_seed: int = 1234,
) -> tuple[np.ndarray, np.ndarray]:
    """Class-conditional structured patterns in [-1, 1]^dim: ``n`` inputs
    (float32) and their labels (int32).  Prototypes are smooth random
    fields; an input is its class's prototype plus noise, squashed by tanh.

    ``proto_seed`` fixes the prototypes independently of ``seed``, so train
    and test splits drawn with different seeds share one task."""
    rs_p = np.random.RandomState(proto_seed)
    side = int(np.sqrt(dim))
    protos = []
    for _ in range(n_classes):
        f = rs_p.normal(size=(side // 4 + 1, side // 4 + 1))
        up = np.kron(f, np.ones((4, 4)))[:side, :side]
        protos.append(up / (np.abs(up).max() + 1e-9))
    protos = np.stack(protos).reshape(n_classes, -1)
    rs = np.random.RandomState(seed)
    y = rs.randint(0, n_classes, n)
    x = protos[y] + noise * rs.normal(size=(n, dim))
    x = np.tanh(x).astype(np.float32)
    return x, y.astype(np.int32)


def regression_set(n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``f(x, y) = exp(sin(pi x) + y^2)`` on ``n`` points uniform over
    [-1, 1]^2: inputs ``(n, 2)`` and targets ``(n, 1)``, float32."""
    rs = np.random.RandomState(seed)
    X = rs.uniform(-1, 1, (n, 2)).astype(np.float32)
    Y = np.exp(np.sin(np.pi * X[:, :1]) + X[:, 1:] ** 2).astype(np.float32)
    return X, Y
