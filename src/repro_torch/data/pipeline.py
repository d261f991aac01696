"""Synthetic data sets (counterpart of ``repro/data/pipeline.py``).

The container that builds this repository has no downloads, so MNIST is a
class-conditional stand-in and the regression set a symbolic target.  Both
draw from ``np.random.RandomState`` exactly as the reference does, so the
same arguments give byte-equal arrays.  ``lm_batch``, the trainer's token
stream, draws through the threefry port (``serve/threefry.py``), which
gives ``jax.random``'s integers: its tokens equal the reference's.  Every
batch is a function of ``(seed, step)``, so a restart at step N goes on
with the same stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serve import threefry


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


def lm_batch(cfg: LMDataConfig, step: int, device="cpu") -> dict:
    """Markov-chain synthetic tokens: each row starts at a uniform token and
    steps forward by 0-6 modulo the vocabulary -> ``{"tokens", "labels"}``,
    ``(global_batch, seq_len)`` int32 on ``device``; the labels are the
    tokens shifted left, -100 last.  Drawn on the host from
    ``fold_in(PRNGKey(seed), step)``, as the reference's."""
    key = threefry.fold_in(threefry.prng_key(cfg.seed), step)
    k1, k2 = threefry.split(key)
    B, T, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    start = threefry.randint(k1, (B, 1), 0, V)
    steps = threefry.randint(k2, (B, T), 0, 7)
    tokens = ((start + torch.cumsum(steps, dim=1, dtype=torch.int32)) % V).to(torch.int32)
    labels = torch.cat([tokens[:, 1:], tokens.new_full((B, 1), -100)], dim=1)
    return {"tokens": tokens.to(device), "labels": labels.to(device)}


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
