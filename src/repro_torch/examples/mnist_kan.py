"""MNIST-KAN [784, 64, 10] (paper Table II, G=10, P=3): train in fp32, then
run the integer-only datapath and report the accuracy drop (paper §V:
96.58 % -> 96.0 % on real MNIST, a drop under 1 pt).

Counterpart of ``benchmarks/quant_accuracy.py`` (:func:`train_mnist_kan`,
:func:`accuracy_fp`, :func:`accuracy_int8`) and ``examples/mnist_kan.py``
(:func:`main`).  MNIST is the synthetic class-conditional stand-in of
``data/pipeline.mnist_like`` (no downloads), so the claim under test is the
fp32 -> int8 gap, not the absolute accuracy.

Training goes through the differentiable ``dense`` path with
``torch.autograd`` and the reference's hand-written Adam; the int8 path
quantises each layer and runs ``quantized_kan_forward_fused`` (the int8
kernels on the card, their plain versions on the CPU).

    PYTHONPATH=src python -m repro_torch.examples.mnist_kan [--steps N] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from repro_torch.core import kan_layer as KL
from repro_torch.core import quantization as Q
from repro_torch.data import pipeline as dp
from repro_torch.serve import threefry

Params = list[dict[str, torch.Tensor]]


def _normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with ``u``
    uniform in ``(-1, 1)``.  The uniforms are the reference's bit for bit;
    ``torch.erfinv`` and XLA's differ by a few ulps (relative 5e-6 in the
    far tails)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return float(np.float32(np.sqrt(2.0))) * torch.erfinv(threefry.uniform(key, shape, lo, 1.0))


def init_kan_net_threefry(cfg: KL.KANNetConfig, seed: int = 0, device="cuda") -> Params:
    """The reference's ``init_kan_net(jax.random.PRNGKey(seed), cfg)``
    draws, made on the CPU through the threefry port and moved to
    ``device``: the same keys and uniforms, normals within a few ulps of
    JAX's.  So a run of the port starts from the weights a run of the
    reference starts from."""
    keys = threefry.split(threefry.prng_key(seed), len(cfg.layers) - 1)
    params = []
    for i in range(len(cfg.layers) - 1):
        K, N = cfg.layers[i], cfg.layers[i + 1]
        lcfg = KL.KANLayerConfig(K, N, cfg.grid(), base=cfg.base)
        k_coef, k_base = threefry.split(keys[i])
        coeff = lcfg.noise_scale * _normal(k_coef, (K, lcfg.grid.n_basis, N)) / \
            math.sqrt(K * (lcfg.grid.P + 1))
        p = {"coeff": coeff.to(device)}
        if lcfg.base:
            p["base_w"] = (_normal(k_base, (K, N)) * math.sqrt(2.0 / K)).to(device)
        params.append(p)
    return params


def loss_fn(params: Params, xb: torch.Tensor, yb: torch.Tensor, cfg: KL.KANNetConfig
            ) -> torch.Tensor:
    """Mean cross-entropy of the ``dense`` path's logits."""
    logp = torch.log_softmax(KL.kan_net_apply(params, xb, cfg), dim=-1)
    return -logp.gather(-1, yb[:, None]).mean()


def adam_step(params: Params, m: Params, v: Params, t: int, xb: torch.Tensor,
              yb: torch.Tensor, cfg: KL.KANNetConfig, lr: float = 3e-3
              ) -> tuple[Params, Params, Params]:
    """One step of the reference's hand-written Adam, as it stands:
    moments 0.9 / 0.99, constant ``/ 0.9999`` corrections, eps 1e-8.  The
    step count ``t`` is taken and not used, as in the reference."""
    del t
    leaves = [{k: a.detach().requires_grad_(True) for k, a in p.items()} for p in params]
    grads = iter(torch.autograd.grad(loss_fn(leaves, xb, yb, cfg),
                                     [a for p in leaves for a in p.values()]))
    with torch.no_grad():
        g = [{k: next(grads) for k in p} for p in leaves]
        m = [{k: 0.9 * mi[k] + 0.1 * gi[k] for k in gi} for mi, gi in zip(m, g)]
        v = [{k: 0.99 * vi[k] + 0.01 * gi[k] * gi[k] for k in gi} for vi, gi in zip(v, g)]
        params = [{k: p[k] - lr * (mi[k] / 0.9999) / (torch.sqrt(vi[k] / 0.9999) + 1e-8) * 1.0
                   for k in p} for p, mi, vi in zip(params, m, v)]
    return params, m, v


def batch_indices(steps: int, bs: int, n: int) -> np.ndarray:
    """The training batches, ``(steps, bs)``: ``np.random.RandomState(0)``
    drawn step by step as the reference draws them."""
    rs = np.random.RandomState(0)
    return np.array([rs.randint(0, n, bs) for _ in range(steps)], np.int64).reshape(steps, bs)


def train_mnist_kan(steps=250, bs=256, lr=3e-3, seed=0, G=10, P=3, layers=(784, 64, 10),
                    device="cuda"):
    """Train MNIST-KAN on 8192 inputs of ``mnist_like(noise=2.4)`` and
    return ``(cfg, params, (Xte, Yte))`` with 2048 test inputs, as the
    reference does.  The start is the reference's own draws from ``seed``
    (:func:`init_kan_net_threefry`): the accuracy moves by about 2 pt
    between seeds, so only the same start makes the port's accuracy
    comparable with the reference's.  Inputs have ``layers[0]`` features
    (784 for MNIST-KAN)."""
    cfg = KL.KANNetConfig(layers=tuple(layers), G=G, P=P)
    params = init_kan_net_threefry(cfg, seed=seed, device=device)
    # noise=2.4 puts the task in the paper's mid-90s accuracy regime, so the
    # int8 gap is stressed (noise=0.7 saturates at 100 %)
    Xtr, Ytr = dp.mnist_like(8192, seed=1, noise=2.4, dim=layers[0])
    Xte, Yte = dp.mnist_like(2048, seed=2, noise=2.4, dim=layers[0])
    xtr = torch.as_tensor(Xtr, device=device)
    ytr = torch.as_tensor(Ytr, dtype=torch.int64, device=device)
    idx = torch.as_tensor(batch_indices(steps, bs, len(Xtr)), device=device)  # one upload
    m = [{k: torch.zeros_like(a) for k, a in p.items()} for p in params]
    v = [{k: torch.zeros_like(a) for k, a in p.items()} for p in params]
    for t in range(steps):
        params, m, v = adam_step(params, m, v, t, xtr[idx[t]], ytr[idx[t]], cfg, lr)
    return cfg, params, (Xte, Yte)


def accuracy(logits: torch.Tensor, Y: np.ndarray) -> float:
    """Top-1 accuracy of ``logits`` against the labels ``Y``."""
    labels = torch.as_tensor(Y, dtype=torch.int64, device=logits.device)
    return float((logits.argmax(-1) == labels).float().mean())


def accuracy_fp(cfg, params: Params, X: np.ndarray, Y: np.ndarray, method: str = "dense"
                ) -> float:
    """fp32 accuracy through ``kan_net_apply(method=...)`` on the
    parameters' device."""
    x = torch.as_tensor(X, device=params[0]["coeff"].device)
    return accuracy(KL.kan_net_apply(params, x, cfg, method=method), Y)


def quantize_net(cfg, params: Params) -> list[Q.QuantizedKANLayer]:
    """Every layer quantised to the int8 datapath, on the parameters' device."""
    return [Q.quantize_kan_layer(p, cfg.grid()) for p in params]


def int8_net_apply(qlayers: list[Q.QuantizedKANLayer], x: torch.Tensor,
                   fused: bool = True) -> torch.Tensor:
    """The integer-only net, tanh between layers: each layer through
    ``quantized_kan_forward_fused`` (the kernels) or, ``fused=False``,
    ``quantized_kan_forward`` (the plain integer path)."""
    forward = Q.quantized_kan_forward_fused if fused else Q.quantized_kan_forward
    h = x
    for i, ql in enumerate(qlayers):
        if i > 0:
            h = torch.tanh(h)
        h = forward(ql, h)
    return h


def accuracy_int8(cfg, params: Params, X: np.ndarray, Y: np.ndarray) -> float:
    """Accuracy of the integer-only datapath on the parameters' device."""
    x = torch.as_tensor(X, device=params[0]["coeff"].device)
    return accuracy(int8_net_apply(quantize_net(cfg, params), x), Y)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        from repro_torch import set_ieee_fp32

        set_ieee_fp32()
    cfg, params, (Xte, Yte) = train_mnist_kan(steps=args.steps, device=args.device)
    acc_fp = accuracy_fp(cfg, params, Xte, Yte)
    acc_q = accuracy_int8(cfg, params, Xte, Yte)
    print("MNIST-KAN [784,64,10] G=10 P=3 (synthetic MNIST stand-in)")
    print(f"  fp32 accuracy : {acc_fp*100:.2f}%   (paper, real MNIST: 96.58%)")
    print(f"  int8 accuracy : {acc_q*100:.2f}%   (paper, real MNIST: 96.0%)")
    print(f"  drop          : {(acc_fp-acc_q)*100:.2f} pts  (paper claim: <1 pt)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
