"""Quickstart: fit a KAN to a symbolic function and run every KAN-SAs
datapath on it (paper §II-A, §III).  Counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Fits ``(2, 8, 1)``, G=5, P=3, to ``f(x, y) = exp(sin(pi x) + y^2)`` with
300 steps of plain gradient descent through the differentiable ``dense``
path, then prints the test MSE of ``dense``, ``compact``, ``lut`` (the
B-spline LUT kernel on the card), ``fused`` (the fused KAN kernel on the
card) and the integer-only datapath (``quantized_kan_forward_fused`` per
layer, the int8 kernels on the card).
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.core import kan_layer as KL
from repro_torch.data import pipeline as dp
from repro_torch.examples.mnist_kan import int8_net_apply, quantize_net


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from repro_torch import set_ieee_fp32

        set_ieee_fp32()
    X, Y = (torch.as_tensor(a, device=dev) for a in dp.regression_set(2048, seed=0))
    Xte, Yte = (torch.as_tensor(a, device=dev) for a in dp.regression_set(512, seed=1))
    cfg = KL.KANNetConfig(layers=(2, 8, 1), G=5, P=3)
    params = [{k: t.to(dev) for k, t in p.items()}
              for p in KL.init_kan_net(cfg, seed=0, device="cpu")]

    lr = 0.02
    for i in range(args.steps):
        leaves = [{k: a.detach().requires_grad_(True) for k, a in p.items()} for p in params]
        loss = torch.mean((KL.kan_net_apply(leaves, X, cfg) - Y) ** 2)
        grads = iter(torch.autograd.grad(loss, [a for p in leaves for a in p.values()]))
        with torch.no_grad():
            params = [{k: p[k] - lr * next(grads) for k in p} for p in leaves]
        if i % 50 == 0:
            print(f"step {i:4d} train mse {loss.item():.5f}")

    print("\nKAN-SAs datapaths on the trained model (test MSE):")
    with torch.no_grad():
        for method in ("dense", "compact", "lut", "fused"):
            pred = KL.kan_net_apply(params, Xte, cfg, method=method)
            print(f"  {method:8s} {float(torch.mean((pred - Yte) ** 2)):.5f}")
        h = int8_net_apply(quantize_net(cfg, params), Xte)   # integer-only (paper §V)
        print(f"  int8     {float(torch.mean((h - Yte) ** 2)):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
