"""The device workspace of the kernels that sum K slices across blocks.

One workspace per (device, stream), so that calls ordered on one stream
share it and calls on two streams never do.  It holds the ticket counters
(zero when made, and every launch leaves them zero) and, per kind, one
scratch buffer: fp32 ``partials`` of K slices (any contents; the float
kernels) or int32 ``accumulators`` (zero when made, and every launch
leaves them zero; the int8 kernels).  Counters and scratch are separate
buffers, and each only ever grows.  Each kernel's library exports the
sizes one call needs (``<fn>_tickets(BS, N)`` and ``<fn>_<kind>(BS, K,
N)``).
"""

from __future__ import annotations

import torch

SCRATCH = {"kan_sparse_gemm": ("partials", torch.float32),
           "kan_fused_gemm": ("partials", torch.float32),
           "kan_sparse_int8_gemm": ("accumulators", torch.int32),
           "kan_int8_gemm": ("accumulators", torch.int32)}
_workspaces: dict[tuple[int, int], dict[str, torch.Tensor]] = {}
_sizes: dict[tuple[str, int, int, int, int], tuple[int, int]] = {}


def workspace(lib, fn: str, device: torch.device, stream: int, BS: int, K: int, N: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(tickets, scratch)`` of stream ``stream`` on ``device``, large
    enough for one call of kernel ``fn`` at ``(BS, K, N)``."""
    what, dtype = SCRATCH[fn]
    key = (fn, device.index, BS, K, N)          # a split may follow the SM count
    sizes = _sizes.get(key)
    if sizes is None:
        sizes = _sizes[key] = (
            int(getattr(lib, fn + "_tickets")(BS, N)),
            int(getattr(lib, f"{fn}_{what}")(BS, K, N)))
    n_tickets, n_scratch = sizes
    ws = _workspaces.setdefault((device.index, stream), {})
    if "tickets" not in ws or ws["tickets"].numel() < n_tickets:
        ws["tickets"] = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    if what not in ws or ws[what].numel() < n_scratch:
        ws[what] = torch.zeros(n_scratch, dtype=dtype, device=device)
    return ws["tickets"], ws[what]
