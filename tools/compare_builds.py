#!/usr/bin/env python3
"""The port's CUDA libraries and its continuous decode, in another tree of
the repository (for example the parent commit, unpacked with
``git archive``) beside this one, on one NVIDIA GPU.

    python3 tools/compare_builds.py --other DIR [--reps 3]

1. Builds every library of ``kernels/build.py: LIBRARIES`` from both
   trees' sources with this tree's flags, all ``nvcc`` processes at once,
   and compares each kernel instantiation's ``ptxas -v`` record
   (registers, static shared memory, stack frame, spill stores and loads)
   and its ``cuobjdump -sass`` text between the trees.
2. Times ``kan_sparse_int8_gemm`` at ``chip_smoke.py``'s two decode shapes
   (8 x 784 -> 64, MNIST-KAN layer 1; 8 x 2810 -> 512, CF-KAN layer 1)
   with each tree's library behind this tree's wrapper, in the order
   other, this, this, other, with ``chip_smoke.time_ms``, and holds the
   two libraries' outputs equal bit for bit.
3. Serves the continuous cell (``chip_smoke.py`` phase 6, dense: 16
   requests, 8 slots, chunks of 8 steps, kanformer-100m at full width,
   random weights from seed 0) in one process per tree, each tree's own
   engine and kernels, in the order other, this, this, other: a warm-up
   run, then ``--reps`` runs, each giving its decode ms per step
   (``decode_s`` over the steps) and tok/s.

Prints the card's name and power limit first and one JSON object as the
last line of its output.  Needs a CUDA card and ``nvcc``; builds into
``build/compare_builds/``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "compare_builds"


def log(msg: str) -> None:
    print(msg, flush=True)


def build_tree(build, tree: Path, tag: str) -> dict[str, subprocess.Popen]:
    """Start one ``nvcc`` per library of ``tree``, with this tree's flags."""
    procs = {}
    for name, (src, _) in build.LIBRARIES.items():
        d = OUT / tag
        d.mkdir(parents=True, exist_ok=True)
        cmd = [build.find_nvcc(), *build.ARCH_FLAGS, *build.NVCC_FLAGS,
               *build.SPLIT_COMPILE.get(name, []), "-o", str(d / f"{name}.so"),
               str(tree / "src" / "repro_torch" / "kernels" / "csrc" / src)]
        logf = open(d / f"{name}.log", "w")
        procs[(tag, name)] = (subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT), logf)
    return procs


def sass_by_function(build, so: Path) -> dict[str, list[str]]:
    """Mangled function name -> its SASS instructions, whitespace collapsed."""
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    funcs: dict[str, list[str]] = {}
    current = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            funcs[current] = []
        elif current is not None and line.strip():
            funcs[current].append(" ".join(line.split()))
    return funcs


def keyed(kc, symbol: str, by_mangled: dict) -> dict:
    """Re-key by template arguments (the anonymous namespace's mangled name
    differs between two sources)."""
    out = {}
    for mangled, v in by_mangled.items():
        t = kc.template_args(mangled, symbol)
        if t is not None:
            out[t] = v
    return out


def compare_libraries(build, kc, kernels, other: Path) -> tuple[dict, dict[str, Path]]:
    procs = build_tree(build, other, "other") | build_tree(build, ROOT, "this")
    t0 = time.perf_counter()
    for (tag, name), (proc, logf) in procs.items():
        proc.wait()
        logf.close()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}/{name}:\n"
                               f"{(OUT / tag / f'{name}.log').read_text()[-3000:]}")
    log(f"[compare] built {len(procs)} libraries in {time.perf_counter() - t0:.1f} s")
    result = {}
    for name in build.LIBRARIES:
        symbol = kernels[name]["symbol"]
        rec, sass = {}, {}
        for tag in ("other", "this"):
            rec[tag] = keyed(kc, symbol, kc.parse_ptxas((OUT / tag / f"{name}.log").read_text()))
            sass[tag] = keyed(kc, symbol, sass_by_function(build, OUT / tag / f"{name}.so"))
        insts = sorted(set(rec["other"]) | set(rec["this"]), key=str)
        ptxas_diff = [kc.cxx_name(symbol, t) for t in insts
                      if rec["other"].get(t) != rec["this"].get(t)]
        sass_diff = [kc.cxx_name(symbol, t) for t in insts
                     if sass["other"].get(t) != sass["this"].get(t)]
        spills = {tag: sum(1 for r in rec[tag].values() if r["spill_stores"] or r["spill_loads"])
                  for tag in rec}
        result[name] = {"instantiations": len(insts), "ptxas_differ": ptxas_diff,
                        "sass_differ": sass_diff, "sass_instructions_this":
                        sum(len(v) for v in sass["this"].values()),
                        "spilling_other": spills["other"], "spilling_this": spills["this"]}
        log(f"[compare] {name}: {len(insts)} instantiations; ptxas records differ in "
            f"{len(ptxas_diff)} {ptxas_diff[:4]}; SASS differs in {len(sass_diff)} "
            f"{sass_diff[:4]}; spilling: other {spills['other']}, this {spills['this']}")
    return result, {tag: OUT / tag for tag in ("other", "this")}


def load_variant(build, so: Path, name: str):
    """``so`` with the C signatures of this tree's ``name`` that it exports."""
    handle = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in build.LIBRARIES[name][1].items():
        if hasattr(handle, fn):
            f = getattr(handle, fn)
            f.argtypes, f.restype = argtypes, restype
    return handle


def use_library(build, workspace, name: str, handle) -> None:
    """Make ``handle`` the library the wrapper launches, on zeroed
    workspaces sized afresh."""
    build._loaded[name] = handle
    workspace._sizes.clear()
    for ws in workspace._workspaces.values():
        for t in ws.values():
            t.zero_()


def time_sparse_int8(torch, cs, build, dirs: dict[str, Path]) -> list[dict]:
    from repro_torch.core import quantization as Q
    from repro_torch.core.bspline import SplineGrid
    from repro_torch.kernels import ops, workspace

    name = "kan_sparse_int8_gemm"
    libs = {tag: load_variant(build, d / f"{name}.so", name) for tag, d in dirs.items()}
    cycles_per_ms = cs.spin_cycles_per_ms(torch)
    rows_out = []
    for K, N, G in ((cs.MNIST["layers"][0], cs.MNIST["layers"][1], cs.MNIST["G"]),
                    (cs.CFKAN_L1["K"], cs.CFKAN_L1["N"], cs.CFKAN_L1["G"])):
        rows = 8
        grid = SplineGrid(-1.0, 1.0, G, 3)
        M = grid.n_basis
        qg = Q.QuantizedGrid.make(grid)
        lut8 = torch.as_tensor(Q.build_lut_u8(grid.P, qg.S), device="cuda")
        n_sets = max(1, math.ceil(cs.L2_FLUSH_BYTES / (rows * K * 4 + K * M * N)))
        g = torch.Generator(device="cuda").manual_seed(rows + K)
        sets = []
        for _ in range(n_sets):
            x = torch.rand(rows, K, generator=g, device="cuda") * 2.4 - 1.2
            cq = torch.randint(-127, 128, (K, M, N), generator=g, device="cuda",
                               dtype=torch.int8)
            sets.append((qg.x_quant.quantize(x), cq))
        sc = torch.rand(N, generator=g, device="cuda") * 1e-3
        kw = dict(scale=sc, lut_scale=qg.lut_scale)
        outs, ms = {}, {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            use_library(build, workspace, name, libs[tag])
            outs[tag] = ops.kan_sparse_int8_gemm(sets[0][0], lut8, sets[0][1], grid, **kw)
            ms[tag].append(cs.time_ms(torch, [
                lambda a=a, c=c: ops.kan_sparse_int8_gemm(a, lut8, c, grid, **kw)
                for a, c in sets], cycles_per_ms))
        same = bool(torch.equal(outs["other"], outs["this"]))
        row = {"shape": [rows, K, N], "M": M, "ms_other": ms["other"], "ms_this": ms["this"],
               "bit_equal": same}
        log(f"[time] {name} {rows}x{K}->{N}: other {ms['other'][0]:.4f} / "
            f"{ms['other'][1]:.4f} ms, this {ms['this'][0]:.4f} / {ms['this'][1]:.4f} ms "
            f"(order other, this, this, other); outputs bit-equal {same}")
        if not same:
            raise RuntimeError(f"{name} {rows}x{K}->{N}: the two libraries disagree")
        rows_out.append(row)
    build._loaded.pop(name, None)
    return rows_out


def serve_continuous(tree: Path, reps: int) -> dict:
    """Phase 6's dense continuous run in ``tree``'s own engine (run in a
    process of its own)."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch import set_ieee_fp32
    from repro_torch.configs import kanformer_100m
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    set_ieee_fp32()
    cfg = kanformer_100m.config().model
    params = lm.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    reqs, budgets = cs.continuous_requests(np, cfg.vocab)
    C = cs.CONT
    eng = Engine(params, cfg, ServeConfig(max_seq=C["max_seq"], max_new_tokens=max(budgets),
                                          block_size=C["block_size"]), device="cuda")
    runs = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve_continuous(reqs, slots=C["slots"], chunk_steps=C["chunk_steps"],
                             max_new=budgets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.last_serve_stats
        if i:
            runs.append({"decode_ms_per_step":
                         st["decode_s"] * 1e3 / (st["chunks_run"] * C["chunk_steps"]),
                         "tok_s": st["useful_tokens"] / wall, "chunks": st["chunks_run"]})
    return {"tree": str(tree), "runs": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other tree")
    ap.add_argument("--reps", type=int, default=3, help="timed continuous runs per process")
    ap.add_argument("--serve", default="", help=argparse.SUPPRESS)   # child: one tree's runs
    args = ap.parse_args()
    if args.serve:
        print(json.dumps(serve_continuous(Path(args.serve).resolve(), args.reps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("[compare] no CUDA device", file=sys.stderr)
        return 1
    other = Path(args.other).resolve()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import set_ieee_fp32
    from repro_torch.analysis import kernel_configs as kc
    from repro_torch.kernels import build, ops

    set_ieee_fp32()
    result = {"card": cs.card_line(), "other": str(other)}
    log(f"[compare] {result['card']}")
    result["libraries"], dirs = compare_libraries(build, kc, ops.KERNELS, other)
    result["sparse_int8"] = time_sparse_int8(torch, cs, build, dirs)
    serve = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        tree = other if tag == "other" else ROOT
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--other",
                               str(other), "--serve", str(tree), "--reps", str(args.reps)],
                              capture_output=True, text=True, cwd=str(tree),
                              env={**os.environ, "PYTHONPATH": ""})
        if proc.returncode:
            raise RuntimeError(f"continuous run in {tree} failed:\n{proc.stderr[-3000:]}")
        runs = json.loads(proc.stdout.strip().splitlines()[-1])["runs"]
        serve[tag].extend(runs)
        log(f"[serve] {tag}: decode ms per step "
            f"{[round(r['decode_ms_per_step'], 4) for r in runs]}, tok/s "
            f"{[round(r['tok_s'], 1) for r in runs]}")
    result["continuous"] = serve
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
