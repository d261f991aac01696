"""Kernel launch-budget validator (kanlint KL2xx) for the port's CUDA kernels.

Each CUDA launcher computes its grid, its block, its dynamic shared memory
and its split from the problem at run time (``<library>_plan``, which the
launcher itself calls; ``kernels/plan.py``).  A plan that outgrows the
card does not fail on the CPU, where the wrappers run the plain versions:
it fails on the card's first launch at that shape, long after the change
merged (twice so far: a grant of shared memory below the need).  This
validator makes it fail the lint instead, from the Python mirror of every
launcher (``kernels/ops.py: KERNELS``) over a problem suite:

* **KL201 shared memory and registers**: dynamic plus static shared
  memory within the 227 KB a block may opt in to, and a grant of at least
  the dynamic bytes wherever the need exceeds the 48 KB default; on the
  card also registers x threads within the registers of a block, and
  each instantiation's spills no larger than its own record
  (``kernels/spills.py``; 0 where it spilled nothing), from the
  ``ptxas -v`` report of every instantiation.
* **KL202 alignment**: the bytes of each vector access divide the row
  pitch of the operand it reads.
* **KL203 grid fit**: grid.x <= 2^31-1, grid.y and grid.z <= 65,535,
  threads <= 1024 and equal to the instantiation's ``__launch_bounds__``;
  a problem the wrapper admits and the launcher refuses.
* **KL204 coverage and agreement**: every library of ``build.LIBRARIES``
  registered with a ``<library>_plan`` export, every registered library
  built; on the card, every registry plan equal to the library's export on
  every problem of the suite, splits included.

The problem suite is every shape of PERF.md section 6's table (the shapes
the main paths launch at) and each kernel at its admitted extremes.  Off
the card (``--device cpu``) the plans use the H100's SM count and, where a
split asks the occupancy calculator, an upper bound of resident blocks
(``plan.occupancy_bound``); on the card they take the export's SM count
and resident blocks, and the budgets the device reports.

Not ported (ROADMAP.md): the reference's checks of an autotuner's
candidate spaces and measurement cache, which come with the port's tile
autotuner; the CUDA kernels' tiles are fixed today.
"""

from __future__ import annotations

import dataclasses
import os
import re

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import plan as pl

ROWS_EXTREMES = (1, 32768, 2 ** 20)     # one row, ResKAN18's conv rows, 2^20
SPARSE_ROWS = (1, 8)
N_EXTREMES = (10, 64, 256, 4096)
K_EXTREME = 512

# PERF.md section 6's shapes: (BS, K, N, M) at P = 3, fp32 unless said
FUSED_SHAPES = [
    (512, 512, 1024, 8), (512, 1024, 512, 8), (2048, 784, 64, 13), (2048, 64, 10, 13),
    (40, 512, 1024, 8), (40, 1024, 512, 8),
    # ResKAN18's 20 ConvKAN layers (M = 6)
    (32768, 27, 64, 6), (32768, 576, 64, 6), (32768, 576, 128, 6), (8192, 1152, 128, 6),
    (8192, 1152, 256, 6), (2048, 2304, 256, 6), (2048, 2304, 512, 6), (512, 4608, 512, 6),
    (8192, 64, 128, 6), (2048, 128, 256, 6), (512, 256, 512, 6),
]
SPARSE_SHAPES = [
    (4, 512, 1024, 8), (8, 512, 1024, 8), (1, 512, 1024, 8), (8, 1024, 512, 8),
    (8, 784, 64, 13), (8, 64, 10, 13), (40, 512, 1024, 8), (40, 1024, 512, 8),
]
SPARSE_INT8_SHAPES = [(8, 784, 64, 13), (8, 2810, 512, 5)]
INT8_SHAPES = [(2048, 784, 64, 13), (2048, 2810, 512, 5), (8, 784, 64, 13), (8, 2810, 512, 5)]
# the paged pools: (name, [(pool shape, element bytes)], stacked, table (B, L))
GATHER_POOLS = [
    ("shadow k+v", [((8, 97, 16, 8, 64), 4)] * 2, True, (8, 12)),
    ("shadow one leaf", [((8, 97, 16, 8, 64), 4)], True, (8, 12)),
    ("step k+v", [((97, 16, 8, 64), 4)] * 2, False, (8, 12)),
    ("step k+v bf16", [((97, 16, 8, 64), 2)] * 2, False, (8, 12)),
    ("qwen shadow k+v", [((24, 97, 16, 16, 64), 4)] * 2, True, (8, 12)),
    ("qwen shadow int8 KV", [((24, 97, 16, 16, 64), 1)] * 2 + [((24, 97, 16, 16), 4)] * 2,
     True, (8, 12)),
    ("qwen step k+v", [((97, 16, 16, 64), 4)] * 2, False, (8, 12)),
    ("qwen step int8 KV", [((97, 16, 16, 64), 1)] * 2 + [((97, 16, 16), 4)] * 2, False,
     (8, 12)),
    ("olmoe shadow k+v", [((16, 97, 16, 16, 128), 4)] * 2, True, (8, 12)),
    ("olmoe step k+v", [((97, 16, 16, 128), 4)] * 2, False, (8, 12)),
]


def _leaf(shape: tuple, elem_bytes: int, stacked: bool, align: int = 16) -> dict:
    lead = 1 if stacked else 0
    block = elem_bytes
    for d in shape[lead + 1:]:
        block *= d
    return {"block_bytes": block, "n_blocks": shape[lead], "layers": shape[0] if stacked else 1,
            "elem_bytes": elem_bytes, "align": align}


def problem_suite(registry: dict | None = None) -> dict[str, list[dict]]:
    """Library -> problems (``launch_plan`` keyword arguments); a problem
    of PERF.md section 6's table carries ``"main": "<shape>"``."""
    reg = registry if registry is not None else _registry()
    suite: dict[str, list[dict]] = {}

    def kan(name, shapes, rows):
        e = reg[name]
        probs = [dict(BS=BS, K=K, N=N, M=M, P=3, dtype=e["dtypes"][0], main=f"{BS}x{K}->{N}")
                 for BS, K, N, M in shapes]
        for dtype in e["dtypes"]:
            for P in (min(e["P"]), max(e["P"])):
                for BS in rows:
                    for N in N_EXTREMES:
                        probs.append(dict(BS=BS, K=K_EXTREME, N=N, M=e["max_m"], P=P,
                                          dtype=dtype))
        suite[name] = probs

    kan("kan_fused_gemm", FUSED_SHAPES, ROWS_EXTREMES)
    suite["kan_fused_gemm"] += [dict(BS=512, K=512, N=1024, M=8, P=3, dtype="bfloat16",
                                     x_dtype="float32"),
                                dict(BS=512, K=512, N=1024, M=8, P=3, align=4)]
    kan("kan_sparse_gemm", SPARSE_SHAPES, SPARSE_ROWS + ROWS_EXTREMES[1:])
    suite["kan_sparse_gemm"] += [dict(BS=4, K=512, N=1024, M=8, P=3, dtype="bfloat16",
                                      main="4x512->1024 bf16"),
                                 dict(BS=4, K=512, N=1023, M=8, P=3, dtype="bfloat16"),
                                 dict(BS=4, K=512, N=1023, M=8, P=3, dtype="float32")]
    kan("kan_sparse_int8_gemm", SPARSE_INT8_SHAPES, SPARSE_ROWS + ROWS_EXTREMES[1:])
    kan("kan_int8_gemm", INT8_SHAPES, ROWS_EXTREMES)
    for name in ("kan_sparse_int8_gemm", "kan_int8_gemm"):
        for P in (1, 2, 3):                   # the largest ROM the wrappers admit
            S = 16384 // ((P + 2) // 2)
            suite[name].append(dict(BS=8, K=784, N=64, M=13, P=P, dtype="int8", S=S))
    suite["kan_int8_gemm"] += [dict(BS=2048, K=784, N=64, M=13, P=3, dtype="int8", out=out)
                               for out in (1, 2)]
    suite["paged_gather"] = [
        dict(leaves=[_leaf(s, e, stacked) for s, e in leaves], B=B, L=L, main=what)
        for what, leaves, stacked, (B, L) in GATHER_POOLS]
    suite["paged_gather"] += [
        dict(leaves=[_leaf((64, 4097, 16, 16, 128), 2, True)] * reg["paged_gather"]["max_leaves"],
             B=256, L=256),
        dict(leaves=[_leaf((97, 16, 8, 63), 2, False, align=2)], B=8, L=12),
        dict(leaves=[_leaf((97, 16, 8, 64), 1, False)], B=2 ** 16, L=2 ** 14)]
    lut_s = [dict(n=2048 * 784, S=256, P=3, main="2048x784 inputs, S = 256")]
    lut = reg["bspline_lut"]
    for P in lut["P"]:
        for n in (1,) + ROWS_EXTREMES[1:]:
            lut_s.append(dict(n=n, S=lut["max_table_bytes"] // (4 * ((P + 2) // 2)), P=P))
    suite["bspline_lut"] = lut_s
    return suite


@dataclasses.dataclass(frozen=True)
class Limits:
    """The budgets a plan is held to (the H100's; the card's own there)."""
    smem_optin: int = pl.SMEM_PER_BLOCK_OPTIN
    regs_per_block: int = pl.REGS_PER_BLOCK
    max_threads: int = pl.MAX_THREADS_PER_BLOCK


def _registry() -> dict:
    from repro_torch.kernels.ops import KERNELS
    return KERNELS


def _rel(path: str) -> str:
    rel = os.path.relpath(path)
    return (path if rel.startswith("..") else rel).replace(os.sep, "/")


def _line_of(path: str, marker: str) -> int:
    try:
        with open(path) as fh:
            for i, line in enumerate(fh, start=1):
                if marker in line:
                    return i
    except OSError:
        pass
    return 1


def _ops_site() -> tuple[str, int]:
    from repro_torch.kernels import ops
    return _rel(ops.__file__), _line_of(ops.__file__, "KERNELS: dict")


def _describe(name: str, problem: dict) -> str:
    p = {k: v for k, v in problem.items() if k not in ("main", "leaves")}
    if "leaves" in problem:
        p["leaves"] = [(f["block_bytes"], f["layers"], f["elem_bytes"], f["align"])
                       for f in problem["leaves"]]
    return f"{name} {p}"


def _args(problem: dict) -> dict:
    return {k: v for k, v in problem.items() if k != "main"}


def check_plan(name: str, entry: dict, problem: dict, plan: pl.Plan, *, path: str, line: int,
               static_smem: int | None = None, limits: Limits = Limits()) -> list[Finding]:
    """KL201-KL203 for one plan of library ``name`` at ``problem``."""
    what = _describe(name, problem)
    out: list[Finding] = []

    def find(rule, msg, hint):
        out.append(Finding(rule, path, line, f"{what}: {msg}", hint))

    if plan.error:
        find("KL203", f"the launcher refuses a problem the wrapper admits (cudaError_t "
                      f"{plan.error})", "admit only what the launcher takes, or plan it")
        return out
    if plan.grid[0] == 0:                     # nothing to copy: no launch
        return out
    static = entry["static_smem"] if static_smem is None else static_smem
    need = plan.smem + static
    if need > limits.smem_optin:
        find("KL201", f"shared memory {plan.smem} B dynamic + {static} B static exceeds "
                      f"the {limits.smem_optin} B a block may opt in to",
             "shrink the tile or the staging ring")
    if need > pl.SMEM_DEFAULT and plan.grant < plan.smem:
        find("KL201", f"shared memory {need} B exceeds the {pl.SMEM_DEFAULT} B default but "
                      f"the launch is granted {plan.grant} B of the {plan.smem} B dynamic",
             "grant cudaFuncAttributeMaxDynamicSharedMemorySize whenever the need grows")
    for vec, pitch in plan.rows:
        if vec < 1 or pitch % vec:
            find("KL202", f"{vec}-byte accesses to rows {pitch} B apart",
                 "take the vector width only where it divides the row pitch")
    gx, gy, gz = plan.grid
    if not (1 <= gx <= pl.MAX_GRID_X and 1 <= gy <= pl.MAX_GRID_YZ
            and 1 <= gz <= pl.MAX_GRID_YZ):
        find("KL203", f"grid {plan.grid} outside (2^31-1, 65535, 65535)",
             "put the long axis on grid.x, or refuse the problem in the launcher")
    bound = entry["threads"](plan.template)
    if not 1 <= plan.threads <= limits.max_threads or plan.threads != bound:
        find("KL203", f"{plan.threads} threads per block (the instantiation's "
                      f"__launch_bounds__: {bound}; at most {limits.max_threads})",
             "launch the threads the kernel is compiled for")
    return out


def validate_registry() -> list[Finding]:
    """The CPU half: coverage (KL204) and every registry plan over the
    suite at the H100's budgets (KL201-KL203)."""
    from repro_torch.kernels import build

    reg = _registry()
    path, line = _ops_site()
    out: list[Finding] = []
    for name, (_, exports) in build.LIBRARIES.items():
        if name not in reg:
            out.append(Finding("KL204", path, line,
                               f"library '{name}' of build.LIBRARIES is not registered in "
                               f"kernels/ops.py:KERNELS",
                               "add an entry (symbol, dtypes, threads, plan) so its launches "
                               "get validated"))
        elif f"{name}_plan" not in exports:
            out.append(Finding("KL204", path, line,
                               f"library '{name}' exports no '{name}_plan'",
                               "export the launcher's plan and list it in build.LIBRARIES"))
    for name in reg:
        if name not in build.LIBRARIES:
            out.append(Finding("KL204", path, line,
                               f"registered library '{name}' is not in build.LIBRARIES",
                               "register only libraries that are built"))
    suite = problem_suite(reg)
    for name, entry in reg.items():
        if name not in build.LIBRARIES:
            continue
        for problem in suite.get(name, []):
            plan = entry["plan"](**_args(problem))
            out.extend(check_plan(name, entry, problem, plan, path=path, line=line))
    return out


# ---------------------------------------------------------------------------
# the card half: exports, ptxas reports, the device's budgets
# ---------------------------------------------------------------------------

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_BUILTIN = {"f": "float", "d": "double", "i": "int", "j": "unsigned", "b": "bool",
            "h": "unsigned char", "a": "signed char"}


def parse_ptxas(log: str) -> dict[str, dict]:
    """Entry function (mangled) -> ``registers``, ``smem`` (static bytes),
    ``stack``, ``spill_stores``, ``spill_loads`` from a ``ptxas -v`` report."""
    entries: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line) or _PROPS.search(line)
        if m:
            current = m.group(1)
            if _ENTRY.search(line):
                entries.setdefault(current, {"registers": 0, "smem": 0, "stack": 0,
                                             "spill_stores": 0, "spill_loads": 0})
            continue
        if current not in entries:
            continue
        rec = entries[current]
        m = _SPILL.search(line)
        if m:
            rec["stack"], rec["spill_stores"], rec["spill_loads"] = map(int, m.groups())
        m = _USED.search(line)
        if m:
            rec["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            rec["smem"] = int(s.group(1)) if s else 0
    return entries


def template_args(mangled: str, symbol: str) -> tuple | None:
    """The template arguments of ``symbol`` in an Itanium-mangled name
    (builtin types, class names and their substitutions ``S_``, ``S<n>_``,
    integer and bool literals), () for a plain function, None if the name
    is not ``symbol``'s."""
    m = re.search(rf"{len(symbol)}{symbol}", mangled)
    if not m:
        return None
    i = m.end()
    if i >= len(mangled) or mangled[i] != "I":
        return ()
    # substitution candidates: the namespace and the function (nested
    # names), then each class type of the arguments as it first appears
    subs: list = ["<namespace>", symbol] if mangled.startswith("_ZN") else [symbol]
    i += 1
    args: list = []
    while mangled[i] != "E":
        c = mangled[i]
        if c == "L":                                   # L<type><value>E
            j = mangled.index("E", i)
            typ, val = mangled[i + 1], mangled[i + 2:j]
            v = -int(val[1:]) if val.startswith("n") else int(val)
            args.append(bool(v) if typ == "b" else v)
            i = j + 1
        elif c.isdigit():                              # <length><class name>
            k = i
            while mangled[k].isdigit():
                k += 1
            n = int(mangled[i:k])
            args.append(mangled[k:k + n])
            subs.append(args[-1])
            i = k + n
        elif c == "S":                                 # S_ or S<base-36>_
            j = mangled.index("_", i)
            seq = mangled[i + 1:j]
            args.append(subs[int(seq, 36) + 1 if seq else 0])
            i = j + 1
        else:
            args.append(_BUILTIN.get(c, c))
            i += 1
    return tuple(args)


def cxx_name(symbol: str, template: tuple) -> str:
    """``kan_fused_kernel<float, float, 3, 256, true>``."""
    args = ", ".join(str(a).lower() if isinstance(a, bool) else str(a) for a in template)
    return f"{symbol}<{args}>" if template else symbol


def check_ptxas(name: str, entry: dict, log: str, *, path: str,
                limits: Limits = Limits()) -> tuple[list[Finding], dict[tuple, dict]]:
    """KL201 over every instantiation of ``entry``'s kernel in a library's
    ``ptxas`` report -> (findings, template -> record with its threads).
    Each instantiation's spills are held to its own record (``spills``,
    from ``kernels/spills.py``; 0 / 0 where it is not listed), so a new or
    larger spill fails; every spill is reported by name by
    :func:`validate_card`."""
    out: list[Finding] = []
    records: dict[tuple, dict] = {}
    for mangled, rec in parse_ptxas(log).items():
        t = template_args(mangled, entry["symbol"])
        if t is None:
            continue
        rec = dict(rec, threads=entry["threads"](t), mangled=mangled)
        records[t] = rec
        what = cxx_name(entry["symbol"], t)
        line = _line_of(path, "__launch_bounds__")
        if rec["registers"] * rec["threads"] > limits.regs_per_block:
            out.append(Finding("KL201", path, line,
                               f"{what}: {rec['registers']} registers x {rec['threads']} "
                               f"threads exceed the {limits.regs_per_block} of a block",
                               "lower the registers (__launch_bounds__) or the threads"))
        most_st, most_ld = entry["spills"].get(t, (0, 0))
        if rec["spill_stores"] > most_st or rec["spill_loads"] > most_ld:
            out.append(Finding("KL201", path, line,
                               f"{what}: spills {rec['spill_stores']} B stored, "
                               f"{rec['spill_loads']} B loaded, above its recorded "
                               f"{most_st} / {most_ld} B",
                               "cut the live registers; a spill is a local-memory round trip"))
        if pl.cdiv(rec["smem"], 16) * 16 > entry["static_smem"]:
            out.append(Finding("KL201", path, line,
                               f"{what}: {rec['smem']} B of static shared memory, above the "
                               f"{entry['static_smem']} B the registry allows",
                               "raise the registry's static_smem, or cut the static arrays"))
    if not records:
        out.append(Finding("KL204", path, 1, f"no ptxas record of {entry['symbol']} in "
                                             f"{name}'s build log",
                           "build with -Xptxas -v and keep the log (kernels/build.py)"))
    return out, records


def device_limits(torch) -> tuple[Limits, list[Finding]]:
    """The card's budgets, and a KL201/KL203 finding for each constant of
    ``kernels/plan.py`` that disagrees with what torch reports."""
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    path = _rel(pl.__file__)
    out: list[Finding] = []
    got = {}
    for attr, const, rule in (("shared_memory_per_block_optin", pl.SMEM_PER_BLOCK_OPTIN,
                               "KL201"),
                              ("regs_per_multiprocessor", pl.REGS_PER_BLOCK, "KL201"),
                              ("multi_processor_count", pl.SMS, "KL203")):
        v = getattr(props, attr, None)
        if v is None:
            continue
        got[attr] = int(v)
        if int(v) != const:
            out.append(Finding(rule, path, _line_of(pl.__file__, f"= {const}"),
                               f"budget constant {const} differs from the device's {attr} "
                               f"= {int(v)} ({props.name})",
                               "set the constant from the card's data sheet"))
    return Limits(smem_optin=got.get("shared_memory_per_block_optin", pl.SMEM_PER_BLOCK_OPTIN),
                  regs_per_block=got.get("regs_per_multiprocessor", pl.REGS_PER_BLOCK)), out


def validate_card(torch) -> dict:
    """The card half: build and load every library, hold each registry
    plan equal to the export on every problem of the suite, check the
    exports' plans at the card's budgets with the static shared memory
    ``ptxas`` reports, and every instantiation's registers and spills.
    -> ``{"findings": [...], "rows": [...], "plans": int, "spills": [...]}``;
    ``rows``: one per instantiation a main shape takes (registers, static
    and dynamic shared memory at that shape, threads, spills); ``spills``:
    every instantiation that spills, by name."""
    from repro_torch.kernels import build

    reg = _registry()
    suite = problem_suite(reg)
    limits, out = device_limits(torch)
    rows: list[dict] = []
    spills: list[str] = []
    n_plans = 0
    for name, entry in reg.items():
        if name not in build.LIBRARIES:
            continue
        src = os.path.join(os.path.dirname(build.__file__), "csrc", build.LIBRARIES[name][0])
        path = _rel(src)
        try:
            lib = build.load(name)
        except (RuntimeError, OSError, AttributeError) as e:
            out.append(Finding("KL204", path, 1, f"library '{name}' cannot be built or "
                                                 f"loaded: {str(e).splitlines()[0][:200]}",
                               "fix the build; nothing is skipped"))
            continue
        found, records = check_ptxas(name, entry, build.log_of(name), path=path,
                                     limits=limits)
        out.extend(found)
        line = _line_of(src, f"{name}_plan(")
        seen: set[tuple] = set()
        for problem in suite.get(name, []):
            got = entry["plan_export"](lib, **_args(problem))
            want = entry["plan"](**_args(problem), sms=got.sms, per_sm=got.per_sm)
            n_plans += 1
            if not pl.same(want, got):
                out.append(Finding("KL204", path, line,
                                   f"{_describe(name, problem)}: registry plan "
                                   f"{want.ints()} (error {want.error}) differs from the "
                                   f"export's {got.ints()} (error {got.error})",
                                   "mirror the launcher's formulas in the kernel module"))
                continue
            rec = records.get(got.template)
            if got.error == 0 and got.grid[0] and rec is None:
                out.append(Finding("KL204", path, line,
                                   f"{_describe(name, problem)}: no ptxas record of "
                                   f"{cxx_name(entry['symbol'], got.template)}",
                                   "build with -Xptxas -v and keep the log"))
                continue
            static = pl.cdiv(rec["smem"], 16) * 16 if rec else None
            out.extend(check_plan(name, entry, problem, want, path=path, line=line,
                                  static_smem=static, limits=limits))
            if "main" in problem and rec is not None and got.template not in seen:
                seen.add(got.template)
                rows.append({"library": name,
                             "kernel": cxx_name(entry["symbol"], got.template),
                             "shape": problem["main"],
                             "registers": rec["registers"], "threads": rec["threads"],
                             "static_smem": rec["smem"], "dynamic_smem": got.smem,
                             "spill_stores": rec["spill_stores"],
                             "spill_loads": rec["spill_loads"]})
        spills.extend(f"{cxx_name(entry['symbol'], t)}: "
                      f"{r['spill_stores']} B stored, {r['spill_loads']} B loaded"
                      for t, r in records.items() if r["spill_stores"] or r["spill_loads"])
    return {"findings": out, "rows": rows, "plans": n_plans, "spills": spills}
