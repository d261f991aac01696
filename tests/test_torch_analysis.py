"""The port's kanlint (``repro_torch.analysis``, ``repro_torch.launch.lint``)
held against the reference's (``repro.analysis``) on the CPU.

The shared parts behave alike (pragmas, keys, baselines both ways, KL100,
KL103 on ``np.float64``); each port rule flags its planted violation
through the CLI (``--check --device cpu`` exits 1 and names it), KL102
flags a per-token ``.item()`` loop and passes one batched ``.cpu()`` per
chunk, and the port's own tree gives 0 new findings without importing
JAX.  The card half of KL2xx (plans against the libraries' exports,
``ptxas`` reports) runs in ``chip_smoke.py`` phase 16; its parsing and
budget checks are exercised here on a synthetic report.
"""

from __future__ import annotations

import dataclasses
import textwrap

import pytest

from repro.analysis import ast_rules as ref_rules
from repro.analysis import findings as ref_findings
from repro_torch.analysis import ast_rules, findings, kernel_configs
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import build, ops
from repro_torch.kernels import plan as pl
from repro_torch.launch.lint import main as lint_main

from conftest import run_jax_subprocess


def lint(src: str, path: str = "src/repro_torch/serve/x.py"):
    return ast_rules.lint_source(textwrap.dedent(src), path)


def rules_of(fs) -> list[str]:
    return sorted(f.rule for f in fs)


# ---------------------------------------------------------------------------
# findings: the reference's model, pragmas, keys and baselines
# ---------------------------------------------------------------------------


def test_findings_pragmas_keys_and_baselines_match_the_reference(tmp_path):
    src = ("x = 1  # kanlint: ignore[KL102]\n"
           "y = 2  # kanlint: ignore[KL103, KL201] (a reason)\n"
           "z = 3\n")
    assert findings.file_pragmas(src) == ref_findings.file_pragmas(src) == {
        1: {"KL102"}, 2: {"KL103", "KL201"}}
    fields = ("KL103", "src/repro_torch/models/m.py", 7, "float64 token", "fix it")
    port, ref = findings.Finding(*fields), ref_findings.Finding(*fields)
    assert port.key == ref.key and port.format() == ref.format()
    for save, load in ((findings.save_baseline, ref_findings.load_baseline),
                       (ref_findings.save_baseline, findings.load_baseline)):
        path = tmp_path / "b.json"
        save(str(path), [port if save is findings.save_baseline else ref])
        assert load(str(path)) == {port.key}
    moved = findings.Finding("KL103", fields[1], 99, fields[3], fields[4])
    assert findings.split_baselined([moved], {port.key}) == ([], [moved])
    waived = findings.apply_pragmas([dataclasses.replace(port, line=2)],
                                    {fields[1]: findings.file_pragmas(src)})
    assert waived == []


def test_kl100_is_the_reference_finding():
    src, path = "def f(:\n    pass\n", "src/repro_torch/serve/broken.py"
    port, ref = ast_rules.lint_source(src, path), ref_rules.lint_source(src, path)
    assert [dataclasses.astuple(f) for f in port] == [dataclasses.astuple(f) for f in ref]
    assert rules_of(port) == ["KL100"]


def test_kl103_matches_the_reference_on_np_float64_and_adds_the_torch_tokens():
    src = """
        import numpy as np
        import torch
        a = np.zeros(4, dtype=np.float64)
        b = torch.zeros(4, dtype=torch.float64)
        c = b.double()
        d = torch.ones(2, dtype=torch.double) + numpy.float64(1)
    """
    path = "src/repro_torch/models/x.py"
    port, ref = lint(src, path), ref_rules.lint_source(textwrap.dedent(src), path)
    assert [(f.rule, f.path, f.line) for f in ref] == [("KL103", path, 4), ("KL103", path, 7)]
    assert {(f.rule, f.path, f.line) for f in ref} <= {(f.rule, f.path, f.line) for f in port}
    assert sorted(f.line for f in port) == [4, 5, 6, 7, 7]
    assert lint(src, "src/repro_torch/core/x.py") == []      # host precompute
    assert lint(src, "benchmarks/x.py") == []


# ---------------------------------------------------------------------------
# KL102: host syncs in torch terms
# ---------------------------------------------------------------------------

PER_TOKEN_LOOP = """
    import torch
    from repro_torch.models import lm

    def decode(params, model, tok, caches, pos, steps):
        out = []
        for s in range(steps):
            logits, caches = lm.decode_step(params, model, tok, caches, pos + s)
            nxt = logits.argmax(-1)
            tok = lm.decode_step(params, model, nxt, caches, pos + s)[0]
            out.append(tok.item())
        return out
"""

BATCHED_CHUNK = """
    import torch
    from repro_torch.models import lm

    def decode(params, model, tok, caches, pos, steps):
        toks = []
        for s in range(steps):
            logits, caches = lm.decode_step(params, model, tok, caches, pos + s)
            tok = logits.argmax(-1, keepdim=True)
            toks.append(tok)
        host = torch.cat(toks, dim=1).T.cpu().numpy()
        return host
"""


def test_kl102_flags_a_per_token_item_loop_and_passes_one_batched_read_per_chunk():
    fs = lint(PER_TOKEN_LOOP)
    assert rules_of(fs) == ["KL102"] and fs[0].line == 11
    assert "tok" in fs[0].message and "torch.cat" in fs[0].hint
    assert lint(BATCHED_CHUNK) == []
    assert lint(PER_TOKEN_LOOP, "src/repro_torch/models/x.py") == []    # not a loop module


def test_kl102_resolves_device_methods_step_functions_and_syncs():
    fs = lint("""
        import numpy as np
        import torch
        from repro_torch.models import lm
        from repro_torch.train import step as train_step

        class Engine:
            def _chunk(self, tok, caches):
                lg, caches = lm.decode_step(self.params, self.model, tok, caches, 0)
                return lg, caches

            def _host(self, tok):
                return tok.cpu().numpy()

            def run(self, tok, caches):
                lg, caches = self._chunk(tok, caches)
                a = np.asarray(lg)                                  # 17: read
                b = self._host(tok)
                c = np.asarray(b)                                   # host value
                lg = torch.zeros(2)
                d = float(lg[0])                                    # reassigned: clear
                e = [x.cpu() for x in (caches, tok)]                # 22: read
                torch.cuda.synchronize()                            # 23: sync
                return lg.item()                                    # returns are exempt

        def train(params, opt, batch, steps):
            step = train_step.make_train_step(None, None)
            for _ in range(steps):
                params, opt, metrics = step(params, opt, batch)
                loss = float(metrics["loss"])                       # 30: read
            return loss
    """)
    assert [(f.rule, f.line) for f in fs] == [("KL102", 17), ("KL102", 22), ("KL102", 23),
                                               ("KL102", 30)]
    assert "synchronize" in fs[2].message


def test_kl102_flags_only_the_ports_deliberate_reads_each_waived_with_its_reason():
    """The calibration: in the port's serving and training loops the rule
    flags exactly the reads that carry a pragma with a reason."""
    flagged = {}
    for rel in ("serve/engine.py", "launch/train.py"):
        path = f"src/repro_torch/{rel}"
        src = open(path).read()
        lines = src.splitlines()
        fs = [f for f in ast_rules.lint_source(src, path) if f.rule == "KL102"]
        flagged[rel] = len(fs)
        for f in fs:
            assert "kanlint: ignore[KL102] (" in lines[f.line - 1], lines[f.line - 1]
        assert findings.apply_pragmas(fs, {path: findings.file_pragmas(src)}) == []
    assert flagged == {"serve/engine.py": 2, "launch/train.py": 3}


# ---------------------------------------------------------------------------
# KL2xx: launch plans against the card's budgets
# ---------------------------------------------------------------------------


def test_registry_covers_every_library_and_its_plans_fit_the_h100():
    assert set(ops.KERNELS) == set(build.LIBRARIES)
    assert all(f"{n}_plan" in exports for n, (_, exports) in build.LIBRARIES.items())
    assert kernel_configs.validate_registry() == []


def test_plans_follow_the_launchers_formulas_at_the_main_shapes():
    """Values the .cu sources state or imply at PERF.md's shapes."""
    from repro_torch.kernels import bspline_lut, kan_fused_gemm, kan_int8_gemm
    from repro_torch.kernels import kan_sparse_gemm, paged_gather

    f = kan_fused_gemm.launch_plan(512, 512, 1024, 8, 3, per_sm=1)
    assert (f.threads, f.smem, f.extra[:2], f.grid[:2]) == (512, 147456, (256, 4), (4, 4))
    assert f.template == ("float", "float", 3, 256, True) and f.grid[2] == 8
    bf = kan_fused_gemm.launch_plan(512, 512, 1024, 8, 3, dtype="bfloat16", per_sm=1)
    assert bf.template[:2] == ("__nv_bfloat16", "__nv_bfloat16") and bf.smem == 92160
    s = kan_sparse_gemm.launch_plan(4, 512, 1024, 8, 3)          # 16 tiles x 16 slices of 32
    assert s.grid == (16, 16, 1) and s.extra[1] == 32 and s.vec == 16
    s8 = kan_sparse_gemm.int8_launch_plan(8, 784, 64, 13, 3)    # 49 blocks of 16 inputs
    assert s8.grid == (1, 49, 1) and s8.extra[1] == 16
    i8 = kan_int8_gemm.launch_plan(2048, 2810, 512, 5, 3, per_sm=2)
    assert i8.threads == 256 and i8.extra[:2] == (128, 25) and i8.grid[:2] == (4, 32)
    shadow = [dict(block_bytes=32768, n_blocks=97, layers=8, elem_bytes=4, align=16)] * 2
    assert paged_gather.launch_plan(shadow, 8, 12).grid == (96, 4, 16)
    assert bspline_lut.launch_plan(2048 * 784, 256, 3).smem == 2048
    assert kan_sparse_gemm.launch_plan(4, 512, 1024, 8, 3, align=2).error == pl.MISALIGNED_ADDRESS
    assert kan_fused_gemm.launch_plan(4, 512, 512, 65, 3).error == pl.INVALID_VALUE


def _planted(rule: str) -> dict:
    reg = dict(ops.KERNELS)
    fused = dict(reg["kan_fused_gemm"])
    real = fused["plan"]
    if rule == "KL204":                      # a registered library that is not built
        reg["kan_tiled_gemm"] = dict(fused)
        return reg
    bad = {"KL201": dict(smem=240000, grant=240000),       # over 232,448 B
           "KL202": dict(rows=((16, 1000),)),               # 16-byte reads, 1000-byte rows
           "KL203": dict(grid=(4, 70000, 1))}[rule]         # grid.y over 65,535
    fused["plan"] = lambda **kw: dataclasses.replace(real(**kw), **bad)
    reg["kan_fused_gemm"] = fused
    return reg


@pytest.mark.parametrize("rule", ["KL201", "KL202", "KL203", "KL204"])
def test_cli_planted_launch_budget_violation_fails_check(rule, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(ops, "KERNELS", _planted(rule))
    empty = tmp_path / "empty"
    empty.mkdir()
    rc = analysis_main(["--check", "--device", "cpu", str(empty),
                        "--baseline", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert rule in out and "the card half of KL2xx did not run" in out


def test_grant_below_the_need_is_a_kl201_finding():
    entry = ops.KERNELS["kan_sparse_int8_gemm"]
    problem = dict(BS=8, K=784, N=64, M=13, P=3)
    plan = entry["plan"](**problem)
    args = dict(path="p", line=1)
    assert kernel_configs.check_plan("x", entry, problem, plan, **args) == []
    ungranted = dataclasses.replace(plan, smem=49152, grant=0)   # 48 KB + last_s
    fs = kernel_configs.check_plan("x", entry, problem, ungranted, **args)
    assert rules_of(fs) == ["KL201"] and "granted 0 B" in fs[0].message


NS = "_ZN50_GLOBAL__N__0371cf30_17_kan_fused_gemm_cu_ce126674"     # as nvcc 12.8 names it
PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{NS}16kan_fused_kernelI13__nv_bfloat16S1_Li3ELi256ELb1EEEvPKT_PKT0_S7_PfPjPS2_iiiiiiff' for 'sm_90a'
ptxas info    : Function properties for {NS}16kan_fused_kernelI13__nv_bfloat16S1_Li3ELi256ELb1EEEvPKT_PKT0_S7_PfPjPS2_iiiiiiff
    8 bytes stack frame, 8 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size, 16 bytes smem
ptxas info    : Compile time = 37.759 ms
ptxas info    : Compiling entry function '{NS}16kan_fused_kernelIffLi1ELi64ELb0EEEvPKT_PKT0_S6_PfPjPS0_iiiiiiff' for 'sm_90a'
ptxas info    : Function properties for {NS}16kan_fused_kernelIffLi1ELi64ELb0EEEvPKT_PKT0_S6_PfPjPS0_iiiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16 bytes smem
"""


def test_ptxas_report_gives_each_instantiation_its_registers_spills_and_threads():
    entry = ops.KERNELS["kan_fused_gemm"]
    assert kernel_configs.template_args("_ZN12_GLOBAL__N_119paged_gather_kernelENS_6LeavesEPKi",
                                        "paged_gather_kernel") == ()
    assert kernel_configs.template_args(
        "_ZN12_GLOBAL__N_122kan_sparse_int8_kernelILi2ELb0EEEvPKi", "kan_sparse_int8_kernel"
    ) == (2, False)
    fs, recs = kernel_configs.check_ptxas("kan_fused_gemm", entry, PTXAS, path="k.cu")
    spill = recs[("__nv_bfloat16", "__nv_bfloat16", 3, 256, True)]     # S1_: the bf16 again
    assert (spill["registers"], spill["threads"], spill["smem"], spill["spill_stores"],
            spill["spill_loads"]) == (128, 512, 16, 8, 20)
    assert recs[("float", "float", 1, 64, False)]["threads"] == 128
    assert fs == []          # 128 x 512 and 255 x 128 fit 65536; the spill is its record
    fs, _ = kernel_configs.check_ptxas(
        "kan_fused_gemm", entry, PTXAS.replace("Used 128", "Used 200"), path="k.cu")
    assert rules_of(fs) == ["KL201"] and "200 registers x 512 threads" in fs[0].message
    grown = PTXAS.replace("20 bytes spill loads", "400 bytes spill loads")
    fs, _ = kernel_configs.check_ptxas("kan_fused_gemm", entry, grown, path="k.cu")
    assert rules_of(fs) == ["KL201"] and "400 B loaded" in fs[0].message
    sparse = dict(ops.KERNELS["kan_sparse_gemm"], symbol="kan_fused_kernel")  # no record
    fs, _ = kernel_configs.check_ptxas("kan_sparse_gemm", sparse, PTXAS, path="k.cu")
    assert any("spills 8 B stored, 20 B loaded" in f.message for f in fs)


def test_spills_are_held_to_each_instantiations_own_record():
    """An instantiation recorded at 0 / 0 that starts to spill is a
    finding, though others of its library spill more."""
    entry = ops.KERNELS["kan_fused_gemm"]
    assert max(entry["spills"].values()) > (8, 20)
    assert ("__nv_bfloat16", "__nv_bfloat16", 2, 256, True) not in entry["spills"]
    fs, _ = kernel_configs.check_ptxas("kan_fused_gemm", entry,
                                       PTXAS.replace("S1_Li3ELi256", "S1_Li2ELi256"),
                                       path="k.cu")
    assert rules_of(fs) == ["KL201"]
    assert "kan_fused_kernel<__nv_bfloat16, __nv_bfloat16, 2, 256, true>: spills 8 B stored, " \
           "20 B loaded, above its recorded 0 / 0 B" in fs[0].message


def test_build_keeps_each_librarys_nvcc_log_and_reads_it_back(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_log", {})
    assert build.log_of("paged_gather") == ""
    build._lib_path("paged_gather").with_suffix(".log").write_text("ptxas info    : Used 32")
    assert build.log_of("paged_gather") == "ptxas info    : Used 32"
    assert build.build_log == {"paged_gather": "ptxas info    : Used 32"}


# ---------------------------------------------------------------------------
# the CLIs, in the reference suite's form
# ---------------------------------------------------------------------------

PLANTS = {
    "KL100": ("serve", "def f(:\n    pass\n"),
    "KL102": ("serve", PER_TOKEN_LOOP),
    "KL103": ("models", "import torch\nx = torch.zeros(4, dtype=torch.float64)\n"),
    "KL105": ("models", "def write(caches, x):\n    caches['k'][0] = x\n"),
}


@pytest.mark.parametrize("rule", sorted(PLANTS))
def test_cli_planted_violation_fails_check(rule, tmp_path, capsys):
    sub, src = PLANTS[rule]
    d = tmp_path / sub
    d.mkdir()
    (d / "planted.py").write_text(textwrap.dedent(src))
    rc = analysis_main(["--check", "--device", "cpu", str(d),
                        "--baseline", str(tmp_path / "b.json")])
    out = capsys.readouterr().out
    assert rc == 1, out
    assert rule in out and "1 new finding(s)" in out


KL105_SOURCES = [
    "def write(cache, x, shard=None):\n    pass\n",
    "def write(pool, x):\n    pass\n\n\ndef _helper(caches):\n    pass\n",
    "@torch.no_grad()\ndef step(params, caches, pos):  # kanlint: ignore[KL105] (why)\n"
    "    pass\n\n\ndef read(view):\n    pass\n",
]


@pytest.mark.parametrize("src", KL105_SOURCES)
def test_kl105_matches_the_reference_audit(src):
    """The port's sharding audit flags what the reference's flags, with its
    line and message (pragmas apply afterwards, in both packages alike)."""
    from repro.analysis import sharding_audit as ref_audit
    from repro_torch.analysis import sharding_audit

    path = "src/repro_torch/models/x.py"
    got = sharding_audit.audit_source(src, path)
    want = ref_audit.audit_source(src, path)
    assert [(f.rule, f.line, f.message) for f in got] == \
        [(f.rule, f.line, f.message) for f in want]
    assert sharding_audit.audit_source(src, "src/repro_torch/serve/x.py") == []
    kept = findings.apply_pragmas(got, {path: findings.file_pragmas(src)})
    assert len(kept) == ("def write(pool" in src)


def _cli(module: str, args: list[str]):
    return run_jax_subprocess(argv=["-m", module, *args])


def test_cli_update_baseline_round_trip(tmp_path):
    d = tmp_path / "models"
    d.mkdir()
    (d / "planted.py").write_text(PLANTS["KL103"][1])
    args = [str(d), "--baseline", str(tmp_path / "b.json"), "--device", "cpu",
            "--no-kernel-validator"]
    r1 = _cli("repro_torch.analysis", ["--check", *args, "--update-baseline"])
    assert r1.returncode == 0 and "baseline updated: 1 finding(s)" in r1.stdout, r1.stderr
    r2 = _cli("repro_torch.analysis", ["--check", *args])
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "0 new finding(s), 1 baselined" in r2.stdout
    # the reference reads the port's baseline: same JSON, same keys
    assert ref_findings.load_baseline(str(tmp_path / "b.json")) == {
        f.key for f in ast_rules.lint_source(PLANTS["KL103"][1], _rel(d / "planted.py"))}


def _rel(path) -> str:
    from repro_torch.analysis import _rel as rel
    return rel(str(path))


def test_launch_lint_cli_smoke(tmp_path):
    d = tmp_path / "serve"
    d.mkdir()
    (d / "clean.py").write_text("x = 1\n")
    args = [str(d), "--baseline", str(tmp_path / "b.json"), "--device", "cpu",
            "--no-kernel-validator"]
    r = _cli("repro_torch.launch.lint", args)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[lint] scanned 1 files: 0 new finding(s) (none), 0 baselined" in r.stdout
    (d / "planted.py").write_text(textwrap.dedent(PER_TOKEN_LOOP))
    r = _cli("repro_torch.launch.lint", args)
    assert r.returncode == 1 and "KL102=1" in r.stdout


def test_ports_tree_is_clean_on_the_cpu_without_jax():
    code = ("import sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--check', '--device', 'cpu'])\n"
            "print('loaded', sorted(m for m in sys.modules\n"
            "                       if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
            "sys.exit(rc)\n")
    r = run_jax_subprocess(code=code)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new finding(s), 0 baselined" in r.stdout
    assert "the card half of KL2xx did not run (--device cpu)" in r.stdout
    assert "loaded []" in r.stdout


@pytest.mark.parametrize("cli", [analysis_main, lint_main])
def test_device_cuda_without_a_card_is_a_usage_error(cli, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli(["--check"] if cli is analysis_main else []) == 2
    assert "--device cuda needs a CUDA card" in capsys.readouterr().err
