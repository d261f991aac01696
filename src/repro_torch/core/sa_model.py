"""Analytical weight-stationary systolic-array model (paper §IV-V).

A copy of ``repro/core/sa_model.py`` (numpy only), so that the port needs
nothing of the JAX package; its numbers are held equal to the reference's
(``tests/test_torch_apps.py``).  ``resnet18_convkan_gemms`` gives the
ResKAN18 layer shapes that ``chip_smoke.py`` runs through ConvKAN.

The paper evaluates KAN-SAs with Synopsys DC on 28nm FD-SOI; we cannot run
synthesis here, so this module provides a calibrated analytical model of the
two arrays whose constants are the paper's own published numbers:

* Table I      — post-synthesis delay (ns) and power (mW) per PE for sparsity
                 patterns 1:1, 1:2, 2:4, 2:6, 4:6, 4:8 (8-bit in, 32-bit acc,
                 500 MHz target);
* §V-B         — B-spline unit area = 450 um^2 (1-cycle tabulated lookup);
                 FPMax FP32 FMA = 0.0081 mm^2, latency 4 (ArKANe PE proxy);
* Fig 7/8      — calibration areas: 16x16 KAN-SAs (4:8) = 0.47 mm^2 and
                 32x32 scalar SA = 0.50 mm^2.

The reference validates the model's predictions against every headline
claim of the paper in its ``benchmarks/`` (Table I normalized energy, the 30% / 99.25% MNIST-KAN
utilizations, the 39.9% average utilization gain, the ~50% cycle reduction,
and the 72x ArKANe comparison).

Cycle/utilization semantics (verified to reproduce Fig 8 exactly): a KAN
GEMM with input (BS, K), basis size M = G+P, N = P+1 non-zeros and output
width N_out maps onto an RxC weight-stationary array as

* conventional (scalar PE): the dense B matrix has K*M rows ->
  ``ceil(K*M/R) * ceil(N_out/C)`` tiles, BS streaming cycles per tile; every
  PE-cycle is a MAC slot but only the non-zero B values are useful ->
  utilization ~ N/M x tiling losses (paper §IV-A: "reduced to 30%").
* KAN-SAs (N:M vector PE): one vector row per input feature ->
  ``ceil(K/R) * ceil(N_out/C)`` tiles, each PE-cycle offers N useful lanes ->
  utilization ~ 100% x tiling losses; cycles drop by (G+P)x per row-pass
  (paper §V-A: "the 1:1 PE takes (G+P) times more cycles").
* MLP/base-term GEMMs (Eq. 1 second term, or any conventional DNN layer):
  scalar rows = K; the N:M PE packs N dense rows per vector row
  (paper §V-C: "(RxN, C) tiles of non-KAN workloads").
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# --------------------------- paper constants -------------------------------

# Table I: (N, M) -> (delay ns, power mW)
TABLE_I = {
    (1, 1): (1.02, 0.35),
    (1, 2): (1.05, 0.40),
    (2, 4): (1.15, 0.62),
    (2, 6): (1.19, 0.77),
    (4, 6): (1.28, 0.98),
    (4, 8): (1.31, 1.12),
}
TABLE_I_NORM_ENERGY = {
    (1, 1): 1.00, (1, 2): 0.57, (2, 4): 0.44,
    (2, 6): 0.37, (4, 6): 0.47, (4, 8): 0.40,
}

BSPLINE_UNIT_AREA_UM2 = 450.0          # §V-B
FPMAX_FMA_AREA_MM2 = 0.0081            # §V-B (FPMax [24])
FPMAX_FMA_LATENCY = 4                  # §V-B
CAL_KANSAS_16x16_MM2 = 0.47            # Fig 8 caption
CAL_SCALAR_32x32_MM2 = 0.50            # Fig 8 caption
FREQ_HZ = 500e6

# Calibrated per-PE areas (um^2): array area = R*C*a_pe + R*a_bspline.
_A_SCALAR_UM2 = (CAL_SCALAR_32x32_MM2 * 1e6 - 32 * BSPLINE_UNIT_AREA_UM2) / (32 * 32)
_A_NM_48_UM2 = (CAL_KANSAS_16x16_MM2 * 1e6 - 16 * BSPLINE_UNIT_AREA_UM2) / (16 * 16)


def _fit_power() -> tuple[float, float, float]:
    """Least-squares p(N, M) = a + b*N + c*M over Table I."""
    pts = np.array([[1, n, m] for (n, m) in TABLE_I])
    pw = np.array([TABLE_I[k][1] for k in TABLE_I])
    coef, *_ = np.linalg.lstsq(pts.astype(float), pw, rcond=None)
    return tuple(coef)  # type: ignore[return-value]


_PW_COEF = _fit_power()


def pe_power_mw(N: int, M: int) -> float:
    """Table I power, exact where published, fitted elsewhere."""
    if (N, M) in TABLE_I:
        return TABLE_I[(N, M)][1]
    a, b, c = _PW_COEF
    return float(a + b * N + c * M)


def pe_delay_ns(N: int, M: int) -> float:
    if (N, M) in TABLE_I:
        return TABLE_I[(N, M)][0]
    # Adder tree depth grows with log N, mux with log M (paper §V-A).
    pts = np.array([[1, math.log2(n), math.log2(m)] for (n, m) in TABLE_I])
    d = np.array([TABLE_I[k][0] for k in TABLE_I])
    coef, *_ = np.linalg.lstsq(pts, d, rcond=None)
    return float(coef[0] + coef[1] * math.log2(N) + coef[2] * math.log2(M))


def pe_area_um2(N: int, M: int) -> float:
    """Power-proxy area scaling, calibrated on the two published array areas.

    area(N,M) = a_scalar * (p(N,M)/p(1,1))^gamma with gamma fit so that
    area(4,8) matches the Fig-8 16x16 KAN-SAs calibration point.
    """
    if N == 1 and M == 1:
        return _A_SCALAR_UM2
    ratio_cal = _A_NM_48_UM2 / _A_SCALAR_UM2
    pow_cal = pe_power_mw(4, 8) / pe_power_mw(1, 1)
    gamma = math.log(ratio_cal) / math.log(pow_cal)
    return _A_SCALAR_UM2 * (pe_power_mw(N, M) / pe_power_mw(1, 1)) ** gamma


# ------------------------------- workloads ---------------------------------


@dataclasses.dataclass(frozen=True)
class GEMMWorkload:
    """One KAN (or MLP) GEMM: (BS, K) @ (K*, N_out) with basis (G, P).

    ``kan=True`` means the left matrix is B-spline activations B
    (K* = K*(G+P), density (P+1)/(G+P)); ``kan=False`` is a dense MLP GEMM.
    """

    name: str
    BS: int
    K: int
    N_out: int
    G: int = 5
    P: int = 3
    kan: bool = True

    @property
    def M(self) -> int:
        return self.G + self.P

    @property
    def N(self) -> int:
        return self.P + 1

    @property
    def useful_macs(self) -> float:
        nnz = self.N if self.kan else 1
        return float(self.BS) * self.K * nnz * self.N_out


@dataclasses.dataclass(frozen=True)
class SAConfig:
    R: int
    C: int
    kind: str = "scalar"    # "scalar" | "nm"
    N: int = 4              # vector lanes (N:M PEs only)
    M: int = 8

    def area_mm2(self) -> float:
        if self.kind == "scalar":
            a = self.R * self.C * _A_SCALAR_UM2
        else:
            a = self.R * self.C * pe_area_um2(self.N, self.M)
        return (a + self.R * BSPLINE_UNIT_AREA_UM2) / 1e6

    def power_mw(self) -> float:
        p = pe_power_mw(1, 1) if self.kind == "scalar" else pe_power_mw(self.N, self.M)
        return self.R * self.C * p


@dataclasses.dataclass(frozen=True)
class SAResult:
    cycles: float
    useful_macs: float
    mac_slots: float

    @property
    def utilization(self) -> float:
        return self.useful_macs / self.mac_slots


def run_workload(sa: SAConfig, wl: GEMMWorkload, fill_drain: bool = False) -> SAResult:
    """Map one GEMM onto the array; returns cycles + utilization.

    ``fill_drain`` adds the (R + C - 1) systolic pipeline fill/drain per tile
    pass (runtime plots); the paper's utilization metric excludes it (the
    model then reproduces Fig 8's 99.25% MNIST-KAN figure exactly).
    """
    if sa.kind == "scalar":
        rows = wl.K * wl.M if wl.kan else wl.K
        lanes = 1
    else:
        if wl.kan and wl.N > sa.N:
            raise ValueError(
                f"array lanes N={sa.N} cannot host P+1={wl.N} non-zeros"
            )
        # One vector row per feature for KAN; N dense rows packed otherwise.
        rows = wl.K if wl.kan else math.ceil(wl.K / sa.N)
        lanes = sa.N
    row_tiles = math.ceil(rows / sa.R)
    col_tiles = math.ceil(wl.N_out / sa.C)
    per_tile = wl.BS + (sa.R + sa.C - 1 if fill_drain else 0)
    cycles = row_tiles * col_tiles * per_tile
    slots = sa.R * sa.C * lanes * cycles
    return SAResult(cycles=float(cycles), useful_macs=wl.useful_macs, mac_slots=float(slots))


def run_suite(
    sa: SAConfig, workloads: list[GEMMWorkload], fill_drain: bool = False
) -> SAResult:
    """Aggregate utilization/cycles across a workload list (paper Figs 7-8
    average; utilization aggregates as total-useful / total-slots)."""
    res = [run_workload(sa, w, fill_drain) for w in workloads]
    return SAResult(
        cycles=float(sum(r.cycles for r in res)),
        useful_macs=float(sum(r.useful_macs for r in res)),
        mac_slots=float(sum(r.mac_slots for r in res)),
    )


def normalized_energy(N: int, M: int) -> float:
    """Table I 'Normalized Energy': an N:M PE finishes a typical KAN workload
    in (G+P)=M-fold fewer cycles than the scalar PE at the power of Table I.

    E_norm = (p(N,M)/p(1,1)) * (1/M) — reproduces the published row exactly.
    """
    return pe_power_mw(N, M) / pe_power_mw(1, 1) / M


# --------------------------- ArKANe comparison -----------------------------


def arkane_cycles(n_inputs: int, G: int, P: int) -> float:
    """Paper §V-B: (P+1)*PE_latency + G + P - 1 + n_inputs."""
    return (P + 1) * FPMAX_FMA_LATENCY + G + P - 1 + n_inputs


def kansas_bspline_cycles(n_inputs: int, n_units: int) -> float:
    """Tabulated units: 1 cycle per input per unit, n_units in parallel."""
    return math.ceil(n_inputs / n_units)


def arkane_equiv_units(P: int = 3) -> int:
    """How many 450 um^2 B-spline units fit in ArKANe's (P+1) FMA area."""
    return int((P + 1) * FPMAX_FMA_AREA_MM2 * 1e6 // BSPLINE_UNIT_AREA_UM2)


# --------------------------- Table II workloads ----------------------------


def _mlp_chain(name, layers, G, P, BS, kan=True):
    return [
        GEMMWorkload(f"{name}.l{i}", BS, layers[i], layers[i + 1], G, P, kan)
        for i in range(len(layers) - 1)
    ]


def resnet18_convkan_gemms(G: int = 3, P: int = 3, img: int = 32, BS: int = 1):
    """ResKAN18: the 20 conv layers of ResNet-18 as im2col KAN GEMMs
    (paper Table II; CIFAR-10 stem). BS folds batch x output positions."""
    shapes = [("conv1", 3, 64, 3, img // 1)]
    cfg = [(64, 64)] * 4 + [(64, 128)] + [(128, 128)] * 3 + \
          [(128, 256)] + [(256, 256)] * 3 + [(256, 512)] + [(512, 512)] * 3
    spatial = [img] * 5 + [img // 2] * 4 + [img // 4] * 4 + [img // 8] * 4
    for i, ((cin, cout), s) in enumerate(zip(cfg, spatial)):
        shapes.append((f"conv{i+2}", cin, cout, 3, s))
    # three 1x1 downsample convs
    for i, (cin, cout, s) in enumerate([(64, 128, img // 2), (128, 256, img // 4), (256, 512, img // 8)]):
        shapes.append((f"down{i}", cin, cout, 1, s))
    return [
        GEMMWorkload(f"ResKAN18.{n}", BS * s * s, cin * k * k, cout, G, P, True)
        for (n, cin, cout, k, s) in shapes
    ]


def paper_workloads(BS: int = 64, fixed_gp: tuple[int, int] | None = None):
    """The Table II application suite. ``fixed_gp`` overrides per-app (G, P)
    as in Fig 7 ('parameters are fixed as ... G=5 and P=3')."""
    def gp(g, p):
        return fixed_gp if fixed_gp is not None else (g, p)

    apps: dict[str, list[GEMMWorkload]] = {}
    apps["5G-STARDUST"] = _mlp_chain("5G", [168, 40, 40, 40, 24], *gp(5, 3), BS)
    apps["Catch22-KAN"] = _mlp_chain("Catch22", [22, 10], *gp(3, 3), BS)
    apps["CF-KAN"] = sum(
        (_mlp_chain(f"CF{x}", [x, 512, x], *gp(2, 3), BS) for x in (2810, 34395, 6969)),
        [],
    )
    apps["U-KAN"] = (
        _mlp_chain("UKAN.a", [512, 1024, 512], *gp(5, 3), BS)
        + _mlp_chain("UKAN.b", [512, 512], *gp(5, 3), BS)
    )
    apps["GKAN"] = sum(
        (
            _mlp_chain(f"GKAN{g}{p}", ls, *gp(g, p), BS)
            for ls in ([200, 16, 7], [100, 20, 7])
            for (g, p) in [(2, 1), (3, 2), (3, 3)]
        ),
        [],
    )
    apps["Prefetcher"] = _mlp_chain("Prefetcher", [5, 64, 128], *gp(4, 3), BS)
    apps["MNIST-KAN"] = _mlp_chain("MNIST", [784, 64, 10], *gp(10, 3), BS)
    g, p = gp(3, 3)
    apps["ResKAN18"] = resnet18_convkan_gemms(g, p, BS=max(1, BS // 32))
    return apps
