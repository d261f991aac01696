"""The bytes each CUDA kernel instantiation of the port spills, per thread
(stores, loads), as ``ptxas -v`` reports them for ``sm_90a`` with CUDA 12.8
and ``build.py``'s flags: library -> template arguments (as
``repro_torch.analysis.kernel_configs.template_args`` reads them from the
mangled name) -> (stores, loads).  An instantiation that is not listed
spills nothing.

The kernel-config lint (KL201, on the card) fails an instantiation that
spills more than its own record here, so a new spill, or a larger one,
is a finding; a redesign that cuts a spill lowers its record.
``chip_smoke.py`` phase 16 prints every spill the build reports.
"""

from __future__ import annotations

SPILLS: dict[str, dict[tuple, tuple[int, int]]] = {
    "kan_fused_gemm": {
        ("__nv_bfloat16", "__nv_bfloat16", 1, 64, False): (64, 248),
        ("__nv_bfloat16", "__nv_bfloat16", 1, 64, True): (16, 80),
        ("__nv_bfloat16", "__nv_bfloat16", 3, 128, False): (16, 36),
        ("__nv_bfloat16", "__nv_bfloat16", 3, 128, True): (8, 20),
        ("__nv_bfloat16", "__nv_bfloat16", 3, 256, True): (8, 20),
        ("__nv_bfloat16", "__nv_bfloat16", 3, 64, False): (12, 20),
        ("__nv_bfloat16", "__nv_bfloat16", 3, 64, True): (8, 20),
        ("__nv_bfloat16", "float", 1, 128, False): (56, 88),
        ("__nv_bfloat16", "float", 1, 128, True): (52, 68),
        ("__nv_bfloat16", "float", 1, 256, True): (52, 68),
        ("__nv_bfloat16", "float", 1, 64, False): (108, 300),
        ("__nv_bfloat16", "float", 1, 64, True): (108, 300),
        ("__nv_bfloat16", "float", 2, 128, False): (56, 88),
        ("__nv_bfloat16", "float", 2, 128, True): (56, 72),
        ("__nv_bfloat16", "float", 2, 256, True): (56, 72),
        ("__nv_bfloat16", "float", 2, 64, False): (56, 72),
        ("__nv_bfloat16", "float", 2, 64, True): (56, 72),
        ("__nv_bfloat16", "float", 3, 128, False): (68, 144),
        ("__nv_bfloat16", "float", 3, 128, True): (44, 140),
        ("__nv_bfloat16", "float", 3, 256, True): (44, 140),
        ("__nv_bfloat16", "float", 3, 64, False): (44, 140),
        ("__nv_bfloat16", "float", 3, 64, True): (44, 140),
        ("float", "__nv_bfloat16", 1, 64, False): (68, 236),
        ("float", "__nv_bfloat16", 1, 64, True): (16, 80),
        ("float", "__nv_bfloat16", 3, 128, False): (8, 16),
        ("float", "__nv_bfloat16", 3, 64, False): (12, 20),
        ("float", "float", 1, 128, False): (52, 84),
        ("float", "float", 1, 128, True): (48, 64),
        ("float", "float", 1, 256, True): (48, 64),
        ("float", "float", 1, 64, False): (112, 288),
        ("float", "float", 1, 64, True): (112, 288),
        ("float", "float", 2, 128, False): (52, 84),
        ("float", "float", 2, 128, True): (56, 72),
        ("float", "float", 2, 256, True): (56, 72),
        ("float", "float", 2, 64, False): (56, 72),
        ("float", "float", 2, 64, True): (56, 72),
        ("float", "float", 3, 128, False): (60, 124),
        ("float", "float", 3, 128, True): (44, 140),
        ("float", "float", 3, 256, True): (44, 140),
        ("float", "float", 3, 64, False): (44, 140),
        ("float", "float", 3, 64, True): (44, 140),
    },
    "kan_sparse_gemm": {},
    "kan_sparse_int8_gemm": {
        (1, False): (16, 16),
        (1, True): (16, 16),
        (3, False): (20, 28),
    },
    "kan_int8_gemm": {
        (1, 0, 128, True): (84, 88),
        (1, 1, 128, True): (84, 88),
        (1, 2, 128, True): (84, 88),
        (2, 0, 128, True): (84, 88),
        (2, 1, 128, True): (84, 88),
        (2, 2, 128, True): (84, 88),
        (3, 0, 128, True): (84, 88),
        (3, 1, 128, True): (84, 88),
        (3, 2, 128, True): (84, 88),
    },
    "paged_gather": {},
    "bspline_lut": {},
}
