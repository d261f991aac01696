"""Launch plans: what each CUDA launcher computes before it launches.

Every library in ``csrc/`` exports ``<library>_plan``, which fills
``PLAN_INTS`` ints in the layout of ``kan_common.cuh: PlanField`` (grid,
threads per block, dynamic shared memory, the grant, the vector width, the
instantiation, the SM count and resident blocks per SM a split assumed,
then the kernel's own fields), and its launcher computes its plan with
that export.  Each kernel module mirrors its launcher's formulas in a
Python ``launch_plan`` returning a :class:`Plan`, with the ``.cu`` lines
cited; ``kernels/ops.py: KERNELS`` registers them, and
``repro_torch.analysis.kernel_configs`` checks the plans against the card's
budgets on the CPU and holds them equal to the exports on the card.
"""

from __future__ import annotations

import dataclasses

PLAN_INTS = 16                 # kan_common.cuh: kPlanInts
EXTRA = 10                     # kan_common.cuh: kExtra, the first kernel field

# cudaError_t codes a plan can return
INVALID_VALUE = 1              # cudaErrorInvalidValue
INVALID_CONFIGURATION = 9      # cudaErrorInvalidConfiguration
MISALIGNED_ADDRESS = 716       # cudaErrorMisalignedAddress

# The H100 SXM's budgets (NVIDIA's CUDA documentation, compute capability
# 9.0); the card half of the lint holds them against the device's own
# properties where torch exposes them.
SMS = 132                      # streaming multiprocessors
SMEM_PER_BLOCK_OPTIN = 232448  # 227 KB: dynamic + static shared memory of a block
SMEM_DEFAULT = 49152           # 48 KB: a block's limit without a grant
SMEM_PER_SM = 233472           # 228 KB
SMEM_RESERVED_PER_BLOCK = 1024 # the system's share of each resident block
REGS_PER_BLOCK = 65536
MAX_THREADS_PER_BLOCK = 1024
MAX_THREADS_PER_SM = 2048
MAX_BLOCKS_PER_SM = 32
MAX_GRID_X = 2 ** 31 - 1
MAX_GRID_YZ = 65535


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch as a launcher plans it.  ``template``: the kernel's
    template arguments as ``ptxas`` names them; ``rows``: ``(bytes per
    access, row pitch in bytes)`` of each operand the kernel reads or
    writes in vectors wider than one element; ``error``: the
    ``cudaError_t`` the plan returns instead (then every int is 0)."""

    grid: tuple = (0, 0, 0)
    threads: int = 0
    smem: int = 0
    grant: int = 0
    vec: int = 0
    inst: int = 0
    sms: int = 0
    per_sm: int = 0
    extra: tuple = ()
    template: tuple = ()
    rows: tuple = ()
    error: int = 0

    def ints(self) -> list[int]:
        """The plan in the exports' layout (``PLAN_INTS`` ints)."""
        head = [*self.grid, self.threads, self.smem, self.grant, self.vec, self.inst,
                self.sms, self.per_sm, *self.extra]
        return head + [0] * (PLAN_INTS - len(head))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def occupancy_bound(threads: int, smem: int) -> int:
    """An upper bound on resident blocks per SM (registers unknown off the
    card): the thread, block-slot and shared-memory limits."""
    by_smem = SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)
    return max(1, min(MAX_BLOCKS_PER_SM, MAX_THREADS_PER_SM // threads, by_smem))


def read_export(fn, args: list, decode) -> Plan:
    """Call a ``<library>_plan`` export with ``args`` and read its plan;
    ``decode(inst)`` -> the instantiation's template arguments."""
    import ctypes

    buf = (ctypes.c_int * PLAN_INTS)()
    err = fn(*args, ctypes.addressof(buf))
    v = list(buf)
    return Plan(grid=tuple(v[:3]), threads=v[3], smem=v[4], grant=v[5], vec=v[6], inst=v[7],
                sms=v[8], per_sm=v[9], extra=tuple(v[EXTRA:]),
                template=() if err else decode(v[7]), error=err)


def same(a: Plan, b: Plan) -> bool:
    """Equal as the exports see them: error, every int, the template."""
    return a.error == b.error and a.ints() == b.ints() and (
        a.error != 0 or a.template == b.template)


def dtype_name(code: int) -> str:
    """A KAN kernel's dtype code (0 float32, 1 bfloat16) as ptxas names
    the C++ type."""
    return ("float", "__nv_bfloat16")[code]


DTYPE_CODES = {"float32": 0, "bfloat16": 1}
ESIZE = {"float32": 4, "bfloat16": 2, "int8": 1}
