"""Serving and training meshes over ``torch.distributed`` (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``DeviceMesh`` with dims ``("data", "model")`` over a process
group of ``d * m`` ranks, one process per rank.  :func:`run_ranks` starts
the ranks itself (spawned processes meeting at a ``FileStore`` in a
temporary directory); under ``torchrun`` :func:`init_from_env` joins the
launcher's group.  Backends: gloo on the CPU, NCCL with one card per rank,
and gloo for the one-card rehearsal (``share_card``), whose ranks all run
on ``cuda:0`` and stage every collective through the host: a rehearsal of
the mesh's code paths, not a measure of a mesh's speed.

Importing this module starts nothing.  ``make_production_mesh`` (the
reference's 16x16 TPU pod slices) has no counterpart here.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

MESH_DIMS = ("data", "model")
# how long a rank waits on a collective before it gives up
RANK_TIMEOUT = datetime.timedelta(minutes=10)


def parse_mesh_shape(s: str) -> tuple[int, int]:
    """``"2x4"`` -> ``(2, 4)``: the ``--mesh DxM`` flag's format."""
    parts = s.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"--mesh expects DxM (e.g. 2x4), got {s!r}")
    try:
        d, m = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"--mesh expects integers DxM, got {s!r}") from None
    return d, m


def _check_shape(shape) -> tuple[int, int]:
    d, m = int(shape[0]), int(shape[1])
    if d < 1 or m < 1:
        raise ValueError(f"mesh shape must be positive, got {(d, m)}")
    return d, m


def make_host_mesh(shape: tuple[int, int]):
    """The ``(data, model)`` mesh of this process group's ``d * m`` ranks,
    labelled ``cuda`` over NCCL and ``cpu`` over gloo (gloo stages CUDA
    tensors through the host).  The group must hold exactly ``d * m``
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    d, m = _check_shape(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(
            f"host mesh {d}x{m} needs {d * m} ranks in a torch.distributed process group, "
            "and none is initialized: start them with launch.mesh.run_ranks or torchrun")
    n = dist.get_world_size()
    if n != d * m:
        raise ValueError(f"host mesh {d}x{m} needs {d * m} ranks but the process group has "
                         f"{n} ({'too few' if n < d * m else 'too many'})")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (d, m), mesh_dim_names=MESH_DIMS)


def backend(device: str, share_card: bool = False) -> str:
    """gloo on the CPU and for ranks that share one card; NCCL otherwise."""
    return "nccl" if torch.device(device).type == "cuda" and not share_card else "gloo"


def devices_missing(shape: tuple[int, int], device: str, share_card: bool = False) -> str | None:
    """Why this machine cannot hold the mesh's ranks, or None: on CUDA each
    rank needs its own card unless ``share_card``.  A mesh never moves to
    the CPU by itself."""
    d, m = _check_shape(shape)
    if torch.device(device).type != "cuda":
        return None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return f"mesh {d}x{m} on cuda: no CUDA device is present"
    if not share_card and d * m > n:
        return (f"mesh {d}x{m} needs {d * m} CUDA devices, one per rank, and {n} "
                f"{'is' if n == 1 else 'are'} present (the one-card rehearsal, whose ranks "
                "share cuda:0 over gloo, is asked for explicitly)")
    return None


def _rank_device(rank: int, device: str, share_card: bool, world: int) -> torch.device:
    if torch.device(device).type != "cuda":
        # the ranks share the host's cores: one thread pool each would
        # oversubscribe them many times over
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        return torch.device("cpu")
    index = 0 if share_card else rank
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def _rank_main(rank: int, fn, shape, device, share_card, args, tmp) -> None:
    d, m = shape
    dev = _rank_device(rank, device, share_card, d * m)
    dist.init_process_group(backend(device, share_card), init_method=f"file://{tmp}/store",
                            rank=rank, world_size=d * m, timeout=RANK_TIMEOUT)
    try:
        out = fn(make_host_mesh(shape), dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, shape: tuple[int, int], device: str = "cpu", share_card: bool = False,
              args: tuple = ()) -> list:
    """Run ``fn(mesh, device, *args)`` in ``d * m`` spawned rank processes
    -> each rank's return value, in rank order.  ``fn`` must be importable
    by the children (a module-level function) and its value storable by
    ``torch.save``.  A rank that raises fails the call with its
    traceback."""
    d, m = _check_shape(shape)
    why = devices_missing(shape, device, share_card)
    if why:
        raise ValueError(why)
    with tempfile.TemporaryDirectory(prefix="mesh-") as tmp:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, (d, m), device, share_card, args, tmp), nprocs=d * m,
            join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(d * m)]


def under_torchrun() -> bool:
    """True in a process that ``torchrun`` started."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def join_from_env(device: str, share_card: bool = False) -> torch.device:
    """Join ``torchrun``'s process group -> this rank's device (its card is
    ``LOCAL_RANK``'s)."""
    dev = _rank_device(int(os.environ.get("LOCAL_RANK", 0)), device, share_card,
                       int(os.environ["WORLD_SIZE"]))
    dist.init_process_group(backend(device, share_card), timeout=RANK_TIMEOUT)
    return dev


def init_from_env(shape: tuple[int, int], device: str, share_card: bool = False):
    """Join ``torchrun``'s process group -> ``(mesh, device)`` of this rank."""
    dev = join_from_env(device, share_card)
    return make_host_mesh(shape), dev
