"""Checkpoints on disk (counterpart of ``repro/checkpoint/store.py``), in
the reference's layout, so that either package restores the other's:

    <dir>/step_<N:08d>/
        manifest.json     (step, keys, shapes, dtypes, extra, done flag)
        arrays.npz        (one array per leaf, keyed by its tree path)

Keys are ``convert.flatten_with_paths``' (``"[0]/['embed']/['table']"``
for a ``(params, opt_state)`` pair), the reference's keys.

* Atomic: a save writes ``step_<N>.tmp``, fsyncs the manifest, and renames
  the directory; a crash mid-write leaves the last checkpoint whole.
* Async: ``AsyncCheckpointer.save_async`` copies the tree to host memory
  (training updates the parameters in place) and writes in a thread.
* Resume: ``latest_step`` is the newest step whose manifest says ``done``;
  partial steps are ignored, and the writer keeps the newest ``keep``.
* ``restore`` puts every leaf on the device asked for, with its stored
  dtype and bits.
* Meshes: a save from a ``(data, model)`` mesh (``shard`` and the spec tree
  of the saved tree, ``ShardingCtx.state_specs``) gathers every leaf whole
  (a collective: every rank calls it), rank 0 writes the layout above, and
  every rank waits until the write is complete; so a checkpoint written on
  any mesh restores unmeshed, in the JAX package, or on another mesh, where
  ``restore(..., shard=..., specs=...)`` returns this rank's slices
  (``launch/elastic.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import types

import numpy as np
import torch

from repro_torch.convert import flatten_with_paths, map_with_paths, tree_map


def _host(tree) -> dict:
    """``{path: numpy array}``: each leaf copied to the host."""
    return {k: v.detach().cpu().numpy() for k, v in flatten_with_paths(tree).items()}


def spec_paths(tree, specs) -> dict:
    """``{path: spec}`` of a spec tree congruent with ``tree`` (a spec is a
    tuple, which the tree helpers would walk into)."""
    boxed = tree_map(lambda _, spec: types.SimpleNamespace(spec=spec), tree, specs)
    return {k: b.spec for k, b in flatten_with_paths(boxed).items()}


def gather_host(tree, shard, specs) -> dict | None:
    """A mesh's shards -> ``{path: whole numpy array}`` on rank 0 (None on
    the others).  A collective: every rank calls it with the same tree.
    Each block is written into zeros by one rank alone (the one at
    coordinate 0 of every mesh axis that does not split its leaf), so one
    packed sum over the whole mesh per ``sharding.BUCKET`` elements puts
    every leaf together exactly."""
    from repro_torch.dist.sharding import BUCKET

    placed = spec_paths(tree, specs)
    first = shard.mesh.get_rank() == 0
    host, batch, n = {}, [], 0

    def flush():
        shard.sum_over_mesh([w for _, w in batch])
        if first:
            host.update((k, w.cpu().numpy()) for k, w in batch)

    for k, x in flatten_with_paths(tree).items():
        spec = placed[k]
        whole = x.new_zeros(shard.whole_shape(tuple(x.shape), spec))
        if shard.owns(spec):
            shard.block(whole, spec).copy_(x.detach())
        if batch and n + whole.numel() > BUCKET:
            flush()
            batch, n = [], 0
        batch.append((k, whole))
        n += whole.numel()
    flush()
    return host if first else None


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None, shard=None,
         specs=None) -> str:
    """Write ``tree`` as step ``step`` -> the step's directory; from a mesh
    (``shard``, ``specs``) every rank calls it and rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if shard is None:
        _write(final, step, _host(tree), extra)
        return final
    host = gather_host(tree, shard, specs)
    if host is not None:
        _write(final, step, host, extra)
    shard.barrier()
    return final


def _write(final: str, step: int, host: dict, extra: dict | None) -> None:
    os.makedirs(os.path.dirname(final), exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "keys": sorted(host.keys()),
        "shapes": {k: list(v.shape) for k, v in host.items()},
        "dtypes": {k: str(v.dtype) for k, v in host.items()},
        "extra": extra or {},
        "done": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


class AsyncCheckpointer:
    """Snapshot on call, write in the background; ``wait()`` joins the
    writer.  On a mesh (``shard``, ``specs``: the saved tree's spec tree)
    every rank calls both at the same steps: the snapshot gathers every
    leaf whole, rank 0 writes, and ``wait()`` returns on every rank once
    the write is complete."""

    def __init__(self, ckpt_dir: str, keep: int = 3, shard=None, specs=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.shard, self.specs = shard, specs
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        if self.shard is None:
            host = _host(tree_map(lambda v: v.detach().to("cpu", copy=True), tree))
        else:
            host = gather_host(tree, self.shard, self.specs)
            if host is None:
                return

        def _run():
            _write(os.path.join(self.ckpt_dir, f"step_{step:08d}"), step, host, extra)
            self._gc()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.shard is not None:
            self.shard.barrier()

    def _gc(self) -> None:
        for s in all_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            with open(os.path.join(ckpt_dir, name, "manifest.json")) as f:
                if json.load(f).get("done"):
                    out.append(int(name[5:]))
        except (OSError, ValueError):
            continue
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, device="cuda", shard=None, specs=None):
    """-> ``(tree, manifest)``: the checkpoint in ``like_tree``'s structure
    (shapes checked against it), each leaf a tensor on ``device`` with the
    stored dtype and bits; on a mesh (``shard``, ``specs``) this rank's
    slice of each whole leaf."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    placed = None if shard is None else spec_paths(like_tree, specs)
    with np.load(os.path.join(final, "arrays.npz")) as data:

        def leaf(key, like):
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, expected "
                                 f"{tuple(like.shape)}")
            t = torch.from_numpy(arr)
            return (t if placed is None else shard.local_slice(t, placed[key])).to(device)

        tree = map_with_paths(leaf, like_tree)
    return tree, manifest
