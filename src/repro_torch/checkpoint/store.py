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
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.convert import flatten_with_paths, map_with_paths, tree_map


def _host(tree) -> dict:
    """``{path: numpy array}``: each leaf copied to the host."""
    return {k: v.detach().cpu().numpy() for k, v in flatten_with_paths(tree).items()}


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    host = _host(tree)
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
    return final


class AsyncCheckpointer:
    """Snapshot on call, write in the background; ``wait()`` joins the writer."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        host_tree = tree_map(lambda v: v.detach().to("cpu", copy=True), tree)

        def _write():
            save(self.ckpt_dir, step, host_tree, extra)
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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


def restore(ckpt_dir: str, step: int, like_tree, device="cuda"):
    """-> ``(tree, manifest)``: the checkpoint in ``like_tree``'s structure
    (shapes checked against it), each leaf a tensor on ``device`` with the
    stored dtype and bits."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, "arrays.npz")) as data:

        def leaf(key, like):
            arr = data[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, expected "
                                 f"{tuple(like.shape)}")
            return torch.from_numpy(arr).to(device)

        tree = map_with_paths(leaf, like_tree)
    return tree, manifest
