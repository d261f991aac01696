"""Elastic re-meshing: restore a checkpoint onto another mesh than the one
it was written from (counterpart of ``repro/launch/elastic.py``).

Checkpoints hold whole logical arrays (``checkpoint/store.py``, which
gathers a mesh's shards before rank 0 writes), so re-meshing is slicing:
the parameters by the logical-axis rules for the new mesh
(``ShardingCtx.param_shardings``) and the optimizer state by their ZeRO
variant (``ShardingCtx.opt_state_specs``).  A checkpoint from a 2x2 mesh
restores on 1x1, 1x2 or no mesh at all, and one that the JAX package wrote
restores on a mesh.
"""

from __future__ import annotations

import json
import os

import torch

from repro_torch.checkpoint import store
from repro_torch.convert import tree_map
from repro_torch.models import lm


def _like_state(manifest: dict, like_params) -> dict:
    """A whole AdamW state's shapes (meta tensors), ``master`` when the
    checkpoint holds one."""
    state = {"m": like_params, "v": like_params, "step": torch.empty((), device="meta")}
    if any(k.startswith("[1]/['master']") for k in manifest["keys"]):
        state["master"] = like_params
    return state


def restore_elastic(ckpt_dir: str, step: int, model_cfg, shard, dtype, device="cuda"):
    """-> ``(params, opt_state, manifest)`` of a ``(params, opt_state)``
    checkpoint, each leaf this rank's slice for the mesh that ``shard``
    names (whole leaves with ``shard=None``), on ``device``.  The stored
    bits are kept; parameters stored in another dtype than ``dtype`` raise
    ``ValueError``."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    want = str(dtype).replace("torch.", "")
    stored = {v for k, v in manifest["dtypes"].items() if k.startswith("[0]/")}
    if stored != {want}:
        raise ValueError(f"checkpoint step {step}: parameters stored as {sorted(stored)}, "
                         f"not {want}")
    like_params = tree_map(lambda spec: torch.empty(spec.shape, device="meta"),
                           lm.param_shapes(model_cfg))
    like = (like_params, _like_state(manifest, like_params))
    specs = None if shard is None else shard.state_specs(model_cfg, like[1])
    (params, opt_state), manifest = store.restore(ckpt_dir, step, like, device=device,
                                                  shard=shard, specs=specs)
    return params, opt_state, manifest
