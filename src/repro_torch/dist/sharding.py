"""Logical-axis -> partition-spec rules and the serving mesh context
(counterpart of ``repro/dist/sharding.py``; DESIGN.md §4).

Parameters and decode caches carry an :class:`Axes` tree naming the
*logical* role of every dimension (``embed``, ``ffn``, ``heads``,
``vocab``, ``batch``, ``seq_cache``, ``kv_blocks``, ...;
``lm.param_axes``, ``lm.cache_axes``, ``lm.paged_cache_axes``).  The rules
turn those names into a partition spec for a ``(data, model)`` mesh, with
the reference's names and results:

* the tensor-parallel ``model`` axis goes to the highest-priority logical
  axis (vocab > experts > ffn > heads > kv_heads > kv_lora > embed) whose
  size it divides;
* the data-parallel axes (``pod`` + ``data``) go to ``batch``, else
  ``seq_cache``, else a paged pool's ``kv_blocks``;
* ``layers`` and anonymous ``None`` axes are never sharded;
* :func:`zero_spec` adds the data axes to a replicated dimension (ZeRO);
* every rule degrades to replication when a size does not divide.

A spec is a tuple with one entry per dimension: ``None``, a mesh-axis name,
or a tuple of names.  The rules read only a ``{axis name: size}`` mapping,
so they run without a process group.

:class:`ShardingCtx` bundles a ``torch.distributed`` device mesh with the
rules for the serving stack, which runs explicit SPMD: one process per
rank, each holding the local shard of every parameter and cache leaf, the
model code calling named collectives on the mesh's ``data`` and ``model``
groups where a sharded axis is contracted or needed whole.  Every
collective is an ``all_reduce`` (or a ``broadcast``), the two that every
backend offers for CUDA tensors, gloo included: a gather is an
``all_reduce`` of a zero-filled buffer in which each rank writes its own
block, exact, since adding zeros changes no value.  A mesh axis of size 1
shards nothing and calls no collective, so a 1x1 mesh runs the unmeshed
operations; only :meth:`ShardingCtx.agree` broadcasts on any mesh.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.convert import tree_map
from repro_torch.models.layers import Axes


# Highest-priority first: which logical axis takes the tensor-parallel mesh
# axis (vocab first: the embedding and unembedding are the largest
# matrices; then the expert and FFN dims; then attention heads).
MODEL_AXIS_PRIORITY = (
    "vocab", "experts", "ffn", "heads", "kv_heads", "kv_lora", "embed",
)

# Mesh axes that carry data parallelism, outermost first.
DATA_MESH_AXES = ("pod", "data")

# Logical axes that may absorb the data-parallel mesh axes, in order of
# preference; a paged pool has no batch or seq_cache, so its blocks take them.
BATCH_AXIS_PRIORITY = ("batch", "seq_cache", "kv_blocks")


def _size(mesh: dict, name: str) -> int:
    return int(mesh.get(name, 0))


def _data_axis_combos(mesh: dict) -> list[tuple[str, ...]]:
    """Candidate data-axis assignments, largest first: ("pod", "data") ->
    ("data",) -> ("pod",)."""
    present = tuple(a for a in DATA_MESH_AXES if a in mesh)
    if len(present) > 1:
        return [present] + [(a,) for a in present[::-1]]
    return [(a,) for a in present]


def _combo_size(mesh: dict, combo: tuple[str, ...]) -> int:
    return math.prod(_size(mesh, a) for a in combo)


def _entry(combo: tuple[str, ...]):
    return combo if len(combo) > 1 else combo[0]


def spec_for(axes: Axes, shape: tuple[int, ...], mesh: dict) -> tuple:
    """Partition spec of one tensor from its logical axes and shape on a
    mesh given as ``{axis name: size}``.  A mesh axis lands only on a
    dimension whose size it divides, else on the next candidate, else
    nowhere; each mesh axis is used at most once per spec."""
    if len(axes.names) != len(shape):
        raise ValueError(f"axes {axes.names} do not match shape {tuple(shape)}")
    entries: list = [None] * len(shape)
    msize = _size(mesh, "model")
    done = False
    for logical in MODEL_AXIS_PRIORITY:
        for i, name in enumerate(axes.names):
            if name == logical and msize and shape[i] % msize == 0:
                entries[i] = "model"
                done = True
                break
        if done:
            break
    done = False
    for logical in BATCH_AXIS_PRIORITY:
        for i, name in enumerate(axes.names):
            if name != logical or entries[i] is not None:
                continue
            for combo in _data_axis_combos(mesh):
                cs = _combo_size(mesh, combo)
                if cs and shape[i] % cs == 0:
                    entries[i] = _entry(combo)
                    done = True
                    break
            if done:
                break
        if done:
            break
    return tuple(entries)


def _names_in(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def zero_spec(base: tuple, shape: tuple[int, ...], mesh: dict) -> tuple:
    """ZeRO: add the data-parallel axes to the first replicated dimension of
    ``base`` that they divide; ``base`` unchanged when nothing divides."""
    entries = list(base) + [None] * (len(shape) - len(base))
    used = {a for e in entries for a in _names_in(e)}
    for combo in _data_axis_combos(mesh):
        if any(a in used for a in combo):
            continue
        cs = _combo_size(mesh, combo)
        if not cs:
            continue
        for i, e in enumerate(entries):
            if e is None and shape[i] % cs == 0:
                entries[i] = _entry(combo)
                return tuple(entries)
    return tuple(entries)


def batch_spec(mesh: dict, batch: int) -> tuple:
    """Spec whose one entry shards a leading batch over the data axes
    (largest divisible combination; ``(None,)`` when nothing divides)."""
    for combo in _data_axis_combos(mesh):
        cs = _combo_size(mesh, combo)
        if cs and batch % cs == 0:
            return (_entry(combo),)
    return (None,)


def tree_specs(axes_tree, shape_tree, mesh: dict):
    """A spec tree: one spec per ``(Axes, shape)`` pair of two trees."""
    return tree_map(lambda ax, s: spec_for(ax, tuple(s), mesh), axes_tree, shape_tree)


def tree_zero_specs(axes_tree, shape_tree, mesh: dict):
    """The ZeRO variant of :func:`tree_specs` (optimizer states)."""
    return tree_map(lambda ax, s: zero_spec(spec_for(ax, tuple(s), mesh), tuple(s), mesh),
                      axes_tree, shape_tree)


@functools.lru_cache(maxsize=4096)
def _spec_cached(names: tuple, shape: tuple, mesh_items: tuple) -> tuple:
    return spec_for(Axes(names), shape, dict(mesh_items))


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``torch.distributed`` device mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """A ``(data, model)`` device mesh and the spec rules, bundled for the
    serving stack.

    The model layer (``models/layers.py``, ``attention.py``, ``blocks.py``,
    ``lm.py``) and ``serve/engine.py`` take an optional ``shard``; with
    ``None`` they run the single-device code unchanged.  Two fields say
    which caches a call serves, so that a rank knows which of their rows
    or blocks it holds: ``batch``, the global row count of dense caches
    (:meth:`for_rows`; 0: every rank computes every row), and
    ``pool_blocks``, the global block count of a paged pool
    (:meth:`for_pool`)."""

    mesh: object                      # torch.distributed DeviceMesh ("data", "model")
    batch: int = 0
    pool_blocks: int = 0

    # the mesh's shape and this rank's coordinates, read once per context
    # (the model layer asks for them on every call)
    @functools.cached_property
    def shape(self) -> dict:
        return mesh_shape(self.mesh)

    @functools.cached_property
    def _coords(self) -> dict:
        return dict(zip(self.mesh.mesh_dim_names, (int(c) for c in self.mesh.get_coordinate())))

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along a mesh axis."""
        return self._coords[axis]

    def for_rows(self, batch: int) -> "ShardingCtx":
        return dataclasses.replace(self, batch=int(batch), pool_blocks=0)

    def for_pool(self, n_blocks: int) -> "ShardingCtx":
        return dataclasses.replace(self, batch=0, pool_blocks=int(n_blocks))

    # -- spec derivation --------------------------------------------------

    def spec(self, names: tuple, shape: tuple[int, ...]) -> tuple:
        return _spec_cached(tuple(names), tuple(shape), tuple(self.shape.items()))

    def rows(self, batch: int) -> tuple:
        """Spec of a leading-batch host array (tokens, positions)."""
        return batch_spec(self.shape, batch)

    def param_shardings(self, model_cfg) -> dict:
        from repro_torch.models import lm

        shapes = lm.tree_of_shapes(lm.param_shapes(model_cfg))
        return tree_specs(lm.param_axes(model_cfg), shapes, self.shape)

    def cache_shardings(self, model_cfg, batch: int, max_seq: int) -> dict:
        from repro_torch.models import lm

        caches = lm.init_caches(model_cfg, batch, max_seq, torch.float32, "meta")
        return tree_specs(lm.cache_axes(model_cfg), lm.tree_of_shapes(caches), self.shape)

    def paged_cache_shardings(self, model_cfg, n_blocks: int, block_size: int) -> dict:
        from repro_torch.models import lm

        pools = lm.init_paged_caches(model_cfg, n_blocks, block_size, torch.float32, "meta")
        return tree_specs(lm.paged_cache_axes(model_cfg), lm.tree_of_shapes(pools),
                          self.shape)

    # -- local shards -------------------------------------------------------

    def _splits(self, spec: tuple):
        """``(dim, mesh axis)`` of each dimension a spec shards over a mesh
        axis larger than 1 (the port's mesh has single-name entries)."""
        out = []
        for i, e in enumerate(spec):
            for a in _names_in(e):
                if self.size(a) > 1:
                    if not isinstance(e, str):
                        raise NotImplementedError(f"spec entry {e}: one mesh axis per dim")
                    out.append((i, a))
        return out

    def local_shape(self, names: tuple, shape: tuple[int, ...]) -> tuple[int, ...]:
        out = list(shape)
        for i, a in self._splits(self.spec(names, shape)):
            out[i] //= self.size(a)
        return tuple(out)

    def model_split(self, names: tuple, shape: tuple[int, ...]) -> str | None:
        """The logical axis that takes a ``model`` axis larger than 1, or
        None when the tensor is whole on every model rank."""
        for i, a in self._splits(self.spec(names, shape)):
            if a == "model":
                return names[i]
        return None

    def local_slice(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of a whole tensor (a contiguous copy)."""
        for i, a in self._splits(spec):
            n = x.shape[i] // self.size(a)
            x = x.narrow(i, self.coord(a) * n, n)
        return x.contiguous()

    def place_params(self, model_cfg, params: dict) -> dict:
        """Whole parameter tensors -> this rank's local slices, by
        :meth:`param_shardings`."""
        return tree_map(self.local_slice, params, self.param_shardings(model_cfg))

    def row_range(self) -> tuple[int, int] | None:
        """``(first, count)`` of the :meth:`for_rows` dense-cache rows this
        rank holds (``batch`` on ``data`` where it divides), or None when
        every rank holds every row."""
        if not self.batch or self.size("data") == 1 or self.rows(self.batch) == (None,):
            return None
        n = self.batch // self.size("data")
        return self.coord("data") * n, n

    def block_range(self) -> tuple[int, int] | None:
        """``(first, count)`` of the paged pool's blocks this rank holds
        (pool leaves put ``kv_blocks`` on ``data`` when it divides), or
        None when every rank holds the whole pool."""
        if not self.pool_blocks:
            raise ValueError("the pool's block count is unknown: use for_pool(n_blocks)")
        if self.size("data") == 1 or self.spec(("kv_blocks",), (self.pool_blocks,)) == (None,):
            return None
        n = self.pool_blocks // self.size("data")
        return self.coord("data") * n, n

    # -- collectives ------------------------------------------------------

    def _group(self, axes: set[str]):
        if len(axes) > 1:
            return None                   # both axes: the whole mesh, the default group
        (axis,) = axes
        return self.mesh.get_group(axis)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the ranks of one mesh axis, in place; a no-op on an axis
        of size 1."""
        if self.size(axis) > 1:
            torch.distributed.all_reduce(x, group=self._group({axis}))
        return x

    def gather(self, x: torch.Tensor, spec: tuple, shape: tuple[int, ...]) -> torch.Tensor:
        """A local block -> the whole tensor of ``shape`` on every rank of
        the axes ``spec`` shards over: each rank writes its block into
        zeros, one ``all_reduce`` sums them.  ``x`` itself when the spec
        shards nothing."""
        splits = self._splits(spec)
        if not splits:
            return x
        full = x.new_zeros(shape)
        block = full
        for i, a in splits:
            block = block.narrow(i, self.coord(a) * x.shape[i], x.shape[i])
        block.copy_(x)
        torch.distributed.all_reduce(full, group=self._group({a for _, a in splits}))
        return full

    def whole(self, x: torch.Tensor, names: tuple, shape: tuple[int, ...]) -> torch.Tensor:
        """A local shard of a tensor of logical ``names`` and whole
        ``shape`` -> the whole tensor (gathered at use)."""
        return self.gather(x, self.spec(names, shape), shape)

    def agree(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank takes rank 0's copy of ``x``, in place: the engine's
        host decisions read only values that are equal on every rank.  It
        broadcasts on a one-rank mesh too (a no-op there), so every mesh
        runs at least this collective."""
        torch.distributed.broadcast(x, src=0)
        return x
