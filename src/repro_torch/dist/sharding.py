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
rules for the serving stack and the trainer, which run explicit SPMD: one
process per rank, each holding the local shard of every parameter and cache
leaf, the model code calling named collectives on the mesh's ``data`` and
``model`` groups where a sharded axis is contracted or needed whole.  Every
collective is an ``all_reduce`` (or a ``broadcast``), the two that every
backend offers for CUDA tensors, gloo included: a gather is an
``all_reduce`` of a zero-filled buffer in which each rank writes its own
block, exact, since adding zeros changes no value.  A mesh axis of size 1
shards nothing and calls no collective, so a 1x1 mesh runs the unmeshed
operations; only :meth:`ShardingCtx.agree` and :meth:`ShardingCtx.count`
communicate on any mesh.

Training differentiates through the same model code (Megatron's pattern):
:meth:`ShardingCtx.copy_to_model` where a replicated value enters weights
local to a rank (identity forward, sum over ``model`` backward),
:meth:`ShardingCtx.reduce_from` after a partial sum (sum forward, identity
backward) and :meth:`ShardingCtx.gather_whole` where a shard is read whole
(this rank's block of the gradient backward).  Each is an
``autograd.Function`` only while autograd records; otherwise it is the
in-place collective that serving calls.  The optimizer's ``m``, ``v`` and
``master`` are ZeRO-sharded (:func:`zero_spec`) over ``data`` on top of the
parameters' ``model`` placement (:meth:`ShardingCtx.opt_state_specs`).

The MoE (``models/moe.py``) routes the global batch as GSPMD does:
:meth:`ShardingCtx.split_rows` marks a model call whose rows are this data
rank's block of a split batch, :meth:`ShardingCtx.global_rows` gives that
batch's row count (its capacity), :meth:`ShardingCtx.counts_below` the
lower data ranks' per-expert counts (its queue positions), and
:meth:`ShardingCtx.model_range` this model rank's experts (as MLA,
``models/attention.py``, its latent columns).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch.convert import flatten_with_paths, tree_map
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

# elements per packed collective of ShardingCtx.sum_over (128 MB of fp32)
BUCKET = 1 << 25


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


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over one mesh axis backward."""

    @staticmethod
    def forward(ctx, x, shard, axis):
        ctx.shard, ctx.axis = shard, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.all_reduce(g.clone(memory_format=torch.contiguous_format),
                                    ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    """The sum over one mesh axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, shard, axis):
        return shard.all_reduce(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherWhole(torch.autograd.Function):
    """A local block -> the whole tensor forward; this rank's block of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, shard, spec, shape):
        ctx.shard, ctx.spec, ctx.local = shard, spec, tuple(x.shape)
        return shard.gather(x, spec, shape)

    @staticmethod
    def backward(ctx, g):
        for i, a in ctx.shard._splits(ctx.spec):
            n = ctx.local[i]
            g = g.narrow(i, ctx.shard.coord(a) * n, n)
        return g.contiguous(), None, None, None


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
    model: object = None              # the ModelConfig whose training state it places
    # the rows the model layer is handed are this data rank's block of a batch
    # split over ``data`` (:meth:`split_rows`; the MoE routes the global batch)
    rows_split: bool = False

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
        return dataclasses.replace(self, batch=int(batch), pool_blocks=0, rows_split=False)

    def for_pool(self, n_blocks: int) -> "ShardingCtx":
        return dataclasses.replace(self, batch=0, pool_blocks=int(n_blocks), rows_split=False)

    def split_rows(self) -> "ShardingCtx":
        """This context for a model call whose rows are this data rank's
        contiguous block of a batch split evenly over ``data`` (rank 0's
        block first): a decode or prefill over :meth:`row_range`, the
        trainer's :func:`~repro_torch.train.step.data_rows`."""
        return dataclasses.replace(self, rows_split=True)

    def for_model(self, model_cfg) -> "ShardingCtx":
        """This context placing ``model_cfg``'s parameters and optimizer
        state (:meth:`leaf_plan`; the trainer's ``shard``)."""
        return dataclasses.replace(self, model=model_cfg)

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

    def model_range(self, names: tuple, shape: tuple[int, ...]) -> tuple[int, int] | None:
        """``(first, count)`` of this rank's block of the dimension that a
        ``model`` axis larger than 1 splits in a tensor of logical ``names``
        and whole ``shape`` (an MoE's experts, an MLA cache's latent
        columns), or None when the tensor is whole on every model rank
        (a model axis of 1, or one the spec rules put elsewhere)."""
        for i, a in self._splits(self.spec(names, shape)):
            if a == "model":
                n = shape[i] // self.size("model")
                return self.coord("model") * n, n
        return None

    def local_slice(self, x: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of a whole tensor (a contiguous copy)."""
        return self.block(x, spec).contiguous()

    def place_params(self, model_cfg, params: dict) -> dict:
        """Whole parameter tensors -> this rank's local slices, by
        :meth:`param_shardings`."""
        return tree_map(self.local_slice, params, self.param_shardings(model_cfg))

    # -- ZeRO: the optimizer state over data ------------------------------

    def opt_state_specs(self, model_cfg, master_weights: bool = False) -> dict:
        """Spec tree of an AdamW state: ``m``, ``v`` (and ``master``) by
        :func:`tree_zero_specs`, ``step`` replicated (``()``)."""
        from repro_torch.models import lm

        shapes = lm.tree_of_shapes(lm.param_shapes(model_cfg))
        zero = tree_zero_specs(lm.param_axes(model_cfg), shapes, self.shape)
        specs = {"m": zero, "v": zero, "step": ()}
        if master_weights:
            specs["master"] = zero
        return specs

    def place_opt_state(self, model_cfg, state: dict) -> dict:
        """A whole AdamW state -> this rank's ZeRO slices of ``m``, ``v``
        and ``master``; ``step`` as it is."""
        specs = self.opt_state_specs(model_cfg, "master" in state)
        return {k: v if k == "step" else tree_map(self.local_slice, v, specs[k])
                for k, v in state.items()}

    def state_specs(self, model_cfg, opt_state: dict) -> tuple:
        """Spec tree of a ``(params, opt_state)`` pair (checkpoints)."""
        return (self.param_shardings(model_cfg),
                self.opt_state_specs(model_cfg, "master" in opt_state))

    @functools.cached_property
    def leaf_plan(self) -> dict:
        """``{path: (model_split, zero_dim)}`` of every parameter leaf of
        :attr:`model`: whether ``model`` splits the leaf, and the dimension
        of the rank's model-local leaf that ZeRO splits over ``data`` (None
        where :func:`zero_spec` found none, or ``data`` has one rank)."""
        from repro_torch.models import lm

        if self.model is None:
            raise ValueError("the training state's placement needs the model: "
                             "use ShardingCtx.for_model(model_cfg)")
        axes = flatten_with_paths(lm.param_axes(self.model))
        plan = {}
        for key, leaf in flatten_with_paths(lm.param_shapes(self.model)).items():
            pspec = spec_for(axes[key], leaf.shape, self.shape)
            zspec = zero_spec(pspec, leaf.shape, self.shape)
            split = any(a == "model" for _, a in self._splits(pspec))
            dims = [i for i, a in self._splits(zspec) if a == "data" and pspec[i] is None]
            plan[key] = (split, dims[0] if dims else None)
        return plan

    def zero_slice(self, x: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This data rank's block of a model-local leaf along ``dim`` (a
        view; ``x`` itself when ``dim`` is None)."""
        if dim is None:
            return x
        n = x.shape[dim] // self.size("data")
        return x.narrow(dim, self.coord("data") * n, n)

    def zero_gather(self, blocks) -> list:
        """``(block, dim, shape)`` of each leaf's :meth:`zero_slice` ->
        every data rank's blocks put together, the model-local leaves of
        those shapes (exact: zeros and each rank's block, summed over
        ``data`` by :meth:`sum_over`)."""
        out = []
        for x, dim, shape in blocks:
            full = x.new_zeros(shape)
            self.zero_slice(full, dim).copy_(x)
            out.append(full)
        self.sum_over(out, "data")
        return out

    def row_range(self) -> tuple[int, int] | None:
        """``(first, count)`` of the :meth:`for_rows` dense-cache rows this
        rank holds (``batch`` on ``data`` where it divides), or None when
        every rank holds every row."""
        if not self.batch or self.size("data") == 1 or self.rows(self.batch) == (None,):
            return None
        n = self.batch // self.size("data")
        return self.coord("data") * n, n

    def global_rows(self, n: int) -> int:
        """The row count of the whole batch whose block of ``n`` rows this
        rank holds: ``n`` times the data ranks under :meth:`split_rows`,
        else ``n`` (every rank holds every row)."""
        return n * self.size("data") if self.rows_split else n

    def counts_below(self, counts: torch.Tensor) -> torch.Tensor:
        """``counts`` (``(E,)`` int64, this rank's per-expert choices under
        :meth:`split_rows`) -> the sum of the lower data ranks' counts: one
        exact ``all_reduce`` over ``data`` of a zero-filled ``(D, E)``
        buffer in which each rank writes its own row (:meth:`gather`'s
        pattern).  The exclusive prefix that makes a local queue position
        the position over the global rows."""
        rows = torch.zeros((self.size("data"),) + tuple(counts.shape), dtype=counts.dtype,
                           device=counts.device)
        rows[self.coord("data")] = counts
        self.all_reduce(rows, "data")
        return rows[:self.coord("data")].sum(0)

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
            # both axes: the whole mesh, which must be the default group
            if self.n_devices != torch.distributed.get_world_size():
                raise NotImplementedError("a collective over both axes of a mesh that is a "
                                          "part of the process group")
            return None
        (axis,) = axes
        return self.mesh.get_group(axis)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the ranks of one mesh axis, in place; a no-op on an axis
        of size 1."""
        if self.size(axis) > 1:
            torch.distributed.all_reduce(x, group=self._group({axis}))
        return x

    def sum_over(self, tensors, axis: str) -> None:
        """Sum every tensor over the ranks of ``axis`` in place, packed by
        dtype into one ``all_reduce`` per :data:`BUCKET` elements (the
        trainer's gradients and ZeRO gathers: one collective, not one per
        leaf); a no-op on an axis of size 1."""
        if self.size(axis) == 1:
            return
        self._sum_packed(tensors, self._group({axis}))

    def sum_over_mesh(self, tensors) -> None:
        """:meth:`sum_over` every axis of the mesh at once."""
        axes = {a for a, n in self.shape.items() if n > 1}
        if axes:
            self._sum_packed(tensors, self._group(axes))

    def owns(self, spec: tuple) -> bool:
        """Whether this rank is the one that contributes its block of a
        leaf placed by ``spec`` to a sum over the whole mesh: coordinate 0
        of every mesh axis the spec does not split."""
        split = {a for _, a in self._splits(spec)}
        return all(self.coord(a) == 0 for a, n in self.shape.items() if n > 1 and a not in split)

    def block(self, whole: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's block of a whole tensor placed by ``spec`` (a view)."""
        for i, a in self._splits(spec):
            n = whole.shape[i] // self.size(a)
            whole = whole.narrow(i, self.coord(a) * n, n)
        return whole

    def _sum_packed(self, tensors, group) -> None:
        def flush(bucket):
            if len(bucket) == 1 and bucket[0].is_contiguous():
                torch.distributed.all_reduce(bucket[0], group=group)
                return
            flat = torch.cat([t.reshape(-1) for t in bucket])
            torch.distributed.all_reduce(flat, group=group)
            for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(piece.view(t.shape))

        by_kind: dict = {}
        for t in tensors:
            by_kind.setdefault((t.dtype, t.device), []).append(t)
        for ts in by_kind.values():
            bucket, n = [], 0
            for t in ts:
                if bucket and n + t.numel() > BUCKET:
                    flush(bucket)
                    bucket, n = [], 0
                bucket.append(t)
                n += t.numel()
            flush(bucket)

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

    def whole_shape(self, local: tuple[int, ...], spec: tuple) -> tuple[int, ...]:
        """The whole shape of a local block placed by ``spec``."""
        out = list(local)
        for i, a in self._splits(spec):
            out[i] *= self.size(a)
        return tuple(out)

    def gather_whole(self, x: torch.Tensor, names: tuple,
                     shape: tuple[int, ...]) -> torch.Tensor:
        """A local shard of a tensor of logical ``names`` and whole
        ``shape`` -> the whole tensor (gathered at use).  While autograd
        records, its backward is this rank's block of the gradient, which
        is the shard's gradient only where every rank computes the same
        thing downstream of the gather (the replicated stream between the
        collectives of :meth:`copy_to_model` and :meth:`reduce_from`); a
        whole weight that a rank-local computation reads must pass through
        :meth:`copy_to_model` after the gather."""
        spec = self.spec(names, shape)
        if not self._splits(spec):
            return x
        if not _recording(x):
            return self.gather(x, spec, shape)
        return _GatherWhole.apply(x, self, spec, tuple(shape))

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it enters a computation local to this ``model`` rank
        (local heads, a column-parallel FFN, a vocabulary slice): the
        identity, whose backward sums the ranks' partial gradients over
        ``model``."""
        if self.size("model") == 1 or not _recording(x):
            return x
        return _CopyTo.apply(x, self, "model")

    def reduce_from(self, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
        """The sum of the ranks' partial ``x`` over ``axis`` (a row-parallel
        output, the vocab-parallel embedding, the loss's data shares); the
        in-place :meth:`all_reduce` when autograd does not record, else an
        out-of-place sum whose backward passes the gradient through."""
        if not _recording(x):
            return self.all_reduce(x, axis)
        if self.size(axis) == 1:
            return x
        return _ReduceFrom.apply(x, self, axis)

    def agree(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank takes rank 0's copy of ``x``, in place: the engine's
        host decisions read only values that are equal on every rank.  It
        broadcasts on a one-rank mesh too (a no-op there), so every mesh
        runs at least this collective."""
        torch.distributed.broadcast(x, src=0)
        return x

    def count(self, flag: bool) -> int:
        """How many ranks of the mesh raise ``flag``: one ``all_reduce``
        over the whole mesh (none on one rank), so every rank reads the same
        number (the trainer's stop and retry decisions)."""
        axes = {a for a, n in self.shape.items() if n > 1}
        if not axes:
            return int(flag)
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device=torch.device(self.mesh.device_type))
        torch.distributed.all_reduce(t, group=self._group(axes))
        return int(t[0])

    def barrier(self) -> None:
        """Return once every rank of the mesh has come here (a
        :meth:`count`)."""
        self.count(False)
