"""How a rank stores a parameter tree across the ranks of a mesh, and how
the stored blocks become whole weights for use — the port's side of the
reference's ``param_shardings`` / ``state_shardings``
(``launch/mesh.py``), which XLA applies for the reference.

A :class:`Layout` gives each leaf (by its ``/``-joined path) the spec it
is stored by, one entry per dim (``launch/mesh.fit_spec``'s form):

* ``fsdp=True``: the reference's ``param_shardings(fsdp=True)`` spec,
  exactly — dense weights over data × model, the experts' E over
  ``model`` and their d over ``data`` (ZeRO-3: a rank stores the bytes
  the reference stores on that device);
* ``expert_tp=True`` (serving, the reference's decode layout): the
  expert leaves' f over ``data`` as well, with or without FSDP — a rank
  stores 1/(M·D) of each expert leaf; the prefill gathers f whole inside
  each block, the decode step computes on the slice;
* ``fsdp=False``: the expert leaves' E over ``model`` (expert
  parallelism), every other leaf whole.  The reference's ``model`` axis on
  dense dims (attention heads, the FFN hidden) is tensor parallelism, a
  layout of the same math: the port does not compute it split
  (ROADMAP.md, Queue 3).

The rank of mesh index ``(d, m)`` is ``r = d·M + m`` (data-major, as
``launch/mesh.make_mesh`` lays the ranks out); its block of a dim over
``data`` is the d-th of D equal blocks, over ``model`` the m-th of M.

For use, a leaf is gathered over every axis of its spec except the
experts' ``model`` (compute sharding: each rank computes with its E/M
experts): an all-gather over the ``model`` group, then over the ``data``
group (:func:`gather`, an ``autograd.Function``), whose backward is the
reduce-scatter in reverse order — the gradient arrives summed over those
groups, cut to the rank's block.  :meth:`Layout.reduce_axes` names the
axes a leaf's gradient must still be summed over (those it is neither
gathered nor computed sharded on), :meth:`Layout.norm_axes` the axes
whose ranks hold disjoint blocks of it (a global norm sums its squares
over them, and over no axis it is replicated on).  Every gather and
reduce-scatter is logged in ``core/alltoall.collectives`` (when it is
on), with the axis it crosses.

The block arithmetic depends on the mesh's shape and the rank only, so a
process with no group (a test, a one-process restore) can cut any rank's
blocks; the collectives need the rank's ``launch/mesh.Mesh``.

A served model's decode caches are stored by :func:`cache_layout_for`
(a :class:`CacheLayout`): every leaf by the reference's ``cache_spec``
(``cache_shardings``) — the rows over ``data``, then ONE inner dim over
``model``: dim −2 where it divides, else dim 1, else the last.  An
attention cache (B, L, KV, hd) is so cut in its kv heads (``heads``),
else its positions (``positions``), else its channels (``channels``);
RWKV's ``s`` (B, H, hd_k, hd_v) in its key dim, else its heads;
Mamba's ``s`` (B, H, hd, N) in its head dim, else its heads, else its
state dim, and its ``conv`` (B, K−1, C) in its K−1 positions, else its
channels; ``x_last`` (B, d) by its rows only.  Each layer's cut is a
``models/cache_cut.CacheCut`` that the decode functions read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import alltoall
from repro_torch.core.alltoall import DTYPE_BYTES
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.cache_cut import FORM_DIMS, CacheCut
from repro_torch.models.transformer import EXPERT_LEAVES, _F32_LEAVES

# the gather order (the backward reduce-scatters in reverse)
GATHER_ORDER = ("model", "data")

gathers = 0     # all-gathers of stored blocks for use since the reset
row_gathers = 0  # all-gathers over a row group (context parallelism)


def is_expert(path: str) -> bool:
    parts = path.split("/")
    return len(parts) > 1 and parts[-2] == "moe" and parts[-1] in EXPERT_LEAVES


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def f_dim(path: str) -> int:
    """The expert FFN width's dim of the expert leaf at ``path``: the last
    of ``w_up`` / ``w_gate`` (E, d, f), the middle of ``w_out`` (E, f,
    d)."""
    return 1 if path.split("/")[-1] == "w_out" else 2


def storage_spec(path: str, spec: mesh_lib.Spec, fsdp: bool,
                 mesh_shape: Dict[str, int], expert_tp: bool = False,
                 shape=None) -> mesh_lib.Spec:
    """The spec ``path`` is stored by, from ``spec``, its spec in
    ``launch/mesh.param_shardings(fsdp=fsdp, expert_tp=expert_tp)``
    (module docstring): with FSDP that spec; without it an expert leaf's
    spec (E over ``model``, and with ``expert_tp`` f over ``data``: the
    reference's ``not (expert_tp and "/moe/" in key)``) and every other
    leaf whole.  Raises when an expert leaf's E does not divide over
    ``model``, or under ``expert_tp`` its f (of ``shape``) over
    ``data``."""
    expert = is_expert(path)
    if expert and mesh_shape.get("model", 1) > 1 and spec[0] != "model":
        raise ValueError(f"{path}: its experts do not divide over "
                         f"model={mesh_shape['model']}")
    D = mesh_shape.get("data", 1)
    if expert and expert_tp and D > 1 and spec[f_dim(path)] != "data":
        f = "?" if shape is None else shape[f_dim(path)]
        raise ValueError(
            f"{path}: expert TP: the expert FFN width f={f} does not divide "
            f"over the data axis of size {D}")
    if fsdp:
        return spec
    return tuple(s if expert else None for s in spec)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank ``rank``'s storage of a parameter tree on a mesh of shape
    ``mesh_shape`` (``{"data": D, "model": M}``): ``specs`` maps each
    leaf's path to its stored spec.  ``mesh`` (this rank's
    ``launch/mesh.Mesh``) is needed for the collectives only.
    ``expert_tp``: the experts' f is stored over ``data`` (serving's
    decode layout)."""
    mesh_shape: Dict[str, int]
    rank: int
    fsdp: bool
    specs: Dict[str, mesh_lib.Spec]
    mesh: Any = None
    expert_tp: bool = False

    @property
    def world(self) -> int:
        return math.prod(self.mesh_shape.values())

    def index(self, axis: str) -> int:
        """This rank's place along ``axis``."""
        M = self.mesh_shape.get("model", 1)
        return self.rank % M if axis == "model" else self.rank // M

    def block(self, path: str, shape) -> Tuple[slice, ...]:
        """This rank's block of the whole leaf ``path`` of ``shape``, one
        slice per dim (a dim over several axes is cut major to minor)."""
        out = []
        for n_dim, entry in zip(shape, self.specs[path], strict=True):
            n, i = 1, 0
            for a in _axes(entry):
                n, i = n * self.mesh_shape[a], i * self.mesh_shape[a] + \
                    self.index(a)
            size = n_dim // n
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def block_shape(self, path: str, shape) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.block(path, shape))

    def cut(self, path: str, whole):
        """This rank's block of ``whole`` (a tensor: a copy that owns its
        storage; a numpy array: a view)."""
        b = self.block(path, whole.shape)
        if isinstance(whole, torch.Tensor):
            if all(s.stop - s.start == n for s, n in zip(b, whole.shape)):
                return whole
            return whole[b].clone()
        return whole[b]

    def cut_tree(self, tree, prefix: str = "", *, experts: bool = True):
        """:meth:`cut` over ``tree`` (the leaves under ``prefix``);
        ``experts=False`` leaves the expert leaves as they are (cut
        already)."""
        return mesh_lib.map_paths(
            lambda p, t: t if not experts and is_expert(p) else self.cut(
                p, t), tree, prefix)

    # -- which axes a leaf crosses --------------------------------------

    def _spec_axes(self, path: str) -> List[Tuple[str, int]]:
        """(axis, dim) of every axis ``path``'s spec shards it over."""
        out = []
        for dim, entry in enumerate(self.specs[path]):
            if isinstance(entry, tuple):
                raise NotImplementedError(
                    f"{path}: a dim over several axes {entry} (no parameter "
                    f"rule gives one)")
            if entry is not None:
                out.append((entry, dim))
        return out

    def gather_axes(self, path: str) -> List[Tuple[str, int]]:
        """(axis, dim) the leaf is gathered over for use, in gather order:
        every axis of its spec but an expert leaf's ``model``."""
        axes = dict(self._spec_axes(path))
        if is_expert(path):
            axes.pop("model", None)
        return [(a, axes[a]) for a in GATHER_ORDER if a in axes]

    def norm_axes(self, path: str) -> Tuple[str, ...]:
        """The axes whose ranks hold disjoint blocks of the leaf."""
        return tuple(sorted(a for a, _ in self._spec_axes(path)))

    def reduce_axes(self, path: str) -> Tuple[str, ...]:
        """The axes a gradient of the leaf (after the gather's backward)
        must still be summed over: those of size > 1 it is neither
        gathered over nor computed sharded on."""
        done = {a for a, _ in self._spec_axes(path)}
        return tuple(a for a in sorted(self.mesh_shape)
                     if self.mesh_shape[a] > 1 and a not in done)

    @property
    def gathered(self) -> bool:
        """Whether any leaf is gathered for use (ZeRO-3 is on)."""
        return any(self.gather_axes(p) for p in self.specs)

    def group(self, axes: Tuple[str, ...]):
        """The process group spanning ``axes`` (the world for both)."""
        if set(axes) == {"data", "model"}:
            return dist.group.WORLD
        return self.mesh.data_group if axes == ("data",) \
            else self.mesh.model_group

    def _steps(self, axes) -> Tuple[Tuple[Any, int, int, str], ...]:
        return tuple((self.group((a,)), self.mesh_shape[a], dim, a)
                     for a, dim in axes)

    # -- gathers ----------------------------------------------------------

    def whole(self, tree, prefix: str = "", dtype=None, *,
              experts: bool = True):
        """``tree`` (the leaves under ``prefix``) with every leaf gathered
        for use (:func:`gather`, differentiable), in ``dtype`` (the
        compute dtype; None: the stored one) unless the model uses the
        leaf in f32 (``transformer._F32_LEAVES``); a leaf stored whole is
        returned as it is.  An expert leaf is gathered over ``data`` only
        (its ``model`` is compute sharding); ``experts=False`` leaves the
        expert leaves as stored (expert TP computes on its f-slice)."""
        def one(path, t):
            global gathers
            axes = self.gather_axes(path)
            if not axes or (not experts and is_expert(path)):
                return t
            gathers += len(axes)
            dt = (t.dtype if dtype is None
                  or path.split("/")[-1] in _F32_LEAVES else dtype)
            return gather(t, self._steps(axes), dt)
        return mesh_lib.map_paths(one, tree, prefix)

    def to_host(self, path: str, t: torch.Tensor) -> Optional[torch.Tensor]:
        """The whole leaf ``path`` (experts' E included) on rank 0's host,
        from the blocks of the ranks that share rank 0's place on the axes
        the leaf is not cut over (one gather to rank 0, without a
        gradient; a gloo group's blocks cross from the host); None on
        every other rank.  The checkpoint's gather."""
        axes = self.norm_axes(path)
        t = t.detach()
        if not axes:
            return t.cpu() if self.rank == 0 else None
        if any(self.index(a) for a in self.mesh_shape if a not in axes):
            return None                        # not in rank 0's group
        members = [r for r in range(self.world)
                   if not any(self._at(r).index(a) for a in self.mesh_shape
                              if a not in axes)]
        if self.mesh.backend == "gloo":
            t = t.cpu()
        t = t.contiguous()
        blocks = ([torch.empty_like(t) for _ in members] if self.rank == 0
                  else None)
        dist.gather(t, blocks, dst=0, group=self.group(axes))
        if self.rank != 0:
            return None
        shape = tuple(n * math.prod(self.mesh_shape[a] for a in _axes(e))
                      for n, e in zip(t.shape, self.specs[path]))
        whole = torch.empty(shape, dtype=t.dtype)
        for r, b in zip(members, blocks, strict=True):
            whole[self._at(r).block(path, shape)] = b.cpu()
        return whole

    def _at(self, rank: int) -> "Layout":
        """This layout as rank ``rank`` holds it (its block arithmetic)."""
        return dataclasses.replace(self, rank=rank)


# the most bytes of a rank's blocks that one exchange of a reduce-scatter
# sends: a whole table's gradient crosses in pieces, not in a second
# whole-size copy
_PIECE_BYTES = 1 << 28


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int,
                    dtype, axis: str) -> torch.Tensor:
    """Block r (of ``n`` along ``dim``) of the sum over ``group`` of ``x``,
    in ``dtype``.  The blocks cross in ``x``'s own dtype (a bf16
    cotangent: half the bytes of an f32 one) and each rank sums the ``n``
    it receives in ``dtype``, in group-rank order — at n = 2 exactly the
    sum of the blocks cast first — a piece of at most ``_PIECE_BYTES``
    at a time (logged as one reduce-scatter over ``axis``)."""
    alltoall.record("reduce_scatter", axis, n, x.dtype, x.shape)
    xm = x.movedim(dim, 0)
    rows = xm.shape[0] // n
    blocks = xm.unflatten(0, (n, rows))
    out = torch.empty((rows, *xm.shape[1:]), dtype=dtype, device=x.device)
    step = max(1, _PIECE_BYTES // max(1, blocks[:, :1].numel()
                                      * x.element_size()))
    for i in range(0, rows, step):
        send = blocks[:, i:i + step].contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv.view(torch.uint8).reshape(-1),
                               send.view(torch.uint8).reshape(-1),
                               group=group)
        del send
        piece = out[i:i + step]
        piece.copy_(recv[0])
        for j in range(1, n):
            piece.add_(recv[j])
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """Casts to ``dtype``, then all-gathers in ``steps`` order; the
    backward reduce-scatters the cotangent in reverse order (each block's
    gradient summed over the ranks that used it, in the block's
    precision: :func:`_reduce_scatter`)."""

    @staticmethod
    def forward(ctx, x, steps, dtype):
        ctx.steps, ctx.dtype = steps, x.dtype
        x = x.to(dtype)
        for group, n, dim, axis in steps:
            x = alltoall.gather_dim(x, group, n, dim, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        for group, n, dim, axis in reversed(ctx.steps):
            g = _reduce_scatter(g, group, n, dim, ctx.dtype, axis)
        return g, None, None


def gather(x: torch.Tensor, steps, dtype=None) -> torch.Tensor:
    """``x`` cast to ``dtype`` (None: its own) and all-gathered over each
    ``(group, n, dim, axis)`` of ``steps`` in turn (group rank i's block i
    along ``dim``), differentiable: the same values as gathering first
    and casting after, with half the bytes for bf16."""
    return _Gather.apply(x, steps, x.dtype if dtype is None else dtype)


def row_gather(x: torch.Tensor, block, dim: int = 1) -> torch.Tensor:
    """Every chunk of this rank's rows along ``dim``, from the ranks of its
    row group (``block``, a ``launch/mesh.TokenBlock`` with ``n > 1``) in
    chunk order (:func:`gather`: differentiable, the backward a
    reduce-scatter of the cotangent over the group); counted in
    ``row_gathers``."""
    global row_gathers
    row_gathers += 1
    return gather(x, ((block.group, block.n, dim, "row"),))


def make_layout(shapes, mesh_shape: Dict[str, int], rank: int, *,
                fsdp: bool, mesh=None, expert_tp: bool = False) -> Layout:
    """The layout of a tree of ``shapes`` (leaves with ``.shape``): each
    leaf's stored spec from its ``launch/mesh.param_shardings(fsdp=,
    expert_tp=)`` spec."""
    rules = mesh_lib.param_shardings(mesh_shape, shapes, fsdp=fsdp,
                                     expert_tp=expert_tp)
    leaves = dict(mesh_lib.tree_paths(shapes))
    specs = {p: storage_spec(p, spec, fsdp, mesh_shape, expert_tp,
                             leaves[p].shape)
             for p, spec in mesh_lib.spec_paths(rules)}
    return Layout(dict(mesh_shape), rank, fsdp, specs, mesh,
                  expert_tp=expert_tp)


# the budget the reference's dry run sizes a served tree's FSDP by
SERVE_FSDP_BUDGET = 4e9


def layout_for(cfg, mesh, fsdp: Optional[bool] = None, *,
               expert_tp: bool = False,
               budget_bytes: float = 6e9) -> Optional[Layout]:
    """This rank's layout of ``cfg``'s parameters on ``mesh`` (None for no
    mesh): ``fsdp=None`` asks the reference's ``needs_fsdp`` at
    ``budget_bytes`` (its default for a train state; serving's is
    :data:`SERVE_FSDP_BUDGET`); ``expert_tp`` stores the experts' f over
    ``data``."""
    if mesh is None:
        return None
    from repro_torch.convert import param_shapes
    shapes = param_shapes(cfg)
    if fsdp is None:
        fsdp = mesh_lib.needs_fsdp(mesh.shape, shapes,
                                   budget_bytes=budget_bytes)
    return make_layout(shapes, mesh.shape, mesh.rank, fsdp=fsdp, mesh=mesh,
                       expert_tp=expert_tp)


def serve_expert_tp(cfg, mesh) -> bool:
    """Whether a served ``cfg`` stores its experts' f over ``data``: a
    decode step runs expert TP on ``mesh`` (``REPRO_EXPERT_TP``, more
    than one rank: ``transformer.decode_expert_tp_axis``) and the config
    has a MoE layer."""
    from repro_torch.models.transformer import decode_expert_tp_axis
    return decode_expert_tp_axis(mesh) is not None and cfg.moe is not None


def serve_layout_for(cfg, mesh, fsdp: Optional[bool] = False
                     ) -> Optional[Layout]:
    """This rank's layout of a served ``cfg`` on ``mesh`` (None for no
    mesh), the reference's serving rule: ``expert_tp`` as
    :func:`serve_expert_tp` says, the dense leaves whole unless ``fsdp``
    (None: ``needs_fsdp`` at :data:`SERVE_FSDP_BUDGET`, as the
    reference's dry run asks it of a served tree)."""
    return layout_for(cfg, mesh, fsdp, expert_tp=serve_expert_tp(cfg, mesh),
                      budget_bytes=SERVE_FSDP_BUDGET)


# ---------------------------------------------------------------------------
# the served decode caches
# ---------------------------------------------------------------------------

# the form of an attention cache cut over model in each dim
CACHE_FORMS = {dim: form for form, dim in FORM_DIMS.items()}
# the recurrent state leaves a decode step can take cut over model
STATE_LEAVES = ("s", "conv")


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """A rank's storage of a served model's per-layer decode caches
    (``models/transformer.init_cache``'s tree, paths ``{layer}/k``,
    ``{layer}/sa/v``, ``{layer}/rwkv/s``, ...): ``layout`` holds each
    leaf's spec (``launch/mesh.cache_spec``, the reference's
    ``cache_shardings``) and the block arithmetic, ``shapes`` the whole
    caches as ``meta`` tensors, ``forms`` each layer's attention form
    (``heads``, ``positions``, ``channels`` or ``whole``; None for a
    layer without an attention cache), ``dims`` each layer's recurrent
    state leaves cut over ``model`` with the dim each is cut in, ``rows``
    the rows of the ``batch`` the rank holds."""
    layout: Layout
    shapes: Any
    forms: Tuple[Optional[str], ...]
    dims: Tuple[Tuple[Tuple[str, int], ...], ...]
    rows: slice
    batch: int

    @property
    def key(self) -> Tuple[Any, ...]:
        """What a step cache's key holds of it: the forms, the state
        cuts, the rows and the batch."""
        return (self.forms, self.dims, (self.rows.start, self.rows.stop),
                self.batch)

    def leaves(self) -> List[Dict[str, Any]]:
        """Per leaf: ``path``, the whole ``shape``, its ``spec``, this
        rank's ``block`` (slices), ``block_shape`` and ``bytes``."""
        out = []
        for path, leaf in mesh_lib.tree_paths(self.shapes):
            shp = self.layout.block_shape(path, leaf.shape)
            out.append(dict(
                path=path, shape=tuple(leaf.shape),
                spec=self.layout.specs[path],
                block=self.layout.block(path, leaf.shape), block_shape=shp,
                bytes=math.prod(shp) * DTYPE_BYTES[
                    str(leaf.dtype).removeprefix("torch.")]))
        return out

    @property
    def bytes(self) -> int:
        """Bytes of this rank's blocks of every cache leaf."""
        return sum(leaf["bytes"] for leaf in self.leaves())

    @property
    def whole_bytes(self) -> int:
        """Bytes of the whole caches (one process's)."""
        return sum(math.prod(t.shape) * DTYPE_BYTES[
            str(t.dtype).removeprefix("torch.")]
            for _, t in mesh_lib.tree_paths(self.shapes))

    def cut(self, layer: int) -> CacheCut:
        """Layer ``layer``'s :class:`CacheCut`: its attention cache's form
        (``whole`` for a layer without one) and its states' cut dims."""
        form = self.forms[layer] or "whole"
        mesh = self.layout.mesh
        c = self.shapes[layer]
        a = c["sa"] if "sa" in c else c
        length = a["k"].shape[1] if "k" in a else 0
        if mesh is None:
            return CacheCut("whole", length=length)
        return CacheCut(form, self.layout.mesh_shape.get("model", 1),
                        mesh.model_index, mesh.model_group, length,
                        self.dims[layer])

    def cuts(self) -> List[CacheCut]:
        return [self.cut(i) for i in range(len(self.forms))]

    def empty(self, device) -> List[Dict[str, Any]]:
        """This rank's blocks of the caches, zeroed, on ``device``."""
        return mesh_lib.map_paths(lambda p, t: torch.zeros(
            self.layout.block_shape(p, t.shape), dtype=t.dtype,
            device=device), self.shapes)


def _model_dim(spec) -> Optional[int]:
    """The dim ``spec`` cuts over ``model`` (None: none)."""
    dims = [d for d, e in enumerate(spec) if "model" in _axes(e)]
    return dims[0] if dims else None


def cache_layout_for(cfg, mesh, batch: int, cache_len: int,
                     long_context: bool = False, *,
                     rank: Optional[int] = None) -> Optional[CacheLayout]:
    """This rank's :class:`CacheLayout` of ``cfg``'s decode caches of
    ``batch`` rows and ``cache_len`` positions on ``mesh`` (a
    ``launch/mesh.Mesh``, or a shape mapping counted as ``rank``, default
    0); None without a mesh.  Every leaf is stored by
    ``launch/mesh.cache_spec`` (module docstring)."""
    if mesh is None:
        return None
    from repro_torch.models import transformer as T
    shape = mesh_lib._shape_of(mesh)
    if rank is None:
        rank = mesh.rank if isinstance(mesh, mesh_lib.Mesh) else 0
    dt = getattr(torch, cfg.dtype)
    kinds = T.layer_kinds(cfg)
    shapes = [T.init_cache(cfg, kind, batch, cache_len,
                           long_context=long_context, dtype=dt, device="meta")
              for kind in kinds]
    specs = {p: mesh_lib.cache_spec(shape, tuple(t.shape))
             for p, t in mesh_lib.tree_paths(shapes)}
    forms, dims = [], []
    for i, kind in enumerate(kinds):
        if T.attention_cache(shapes[i], kind) is None:
            forms.append(None)
        else:
            dim = _model_dim(specs[f"{i}/sa/k" if kind == "mamba_sa"
                                   else f"{i}/k"])
            forms.append("whole" if dim is None else CACHE_FORMS[dim])
        state = f"{i}/{'rwkv' if kind == 'rwkv' else 'mamba'}"
        cut = [(name, _model_dim(specs[f"{state}/{name}"]))
               for name in STATE_LEAVES if f"{state}/{name}" in specs]
        dims.append(tuple((name, d) for name, d in cut if d is not None))
    real = mesh if isinstance(mesh, mesh_lib.Mesh) else None
    return CacheLayout(Layout(dict(shape), rank, False, specs, real), shapes,
                       tuple(forms), tuple(dims),
                       mesh_lib.served_rows(real or shape, batch), batch)
