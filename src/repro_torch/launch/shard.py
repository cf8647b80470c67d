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
over them, and over no axis it is replicated on).

The block arithmetic depends on the mesh's shape and the rank only, so a
process with no group (a test, a one-process restore) can cut any rank's
blocks; the collectives need the rank's ``launch/mesh.Mesh``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import alltoall
from repro_torch.launch import mesh as mesh_lib
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


def storage_spec(path: str, spec: mesh_lib.Spec, fsdp: bool,
                 mesh_shape: Dict[str, int]) -> mesh_lib.Spec:
    """The spec ``path`` is stored by, from ``spec``, its spec in
    ``launch/mesh.param_shardings(fsdp=fsdp)`` (module docstring): with
    FSDP that spec; without it the experts' E over ``model`` only.
    Raises when an expert leaf's E does not divide over ``model``."""
    expert = is_expert(path)
    if expert and mesh_shape.get("model", 1) > 1 and spec[0] != "model":
        raise ValueError(f"{path}: its experts do not divide over "
                         f"model={mesh_shape['model']}")
    if fsdp:
        return spec
    return tuple(s if expert and d == 0 else None
                 for d, s in enumerate(spec))


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank ``rank``'s storage of a parameter tree on a mesh of shape
    ``mesh_shape`` (``{"data": D, "model": M}``): ``specs`` maps each
    leaf's path to its stored spec.  ``mesh`` (this rank's
    ``launch/mesh.Mesh``) is needed for the collectives only."""
    mesh_shape: Dict[str, int]
    rank: int
    fsdp: bool
    specs: Dict[str, mesh_lib.Spec]
    mesh: Any = None

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

    def cut_tree(self, tree, prefix: str = ""):
        return mesh_lib.map_paths(self.cut, tree, prefix)

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

    def _steps(self, axes) -> Tuple[Tuple[Any, int, int], ...]:
        return tuple((self.group((a,)), self.mesh_shape[a], dim)
                     for a, dim in axes)

    # -- gathers ----------------------------------------------------------

    def whole(self, tree, prefix: str = "", dtype=None):
        """``tree`` (the leaves under ``prefix``) with every leaf gathered
        for use (:func:`gather`, differentiable), in ``dtype`` (the
        compute dtype; None: the stored one) unless the model uses the
        leaf in f32 (``transformer._F32_LEAVES``); a leaf stored whole is
        returned as it is."""
        def one(path, t):
            global gathers
            axes = self.gather_axes(path)
            if not axes:
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


def _all_gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    out = alltoall.gather_rows(x.movedim(dim, 0), group, n)
    return out.movedim(0, dim).contiguous()


# the most bytes of a rank's blocks that one exchange of a reduce-scatter
# sends: a whole table's gradient crosses in pieces, not in a second
# whole-size copy
_PIECE_BYTES = 1 << 28


def _reduce_scatter(x: torch.Tensor, group, n: int, dim: int,
                    dtype) -> torch.Tensor:
    """Block r (of ``n`` along ``dim``) of the sum over ``group`` of ``x``,
    in ``dtype``.  The blocks cross in ``x``'s own dtype (a bf16
    cotangent: half the bytes of an f32 one) and each rank sums the ``n``
    it receives in ``dtype``, in group-rank order — at n = 2 exactly the
    sum of the blocks cast first — a piece of at most ``_PIECE_BYTES``
    at a time."""
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
        for group, n, dim in steps:
            x = _all_gather(x, group, n, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for group, n, dim in reversed(ctx.steps):
            g = _reduce_scatter(g, group, n, dim, ctx.dtype)
        return g, None, None


def gather(x: torch.Tensor, steps, dtype=None) -> torch.Tensor:
    """``x`` cast to ``dtype`` (None: its own) and all-gathered over each
    ``(group, n, dim)`` of ``steps`` in turn (group rank i's block i along
    ``dim``), differentiable: the same values as gathering first and
    casting after, with half the bytes for bf16."""
    return _Gather.apply(x, steps, x.dtype if dtype is None else dtype)


def row_gather(x: torch.Tensor, block, dim: int = 1) -> torch.Tensor:
    """Every chunk of this rank's rows along ``dim``, from the ranks of its
    row group (``block``, a ``launch/mesh.TokenBlock`` with ``n > 1``) in
    chunk order (:func:`gather`: differentiable, the backward a
    reduce-scatter of the cotangent over the group); counted in
    ``row_gathers``."""
    global row_gathers
    row_gathers += 1
    return gather(x, ((block.group, block.n, dim),))


def make_layout(shapes, mesh_shape: Dict[str, int], rank: int, *,
                fsdp: bool, mesh=None) -> Layout:
    """The layout of a tree of ``shapes`` (leaves with ``.shape``): each
    leaf's stored spec from its ``launch/mesh.param_shardings`` spec."""
    rules = mesh_lib.param_shardings(mesh_shape, shapes, fsdp=fsdp)
    specs = {p: storage_spec(p, spec, fsdp, mesh_shape)
             for p, spec in mesh_lib.spec_paths(rules)}
    return Layout(dict(mesh_shape), rank, fsdp, specs, mesh)


def layout_for(cfg, mesh, fsdp: Optional[bool] = None) -> Optional[Layout]:
    """This rank's layout of ``cfg``'s parameters on ``mesh`` (None for no
    mesh): ``fsdp=None`` asks the reference's ``needs_fsdp``."""
    if mesh is None:
        return None
    from repro_torch.convert import param_shapes
    shapes = param_shapes(cfg)
    if fsdp is None:
        fsdp = mesh_lib.needs_fsdp(mesh.shape, shapes)
    return make_layout(shapes, mesh.shape, mesh.rank, fsdp=fsdp, mesh=mesh)
