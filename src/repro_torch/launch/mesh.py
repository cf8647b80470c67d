"""The ``(data, model)`` grid of ranks — the port of ``repro/launch/mesh.py``
for one process per rank.

The reference runs one SPMD program over a ``jax.sharding.Mesh``; the port
runs one process per rank with explicit ``torch.distributed`` collectives.
:func:`make_mesh` lays the ranks of an initialized process group out as the
reference lays out its devices: global rank ``r = d·M + m`` (data-major),
so rank r holds the r-th contiguous block of the flattened (B·S) tokens,
as ``P(("data", "model"))`` gives device r.  Experts shard over ``model``
(rank m holds experts ``[m·E/M, (m+1)·E/M)``) and replicate over ``data``.

Groups (every rank creates every group, in the same order, as
``torch.distributed.new_group`` requires):

* one ``model`` group per data row — where the AllToAll runs;
* one ``data`` group per model column — where expert gradients reduce,
  and where expert TP gathers and reduce-scatters (data index ``di`` =
  ``rank // M`` is the rank's place in it);
* for every two-stage factoring ``model = outer × inner`` (``1 < inner <
  M``, inner dividing M), the hierarchical AllToAll's ``inner`` groups of
  consecutive model ranks (one "node") and ``outer`` groups of strided
  ones (rank i of every node), as ``core/alltoall.py:45-52`` of the
  reference;
* for each size ``n`` the caller names (``rows=``), the ``row`` groups
  of ``n`` consecutive ranks — the ranks that share a batch row when a
  batch of W/n rows trains over W ranks (:func:`token_block`); a group
  with the members of a model, inner or the world group is that group.

Rank r holds the r-th contiguous block of the flattened (B·S) tokens of
a training batch (:func:`token_block`): B/W whole rows when the world W
divides B, else, when B divides W and n = W/B divides S, the chunk of S/n
positions ``(r mod n)`` of row ``r // n``, attended context-parallel over
its row group (``models/attention.full_attention``).

The backend is always the caller's: ``nccl`` on a host with one card per
rank, ``gloo`` on the CPU (and on a card only where the caller names it,
as ``chip_smoke.py`` does to run several ranks on one card).  Nothing here
picks another backend when one fails.  A rank's device is
``cuda:{LOCAL_RANK % device_count}`` unless the caller passes
``device="cpu"``.

:func:`spawn` starts local ranks (the tests, ``chip_smoke.py``) over a
``file://`` rendezvous in a temporary directory, so no port is fixed;
``launch/train.py`` also runs under ``torchrun``, which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``.

The parameter sharding rules are the reference's (``_RULES``,
:func:`fit_spec`, :func:`needs_fsdp`, :func:`param_shardings`,
:func:`state_shardings`) as pure functions of the mesh's shape, a mapping
such as ``{"data": 2, "model": 2}``: a spec is a tuple with one entry per
dim, an axis name, a tuple of axis names or None, where the reference has
a ``PartitionSpec``.  The port keeps one dict per layer where the
reference stacks its blocks over super-blocks, so a port leaf's spec is
the reference's for the same key without the scan dim.  How the port
stores a train state by these specs, and gathers it for use, is
``launch/shard.py``.  Production meshes come with a later slice
(ROADMAP.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import multiprocessing as mp
import os
import pathlib
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("nccl", "gloo")


def parse_mesh(spec: str) -> Tuple[int, ...]:
    """Parse a ``--mesh`` string like ``1x1`` / ``2x4`` into a shape
    tuple, with a clear error for typos (``16x``, ``axb``, ``0x4``)."""
    parts = str(spec).split("x")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        dims = ()
    if not dims or any(d < 1 for d in dims):
        raise ValueError(
            f"--mesh expects 'DxM' with positive integers (e.g. '1x1', "
            f"'16x16', or '2x16x16' for multi-pod), got {spec!r}")
    return dims


def mesh_cli_arg(spec: str):
    """argparse ``type=`` adapter for :func:`parse_mesh`."""
    try:
        return parse_mesh(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def parse_fabric(name: str):
    """Parse a ``--fabric`` name into ``(name, (fast, slow))``, a named
    ``LinkSpec`` pair of ``core/alltoall.FABRICS`` (``pcie_eth100``).  A
    typo raises a ValueError listing the valid fabrics."""
    from repro_torch.core import alltoall
    key = str(name).strip().lower()
    if key not in alltoall.FABRICS:
        raise ValueError(
            f"--fabric expects one of {tuple(alltoall.FABRICS)} (named "
            f"fast/slow LinkSpec pairs in core/alltoall.py), got {name!r}")
    return key, alltoall.FABRICS[key]


def fabric_cli_arg(name: str):
    """argparse ``type=`` adapter for :func:`parse_fabric`."""
    try:
        return parse_fabric(name)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _inner_groups(outer: int, inner: int) -> List[List[int]]:
    """Groups of consecutive model ranks — one per 'node'."""
    return [[o * inner + i for i in range(inner)] for o in range(outer)]


def _outer_groups(outer: int, inner: int) -> List[List[int]]:
    """Strided groups — model rank i of every node."""
    return [[o * inner + i for o in range(outer)] for i in range(inner)]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its groups.

    ``shape`` is ``{"data": D, "model": M}`` (the reference's
    ``mesh.shape``); ``model_group`` and ``data_group`` are the process
    groups of this rank's data row and model column; ``hier`` maps each
    two-stage ``inner`` to this rank's ``(inner_group, outer_group)``,
    ``rows`` each row-group size n to this rank's group of n consecutive
    ranks; the default group spans the world."""
    shape: Dict[str, int]
    rank: int
    backend: str
    device: torch.device
    model_group: Any
    data_group: Any
    hier: Dict[int, Tuple[Any, Any]]
    rows: Dict[int, Any] = dataclasses.field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def data_index(self) -> int:
        """This rank's place in its data group (and the f-slice of its
        experts that expert TP computes with)."""
        return self.rank // self.shape["model"]

    def hierarchical_groups(self, inner: int) -> Tuple[Any, Any]:
        """``(inner_group, outer_group)`` of this rank for a two-stage
        AllToAll with ``inner`` consecutive ranks per node."""
        if inner not in self.hier:
            raise ValueError(
                f"no hierarchical groups for inner={inner} on a model axis "
                f"of {self.shape['model']} (two-stage factorings: "
                f"{sorted(self.hier)})")
        return self.hier[inner]

    def describe(self) -> str:
        return (f"{self.shape['data']}x{self.shape['model']} "
                f"backend={self.backend} ranks={self.world}")


def _two_stage_inners(M: int) -> List[int]:
    return [i for i in range(2, M) if M % i == 0]


def make_mesh(shape: Sequence[int], *, backend: Optional[str] = None,
              device=None, rows: Sequence[int] = ()) -> Mesh:
    """The mesh of this rank over the initialized default process group.
    ``shape`` is ``(D, M)``; the world size must be ``D·M``.  ``backend``
    defaults to the process group's own; ``device`` to
    ``cuda:{LOCAL_RANK % device_count}`` (pass ``"cpu"`` for the CPU);
    ``rows`` the sizes n > 1 of the row groups a training batch splits
    its rows over (``cut_tokens(...).n``)."""
    if len(shape) != 2:
        raise ValueError(f"mesh shape must be (data, model), got "
                         f"{tuple(shape)}")
    D, M = (int(s) for s in shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh({D}x{M}) needs an initialized process group (run "
            f"under torchrun, or through launch.mesh.spawn)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != D * M:
        raise ValueError(f"mesh {D}x{M} needs {D * M} ranks, the process "
                         f"group has {world}")
    pg_backend = dist.get_backend()
    if backend is not None and backend != pg_backend:
        raise ValueError(f"backend={backend!r} but the process group runs "
                         f"{pg_backend!r}")
    dev = resolve_device(device)                 # raises without a GPU
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # every rank creates every group, in this order
    model_group = data_group = None
    for d in range(D):
        g = dist.new_group([d * M + m for m in range(M)])
        if d == rank // M:
            model_group = g
    for m in range(M):
        g = dist.new_group([d * M + m for d in range(D)])
        if m == rank % M:
            data_group = g
    hier = {}
    for inner in _two_stage_inners(M):
        outer = M // inner
        mine = [None, None]
        for stage, groups in enumerate((_inner_groups(outer, inner),
                                        _outer_groups(outer, inner))):
            for d in range(D):
                for members in groups:
                    g = dist.new_group([d * M + r for r in members])
                    if rank in [d * M + r for r in members]:
                        mine[stage] = g
        hier[inner] = tuple(mine)
    row_groups = {}
    for n in sorted(set(rows) - {1}):
        if (D * M) % n:
            raise ValueError(f"no row groups of {n} ranks on mesh {D}x{M}")
        if n == D * M:
            row_groups[n] = dist.group.WORLD
        elif n == M:
            row_groups[n] = model_group
        elif n in hier:
            row_groups[n] = hier[n][0]
        else:
            for start in range(0, D * M, n):
                g = dist.new_group(list(range(start, start + n)))
                if start <= rank < start + n:
                    row_groups[n] = g
    return Mesh({"data": D, "model": M}, rank, pg_backend, dev, model_group,
                data_group, hier, row_groups)


def make_smoke_mesh(shape: Tuple[int, ...] = (1, 1), *,
                    backend: Optional[str] = None, device=None,
                    rows: Sequence[int] = ()) -> Optional[Mesh]:
    """The reference's name for a small mesh: None for ``1x1`` (the
    one-device path needs no group), else :func:`make_mesh`."""
    if math.prod(shape) == 1:
        return None
    return make_mesh(shape, backend=backend, device=device, rows=rows)


def dp_axes(mesh: Optional[Mesh]) -> Tuple[str, ...]:
    return () if mesh is None else ("data",)


# ---------------------------------------------------------------------------
# parameter sharding rules (path + ndim -> spec), the reference's
# ---------------------------------------------------------------------------

# trailing-dim specs keyed by leaf name; leading dims (the reference's scan
# dim) are unsharded
_RULES = {
    # embeddings / head
    "embed":   ("model", "data"),
    "lm_head": ("data", "model"),
    # attention
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "wo": ("model", "data"),
    # mlp (and rwkv channel-mix)
    "w_in_mlp":  ("data", "model"),
    "w_out_mlp": ("model", "data"),
    # moe experts: (E, d, f) / (E, f, d) — EP over model + FSDP(d) over data
    "w_up_moe":   ("model", "data", None),
    "w_gate_moe": ("model", "data", None),
    "w_out_moe":  ("model", None, "data"),
    # expert-TP serving layout (decode): f dim over data
    "w_up_moe_tp":   ("model", None, "data"),
    "w_gate_moe_tp": ("model", None, "data"),
    "w_out_moe_tp":  ("model", "data", None),
    "gate_w": (None, None),
    # mamba2
    "w_in_mamba":  ("data", "model"),
    "w_out_mamba": ("model", "data"),
    "conv_w": (None, "model"), "conv_b": ("model",),
    # rwkv6
    "wr": ("data", "model"), "wg": ("data", "model"),
    "mix_a": ("data", None), "decay_a": ("data", None),
    # zamba2 lora
    "sa_lora_a": ("data", None), "sa_lora_b": (None, "data"),
}
Spec = Tuple[Any, ...]


def _leaf_spec(path: str, ndim: int, expert_tp: bool = False) -> Spec:
    """The rule of the leaf at ``path`` (``/``-joined keys), padded with
    leading Nones to ``ndim`` dims; norms, biases and vectors replicate."""
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    key = name
    if name in ("w_in", "w_out", "w_up", "w_gate"):
        if parent == "moe":
            key = f"{name}_moe" + ("_tp" if expert_tp else "")
        elif parent == "mamba":
            key = f"{name}_mamba"
        else:
            key = f"{name}_mlp"
    spec = tuple(_RULES.get(key, ()))
    lead = ndim - len(spec)
    if lead < 0:
        raise ValueError(f"{path}: {ndim} dims, rule {spec}")
    return (None,) * lead + spec


def fit_spec(mesh_shape: Dict[str, int], spec: Spec, shape) -> Spec:
    """Drop spec axes that don't exist in the mesh or don't divide the
    dimension (e.g. vocab 92553 on a 16-wide axis, batch 1 on data); one
    entry per dim of ``shape``."""
    dims = []
    for i, s in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if s is None:
            dims.append(None)
            continue
        axes = tuple(a for a in (s if isinstance(s, tuple) else (s,))
                     if a in mesh_shape)
        n = math.prod(mesh_shape[a] for a in axes)
        if n <= 1 or shape[i] % n != 0:
            dims.append(None)
        else:
            dims.append(axes if len(axes) > 1 else axes[0])
    return tuple(dims)


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of a parameter tree in ``tree.leaves`` order (dict
    keys sorted, sequence indices), paths ``/``-joined as the reference
    names them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def spec_paths(specs, prefix: str = ""):
    """``(path, spec)`` of a tree of specs (:func:`param_shardings`), in
    :func:`tree_paths` order: a spec is a tuple, so only dicts and lists
    are walked into."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from spec_paths(specs[k], f"{prefix}/{k}" if prefix
                                  else str(k))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from spec_paths(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, specs


def map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a parameter tree, in its structure."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_paths(fn, v, f"{prefix}/{i}" if prefix
                                     else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def needs_fsdp(mesh_shape: Dict[str, int], params_shapes, *,
               budget_bytes: float = 6e9) -> bool:
    """FSDP-shard weights over data iff master+moments (12 B/param) would
    exceed ``budget_bytes`` per device under model-axis sharding alone."""
    total = sum(math.prod(leaf.shape) for _, leaf in tree_paths(
        params_shapes))
    return total * 12.0 / mesh_shape.get("model", 1) > budget_bytes


def param_shardings(mesh_shape: Dict[str, int], params_shapes, *,
                    fsdp: bool = True, expert_tp: bool = False):
    """A tree of specs matching a params (or moments) tree, whose leaves
    have ``.shape``.  ``fsdp=False`` drops the data-axis (ZeRO) sharding;
    ``expert_tp=True`` gives the expert weights the serving (decode)
    layout, f over data."""
    return map_paths(lambda path, leaf: leaf_spec(
        mesh_shape, path, leaf.shape, fsdp=fsdp, expert_tp=expert_tp),
        params_shapes)


def leaf_spec(mesh_shape: Dict[str, int], path: str, shape, *,
              fsdp: bool = True, expert_tp: bool = False) -> Spec:
    """:func:`param_shardings`' spec of the one leaf at ``path``."""
    spec = _leaf_spec(path, len(shape), expert_tp)
    if not fsdp and not (expert_tp and "/moe/" in path):
        spec = tuple(None if s == "data" else s for s in spec)
    return fit_spec(mesh_shape, spec, shape)


def state_shardings(mesh_shape: Dict[str, int], state_shapes, *,
                    fsdp: Optional[bool] = None):
    """Specs for a ``TrainState``: params and moments by the rules, every
    other field (step and the fault-tolerance scalars) replicated
    (``()``); ``fsdp=None`` asks :func:`needs_fsdp`."""
    if fsdp is None:
        fsdp = needs_fsdp(mesh_shape, state_shapes.params)
    scalars = {f: (None if getattr(state_shapes, f) is None else ())
               for f in type(state_shapes)._fields
               if f not in ("params", "opt")}
    return type(state_shapes)(
        params=param_shardings(mesh_shape, state_shapes.params, fsdp=fsdp),
        opt={"m": param_shardings(mesh_shape, state_shapes.opt["m"],
                                  fsdp=fsdp),
             "v": param_shardings(mesh_shape, state_shapes.opt["v"],
                                  fsdp=fsdp),
             "count": ()},
        **scalars)


@dataclasses.dataclass(frozen=True)
class TokenBlock:
    """A rank's block of a (B, S) batch's flattened tokens: ``rows`` of the
    batch and ``seq`` of each row.  ``n`` ranks share each row (1: the
    block is whole rows), ``S`` is a whole row's length and ``group`` the
    row group (None when ``n`` is 1)."""
    rows: slice
    seq: slice
    n: int
    S: int
    group: Any = None

    @property
    def flat(self) -> slice:
        """The block's tokens among the batch's flattened B·S."""
        start = self.rows.start * self.S + self.seq.start
        size = (self.rows.stop - self.rows.start) * (
            self.seq.stop - self.seq.start)
        return slice(start, start + size)

    def positions(self, device=None) -> torch.Tensor:
        """The block's positions in its rows, int32."""
        return torch.arange(self.seq.start, self.seq.stop, dtype=torch.int32,
                            device=device)


def cut_tokens(shape: Sequence[int], rank: int, B: int, S: int
               ) -> TokenBlock:
    """Rank ``rank``'s block of a (B, S) batch on a mesh of ``shape`` (D,
    M) (no group): B/W whole rows when the world W = D·M divides B; the
    chunk ``rank mod n`` of S/n positions of row ``rank // n`` when n =
    W/B is a whole number that divides S; else ``ValueError`` naming B,
    S and the mesh."""
    world = math.prod(shape)
    if B % world == 0:
        b = B // world
        return TokenBlock(slice(rank * b, (rank + 1) * b), slice(0, S), 1, S)
    n = world // B if B and world % B == 0 else 0
    if n and S % n == 0:
        L = S // n
        c = rank % n
        return TokenBlock(slice(rank // n, rank // n + 1),
                          slice(c * L, (c + 1) * L), n, S)
    raise ValueError(
        f"batch {B} x seq {S} does not cut into {world} token blocks on "
        f"mesh {'x'.join(str(int(d)) for d in shape)}: the batch's rows "
        f"must divide over the {world} ranks, or the ranks over the rows "
        f"with the sequence divisible by the {world}/{B} ranks that share "
        f"a row")


def token_block(mesh: Optional[Mesh], B: int, S: int) -> TokenBlock:
    """This rank's :class:`TokenBlock` of a (B, S) batch on ``mesh`` (None:
    the whole batch), its row group attached.  Raises ``ValueError``
    naming B, S and the mesh when the batch does not cut
    (:func:`cut_tokens`)."""
    if mesh is None:
        return TokenBlock(slice(0, B), slice(0, S), 1, S)
    blk = cut_tokens((mesh.shape["data"], mesh.shape["model"]), mesh.rank,
                     B, S)
    if blk.n == 1:
        return blk
    if blk.n not in mesh.rows:
        raise ValueError(f"batch {B} x seq {S} splits each row over {blk.n} "
                         f"ranks, and mesh {mesh.describe()} has no row "
                         f"groups of {blk.n} (make_mesh(rows=({blk.n},)))")
    return dataclasses.replace(blk, group=mesh.rows[blk.n])


# ---------------------------------------------------------------------------
# local ranks
# ---------------------------------------------------------------------------

def _entry(rank: int, world: int, backend: str, init_file: str,
           threads: Optional[int], fn: Callable, args: tuple, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, *, backend: str, args: tuple = (),
          init_file: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes (the ``spawn``
    start method) that share one process group of ``backend`` through a
    ``file://`` rendezvous (``init_file``, default a file in a new
    temporary directory: no port is fixed).  ``fn`` must be importable by
    name and its return value picklable.  Returns the ranks' return
    values in rank order; raises with the failing ranks' tracebacks if
    any rank fails or the ranks outlast ``timeout`` seconds.  Every
    process started is ended before it returns.  ``threads`` sets
    ``torch.set_num_threads`` in each rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        path = init_file or str(pathlib.Path(tmp) / "rendezvous")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, backend, path, threads, fn,
                                   tuple(args), results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got: Dict[int, Tuple[str, Any]] = {}
        try:
            # drain the queue before joining (a full pipe blocks a writer)
            deadline = time.monotonic() + timeout
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {world - len(got)} of {world} ranks gave no "
                        f"result within {timeout:.0f} s")
                try:
                    rank, status, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in got]
                    if dead:
                        # a rank died without reporting (killed, segfault)
                        raise RuntimeError(
                            f"spawn: ranks {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]}")
                    continue
                got[rank] = (status, out)
                if status == "error":
                    break
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0)
                       if len(got) == world else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
    errors = {r: out for r, (s, out) in got.items() if s == "error"}
    if errors:
        raise RuntimeError("spawn: ranks failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(errors.items())))
    return [got[r][1] for r in range(world)]
