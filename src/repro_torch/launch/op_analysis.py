"""What a recorded run executed: FLOPs, HBM bytes, launches, collectives
and the live bytes' high-water mark — the port's twin of
``repro/launch/hlo_analysis.py`` and of the reference dry run's XLA
``memory_analysis``.

The reference reads the compiled HLO module: each top-level (unfused) op
is a unit of HBM traffic, its operands read and its result written.  In
eager PyTorch each launched op is such a unit, and
``analysis/graph.trace_graph`` records every one of them with its dtypes
and shapes.  :func:`analyze` reads that record (an ``OpGraph``):

  flops        2·M·N·K over every matmul-family aten op (``mm``, ``bmm``,
               ``addmm``, ``baddbmm``, ``_scaled_mm``, and ``matmul``,
               ``linear`` and ``einsum``, which reach the recorder whole
               under ``inference_mode`` — an einsum's operands contracted
               left to right, 2 operations for each point of each pair's
               joint index space; ``convolution``:
               2·numel(out)·C_in/groups·kernel) outside a kernel wrapper,
               plus each wrapper call's own products
               (``kernels/ops.COSTS``, kept beside each wrapper: 2·M·K·N
               for the grouped matmuls, the products over the tiles they
               visit for the flash kernels)
  hbm_bytes    Σ operand + result bytes per launched unit: an aten op
               outside any wrapper, or one wrapper call (its cost's
               bytes).  The aten ops of a plain version under its
               wrapper are the kernel's inside and excluded, as XLA's
               fused ops are; so are views and metadata ops, which move
               nothing (``prim`` ops such as ``prim.device``; an op
               whose results alias its operands and that is not in place,
               the site's ``view``; and :data:`NO_TRAFFIC`: ``view``, ``_unsafe_view``,
               ``reshape`` without a copy, ``expand``, ``t``,
               ``transpose``, ``permute``, ``as_strided``, ``slice``,
               ``select``, ``unsqueeze``, ``squeeze``, ``detach``,
               ``alias`` and the other views, and the allocations
               ``empty``, ``empty_strided``, ``empty_like``,
               ``new_empty``)
  traffic_top  the 20 largest units
  collectives  wire bytes by kind (``core/alltoall.Collective``'s rule,
               the one ``launch/dryrun.collectives_record`` uses), the
               count, and the log itself for the node test
  launches     launched units by kernel wrapper and by aten op

There is no loop to correct for: eager PyTorch runs every iteration.
:class:`MemoryTracker` follows the live bytes of tensor storages over a
run (storage identity, a ``weakref`` finalizer on each storage) and
reports the reference's ``memory_analysis`` keys.  Both read only shapes,
dtypes and storages, so they work on the fake tensors of
``launch/dryrun.execute_pair`` (``torch._subclasses.FakeTensorMode``)
as on real ones.
"""
from __future__ import annotations

import collections
import math
import weakref
from typing import Any, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_lib
from repro_torch.core.alltoall import Collective
from repro_torch.kernels import ops

# aten ops that move no bytes: views and metadata, and allocations (no
# kernel runs for them)
NO_TRAFFIC = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "t",
    "transpose", "permute", "as_strided", "slice", "select", "unsqueeze",
    "squeeze", "detach", "alias", "split", "split_with_sizes", "unbind",
    "narrow", "unfold", "diagonal", "view_as_real", "view_as_complex",
    "lift_fresh", "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided"))
TOP = 20


def _nbytes(dtypes, shapes) -> int:
    return sum(math.prod(s) * ops.itemsize(d)
               for d, s in zip(dtypes, shapes))


def matmul_flops(site) -> float:
    """2·M·N·K of one matmul-family aten site (0 for any other op)."""
    sh = site.in_shapes
    if site.op in ("aten.mm", "aten._scaled_mm"):
        (m, k), n = sh[0], sh[1][-1]
        return 2.0 * m * k * n
    if site.op == "aten.addmm":
        (m, k), n = sh[1], sh[2][-1]
        return 2.0 * m * k * n
    if site.op == "aten.bmm":
        (b, m, k), n = sh[0], sh[1][-1]
        return 2.0 * b * m * k * n
    if site.op == "aten.baddbmm":
        (b, m, k), n = sh[1], sh[2][-1]
        return 2.0 * b * m * k * n
    if site.op == "aten.matmul":
        return 2.0 * math.prod(site.out_shapes[0]) * sh[0][-1]
    if site.op == "aten.linear":
        return 2.0 * math.prod(site.out_shapes[0]) * sh[1][-1]
    if site.op == "aten.einsum":
        return einsum_flops(site.statics[0], sh)
    if site.op == "aten.convolution":
        w, out = sh[1], site.out_shapes[0]
        return 2.0 * math.prod(out) * math.prod(w[1:])
    return 0.0


def einsum_flops(equation: str, shapes) -> float:
    """An einsum's operands contracted left to right: 2 operations for
    each point of each pair's joint index space (a one-operand einsum
    multiplies nothing)."""
    lhs, out = equation.replace(" ", "").split("->")
    terms = lhs.split(",")
    size = {c: n for t, s in zip(terms, shapes) for c, n in zip(t, s)}
    total, cur = 0.0, terms[0]
    for i, t in enumerate(terms[1:], 1):
        joint = set(cur) | set(t)
        total += 2.0 * math.prod(size[c] for c in joint)
        later = set(out).union(*terms[i + 1:])
        cur = "".join(c for c in joint if c in later)
    return total


def kernel_cost(site) -> ops.Cost:
    """A kernel-wrapper site's cost (``kernels/ops.COSTS``)."""
    return ops.COSTS[site.op](ops.KernelCall(site.op, site.in_dtypes,
                                             site.in_shapes, site.statics))


def analyze(graph) -> Dict[str, Any]:
    """The executed FLOPs, HBM bytes, top units, collectives and launches
    of ``graph`` (an ``analysis/graph.OpGraph``; module docstring).
    ``kernels`` holds each wrapper's launches, FLOPs, bytes and summed
    bound (``Cost.bound_s``)."""
    flops = hbm = 0.0
    units: List[tuple] = []
    launches: collections.Counter = collections.Counter()
    kernels: Dict[str, Dict[str, float]] = {}
    log: List[Collective] = []
    for s in graph.sites():
        if s.kind == "collective":
            log.append(Collective(s.op, s.axis, s.n, s.in_dtypes[0],
                                  s.in_shapes[0]))
            continue
        if s.kind == "kernel":
            c = kernel_cost(s)
            k = kernels.setdefault(s.op, dict(launches=0, flops=0.0,
                                              bytes=0.0, bound_s=0.0))
            k["launches"] += 1
            k["flops"] += c.flops
            k["bytes"] += c.bytes
            k["bound_s"] += c.bound_s
            if c.matmul:
                flops += c.flops
            nbytes = c.bytes
        elif s.stack:
            continue                  # a plain version's inside
        else:
            space, name = s.op.split(".", 1)
            if space == "prim" or s.view or name in NO_TRAFFIC:
                continue
            flops += matmul_flops(s)
            nbytes = (_nbytes(s.in_dtypes, s.in_shapes)
                      + _nbytes(s.out_dtypes, s.out_shapes))
        launches[s.op] += 1
        hbm += nbytes
        units.append((nbytes, s.describe()))
    units.sort(key=lambda u: -u[0])
    by_kind: Dict[str, float] = collections.defaultdict(float)
    for c in log:
        by_kind[c.kind] += c.wire_bytes
    return {
        "flops": flops,
        "hbm_bytes": hbm,
        "traffic_top": [{"bytes": b, "op": d} for b, d in units[:TOP]],
        "collectives": {"bytes_by_kind": dict(by_kind),
                        "total_wire_bytes": sum(by_kind.values()),
                        "count": len(log), "log": log},
        "launches": dict(launches),
        "kernels": kernels,
    }


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_lib.leaves(tree) if isinstance(t, torch.Tensor)]


class MemoryTracker(TorchDispatchMode):
    """The live bytes of tensor storages over a run.

    ``with MemoryTracker(args) as mt: out = fn(*args)`` counts the
    storages of ``args`` (any tree: the state, the batch, the caches, a
    model's weights) as live at entry, then every storage an op creates,
    each until Python frees it (a ``weakref.finalize`` on the storage);
    :meth:`report` ``(out)`` gives the reference's ``memory_analysis``:

      argument_bytes          live at entry
      output_bytes            the storages of ``out``
      alias_bytes             those of them that are arguments' (an
                              in-place update, as a decode step writes
                              its caches)
      temp_bytes              the high-water mark above the arguments
                              and the outputs' new bytes
      peak_per_device_bytes   arguments + temp + output − alias: the
                              high-water mark of the live bytes

    Bytes are storage bytes; a card's caching allocator rounds each
    block up (to 512 B) and holds workspaces no op returns (cuBLAS's)."""

    def __init__(self, args=()):
        super().__init__()
        self._live: Dict[int, int] = {}
        self._args: Dict[int, int] = {}
        self.live = 0
        self.high = 0
        for t in _tensors(args):
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args[id(st)] = st.nbytes()
                self._add(st)
        self.argument_bytes = sum(self._args.values())

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)
        self._args.pop(key, None)

    def _add(self, st) -> None:
        key = id(st)
        n = st.nbytes()
        old = self._live.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
        self._live[key] = n
        self.live += n - (old or 0)
        self.high = max(self.high, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._add(t.untyped_storage())
        return out

    def report(self, out) -> Dict[str, int]:
        """The ``memory_analysis`` of the run that returned ``out``."""
        seen: Dict[int, int] = {}
        for t in _tensors(out):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        output = sum(seen.values())
        alias = sum(n for k, n in seen.items() if k in self._args)
        temp = self.high - self.argument_bytes - (output - alias)
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": output, "temp_bytes": temp,
                "alias_bytes": alias,
                "peak_per_device_bytes": self.argument_bytes + temp
                + output - alias}
