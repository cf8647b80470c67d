"""The op graph the lint rules read: the record of what the port ran —
the port of ``repro/analysis/graph.py``.

The reference walks a traced jaxpr.  Eager PyTorch has no program to
walk before it runs, so the port's graph is the ordered list of what one
run of a function did, recorded by :func:`trace_graph`:

* every aten op, seen by a ``TorchDispatchMode`` (``c10d`` collectives
  reach it too, as ``c10d.alltoall_base_`` and the like);
* every bulk collective of ``core/alltoall.collectives``, as a site named
  by its kind (``all_to_all``, ``all_gather``, ``reduce_scatter``,
  ``all_reduce``) carrying the rank's input dtype and shape (an
  AllToAll's output has its input's shape) and the axis of its group;
* every kernel-wrapper call of ``kernels/ops.calls``, on either route
  (``cuda``: the kernel; ``cpu``: its plain version), named by the
  wrapper (``grouped_matmul``, ``grouped_drhs``, ...).

Each :class:`OpSite` carries its ``phase`` (``fwd``, or ``bwd`` for what
the backward of the summed output ran) and the kernel wrappers it ran
inside (the plain version's aten ops under their wrapper), so a site's
structural path reads ``bwd/grouped_matmul_t/aten.mm``: a finding names
where in the program the invariant broke.  There is no loop body to
recurse into and no ``"hlo"`` kind; the graph's kind is ``"ops"``.
:class:`ProbeGraph` is the reference's, for rules over runtime evidence.
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import alltoall
from repro_torch.kernels import ops

class OpSite(NamedTuple):
    """One recorded op: ``op`` (``aten.mm``, ``c10d.alltoall_base_``, a
    collective's kind, a kernel wrapper's name), its ``kind`` (``aten``,
    ``collective``, ``kernel``), its ``phase``, the kernel wrappers it ran
    inside (``stack``, outermost first), its operands' and results'
    dtypes (torch names) and shapes, for a collective the ``axis`` its
    group spans and the group's size ``n``, for a kernel call or an aten
    op its other arguments (``statics``: ``kernels/ops.KernelCall``'s, or
    the op's non-tensor arguments, an einsum's equation among them), and
    for an aten op whether it only aliased (``view``: every result shares
    an operand's storage and the op is not in place — a view, or a
    ``to`` / ``contiguous`` / ``reshape`` that had nothing to do)."""
    op: str
    kind: str
    phase: str
    stack: Tuple[str, ...]
    in_dtypes: Tuple[str, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    axis: str = ""
    n: int = 0
    statics: Tuple[Any, ...] = ()
    view: bool = False

    @property
    def path(self) -> Tuple[str, ...]:
        """The phase, then the enclosing kernel wrappers."""
        return (self.phase,) + self.stack

    def describe(self) -> str:
        """Human-readable location: ``bwd/grouped_matmul_t/aten.mm``."""
        return "/".join(self.path + (self.op,))


def _meta(tree) -> Tuple[Tuple[str, ...], Tuple[Tuple[int, ...], ...]]:
    ts = [t for t in _pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]
    return _dtypes(ts), tuple(tuple(t.shape) for t in ts)


_NAMES: Dict[torch.dtype, str] = {}


def _dtypes(ts) -> Tuple[str, ...]:
    """The torch names of ``ts``' dtypes."""
    out = []
    for t in ts:
        name = _NAMES.get(t.dtype)
        if name is None:
            name = _NAMES[t.dtype] = str(t.dtype).removeprefix("torch.")
        out.append(name)
    return tuple(out)


# the non-tensor arguments a site keeps: plain values, which a graph
# crossing from a rank to its parent can pickle (not a process group)
_PLAIN = (str, int, float, bool, type(None), torch.dtype)


def _storage(t: torch.Tensor) -> Optional[int]:
    try:
        return id(t.untyped_storage())
    except (RuntimeError, NotImplementedError):
        return None                 # a tensor without a storage


class _Tap(list):
    """A log list (``alltoall.collectives``, ``ops.calls``) that also
    hands each entry to the recorder, and to the list it replaced."""

    def __init__(self, on: Callable, outer: Optional[list]):
        super().__init__()
        self._on, self._outer = on, outer

    def append(self, item) -> None:
        super().append(item)
        if self._outer is not None:
            self._outer.append(item)
        self._on(item)


class _Recorder(TorchDispatchMode):
    """Appends one site per aten op, logged collective and kernel call,
    in the order they ran."""

    def __init__(self):
        super().__init__()
        self.sites: List[OpSite] = []
        self.phase = "fwd"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = _pytree.tree_leaves((args, kwargs) if kwargs else args)
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = ([out] if isinstance(out, torch.Tensor) else
                [t for t in _pytree.tree_leaves(out)
                 if isinstance(t, torch.Tensor)])
        name = func.overloadpacket.__name__
        view = False
        if outs and ins and not name.endswith("_"):
            src = {_storage(t) for t in ins} - {None}
            view = all(_storage(t) in src for t in outs)
        self.sites.append(OpSite(
            f"{func.namespace}.{name}", "aten", self.phase,
            tuple(ops.active), _dtypes(ins),
            tuple(tuple(t.shape) for t in ins), _dtypes(outs),
            tuple(tuple(t.shape) for t in outs),
            statics=tuple(a for a in leaves if isinstance(a, _PLAIN)),
            view=view))
        return out

    def collective(self, c: alltoall.Collective) -> None:
        shapes = (tuple(c.shape),)
        self.sites.append(OpSite(
            c.kind, "collective", self.phase, tuple(ops.active), (c.dtype,),
            shapes, (c.dtype,) if c.kind == "all_to_all" else (),
            shapes if c.kind == "all_to_all" else (), c.axis, c.n))

    def kernel(self, call: ops.KernelCall) -> None:
        self.sites.append(OpSite(call.name, "kernel", self.phase,
                                 tuple(ops.active), call.dtypes, call.shapes,
                                 statics=call.statics))


class OpGraph:
    """A recorded run plus the lint context it ran under.

    ``context`` keys the shipped rules understand (all optional — a rule
    that misses its context does not apply), the reference's:

      cfg                the ``MoEConfig`` the layer ran with
      model_size         expert-parallel degree (the mesh's ``model``)
      tokens_per_shard   the rank's token count fed to the layer
      d_model            model width (payload-shape checks)
      dtype              the compute dtype (the unquantized wire's)
      direction          "fwd" | "grad"
      label              location prefix for findings (e.g. the cell)
      expect_no_recompute  force the no-recompute-backward rule on (the
                           reference's ``expect_no_ragged``)
      remat, fsdp        a deliberate recompute: no-recompute-backward
                         does not apply

    ``launches`` holds each phase's rise of the kernels' launch counters
    (``ops.launch_counts``): on the CPU every wrapper runs its plain
    version and they stay 0."""
    kind = "ops"

    def __init__(self, sites: List[OpSite],
                 context: Optional[Dict[str, Any]] = None,
                 launches: Optional[Dict[str, Dict[str, int]]] = None):
        self._sites = list(sites)
        self.context: Dict[str, Any] = dict(context or {})
        self.launches = dict(launches or {})

    def sites(self, phase: Optional[str] = None) -> List[OpSite]:
        return [s for s in self._sites if phase is None or s.phase == phase]

    def find(self, primitive: str, phase: Optional[str] = None
             ) -> List[OpSite]:
        return [s for s in self.sites(phase) if s.op == primitive]

    def count(self, primitive: str, phase: Optional[str] = None) -> int:
        return len(self.find(primitive, phase))

    def primitives(self) -> Counter:
        return Counter(s.op for s in self._sites)

    @property
    def label(self) -> str:
        return str(self.context.get("label", "<ops>"))


class ProbeGraph:
    """Runtime-evidence 'graph' for the probe rules (aliased state
    leaves, the serving step cache's build counts).  Carries only
    ``context``."""
    kind = "probe"

    def __init__(self, context: Optional[Dict[str, Any]] = None):
        self.context: Dict[str, Any] = dict(context or {})

    @property
    def label(self) -> str:
        return str(self.context.get("label", "<probe>"))


def _rise(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def trace_graph(fn, *args, context: Optional[Dict[str, Any]] = None,
                grad: bool = False) -> OpGraph:
    """Run ``fn(*args)`` once and return the :class:`OpGraph` of what it
    ran.  With ``grad``, then the backward of its summed output (every
    floating tensor of the output that requires grad, summed in f32) with
    respect to the tensors of ``args`` that require grad, under the same
    recorder (phase ``bwd``; the caller's tensors get no ``.grad``).
    ``alltoall.collectives`` and ``ops.calls`` are switched on for the
    run (a log the caller had on keeps receiving) and put back after."""
    rec = _Recorder()
    saved = alltoall.collectives, ops.calls
    alltoall.collectives = _Tap(rec.collective, saved[0])
    ops.calls = _Tap(rec.kernel, saved[1])
    launches = {}
    try:
        with rec:
            before = ops.launch_counts()
            out = fn(*args)
            launches["fwd"] = _rise(before)
            if grad:
                outs = [t for t in _pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor) and t.requires_grad
                        and t.is_floating_point()]
                wrt = [t for t in _pytree.tree_leaves(args)
                       if isinstance(t, torch.Tensor) and t.requires_grad]
                if not outs or not wrt:
                    raise ValueError(
                        "trace_graph(grad=True) needs an output and "
                        "arguments that require grad")
                total = sum(t.float().sum() for t in outs)
                rec.phase = "bwd"
                before = ops.launch_counts()
                torch.autograd.grad(total, wrt, allow_unused=True)
                launches["bwd"] = _rise(before)
    finally:
        alltoall.collectives, ops.calls = saved
    return OpGraph(rec.sites, context, launches)
