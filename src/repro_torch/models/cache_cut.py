"""A rank's cut of one layer's decode caches over the ``model`` group.

Served across ranks, a rank stores only its block of each decode cache
leaf (``launch/shard.cache_layout_for``, the reference's
``cache_shardings``): its rows, and over ``model`` one inner dim.  A
:class:`CacheCut` tells a layer's decode step which: the attention
cache's form (``models/attention``'s module docstring) and the dim each
recurrent state leaf (``models/rwkv6``'s and ``models/mamba2``'s ``s``
and ``conv``) is cut in, and carries the collectives that bring the
rank's partial results together.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

# the dim of an attention cache leaf (B, L, KV, hd) each form cuts
FORM_DIMS = {"positions": 1, "heads": 2, "channels": 3}


@dataclasses.dataclass(frozen=True)
class CacheCut:
    """``form`` the attention cache's, ``"heads"``, ``"positions"``,
    ``"channels"`` or ``"whole"`` (also a layer without one); ``n`` the
    ranks of the group, ``index`` this rank's place in it, ``group`` its
    process group (the collectives'), ``length`` the whole attention
    cache's slots (a ring's W included), ``dims`` each recurrent state
    leaf cut over ``model`` with the dim it is cut in."""
    form: str
    n: int = 1
    index: int = 0
    group: Any = None
    length: int = 0
    dims: Tuple[Tuple[str, int], ...] = ()

    @property
    def cuts(self) -> bool:
        return self.form != "whole" and self.n > 1

    @property
    def block_dim(self) -> Optional[int]:
        """The dim of a (B, S, KV, hd) key or value block that the rank
        keeps its block of and gathers its outputs in: the ``heads`` and
        ``channels`` forms' (None: ``whole``, or ``positions``, whose
        partial outputs are merged)."""
        if self.cuts and self.form in ("heads", "channels"):
            return FORM_DIMS[self.form]
        return None

    def dim(self, name: str) -> Optional[int]:
        """The dim the state leaf ``name`` is cut in (None: whole)."""
        return dict(self.dims).get(name) if self.n > 1 else None

    def take(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``."""
        b = t.shape[dim] // self.n
        return t.narrow(dim, self.index * b, b)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` as its block of ``dim``, over the group."""
        from repro_torch.core import alltoall
        return alltoall.gather_dim(t, self.group, self.n, dim, "model")

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` over the group."""
        from repro_torch.core import alltoall
        return alltoall.sum_over(t, self.group, self.n, "model")
