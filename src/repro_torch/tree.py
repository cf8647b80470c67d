"""Parameter trees: nested dicts, lists and tuples with tensor leaves
(the port's stand-in for ``jax.tree``).  Dict keys are visited in sorted
order, as ``jax.tree`` visits them."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def map_(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, *xs) for xs in zip(tree, *rest,
                                                     strict=True))
    return fn(tree, *rest)


def unflatten(tree: Any, values: List[Any]) -> Any:
    """``values`` (in the order of :func:`leaves`) in ``tree``'s
    structure."""
    it = iter(values)
    out = _fill(tree, it)
    if next(it, it) is not it:
        raise ValueError("unflatten: more values than leaves")
    return out


def _fill(tree: Any, it) -> Any:
    if isinstance(tree, dict):
        filled = {k: _fill(tree[k], it) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, it) for v in tree)
    return next(it)
