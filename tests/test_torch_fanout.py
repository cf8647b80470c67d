"""The gather's fan-out form (kernel 2 given ``dest``, the inverse of its
index map) against the gather form and the JAX package's Pallas gather.

The layout plans carry ``dest``: the sort plan's ``slot`` and the grouped
plan's ``dest``.  Their dispatches pass it, so on the card each token is
read once and written to its K rows.  Here, on the CPU, the wrapper runs
the fan-out form's plain twin, ``gather_rows_fanout_plain``.  Inputs come
from numpy seeds: routes of K distinct experts per token, some tokens
padded (routed to the virtual expert E with ``drop_bucket``), and for the
sort plan a capacity small enough to drop assignments and leave capacity
slots empty.  ``chip_smoke.py`` holds the CUDA kernel to the same plain
twin on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import layout_transform as jlt
from repro_torch.core import gating, layout, moe
from repro_torch.core import config as tconfig
from repro_torch.kernels import layout_transform as L

E = 8
S = 29


def _plan(kind: str, K: int, drop_bucket: bool, seed: int = 5):
    """(idx, dest) of a plan over S tokens routed to K distinct of E
    experts; with ``drop_bucket`` every 7th token routes to expert E."""
    rng = np.random.default_rng(seed + K)
    # skewed routes: the first experts overflow, the last ones run short
    w = 0.7 ** np.arange(E)
    experts = np.stack([rng.choice(E, K, replace=False, p=w / w.sum())
                        for _ in range(S)])
    if drop_bucket:
        experts[::7] = E
    gate = gating.GateOutput(torch.from_numpy(experts.astype(np.int32)),
                             torch.from_numpy(rng.random((S, K)).astype(
                                 np.float32)),
                             torch.zeros(S, E), torch.zeros(S, E))
    if kind == "grouped":
        p = layout.plan_grouped(gate, E, drop_bucket=drop_bucket)
        return p.token, p.dest
    # the mean load as capacity: the busy experts drop assignments, the
    # idle ones leave capacity slots empty
    C = -(-S * K // E)
    p = layout.plan_sort(gate, E, C, drop_bucket=drop_bucket)
    return p.inv, p.slot


PLANS = [(kind, K, drop) for kind in ("sort", "grouped") for K in (1, 2, 4)
         for drop in (False, True)]


@pytest.mark.parametrize("kind,K,drop_bucket", PLANS)
def test_plan_dest_is_the_inverse_of_its_index_map(kind, K, drop_bucket):
    """Every (token, k) with a row writes the row whose index is that
    token, and every row with an index >= 0 is written by exactly one
    (token, k); the sort plan drops some assignments and leaves some
    capacity slots empty (-1 rows), the grouped plan neither."""
    idx, dest = _plan(kind, K, drop_bucket)
    assert dest.dtype == torch.int32 and dest.shape == (S, K)
    assert dest.is_contiguous()
    d = dest.numpy()
    i = idx.numpy()
    tok = np.repeat(np.arange(S), K)
    covered = d.reshape(-1) >= 0
    np.testing.assert_array_equal(i[d.reshape(-1)[covered]], tok[covered])
    written = np.bincount(d.reshape(-1)[covered], minlength=i.shape[0])
    np.testing.assert_array_equal(written, (i >= 0).astype(np.int64))
    if kind == "sort":
        assert (~covered).any() and (i < 0).any()
    else:
        assert covered.all() and (i >= 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,K,drop_bucket", PLANS)
def test_fanout_plain_matches_gather_and_pallas(kind, K, drop_bucket, dtype):
    """Bitwise: the fan-out form's plain twin, the gather form's plain
    version and the reference's Pallas gather (interpret mode) give the
    same rows, zeros in the empty capacity slots; the wrapper given
    ``dest`` runs the twin on the CPU and launches nothing."""
    idx, dest = _plan(kind, K, drop_bucket)
    src = np.random.default_rng(K).standard_normal((S, 24)).astype(
        np.float32)
    ts = torch.from_numpy(src).to(getattr(torch, dtype))
    fan = L.gather_rows_fanout_plain(ts, idx, dest)
    assert torch.equal(fan, L.gather_rows_plain(ts, idx))
    before = L.launches
    assert torch.equal(L.gather_rows(ts, idx, dest), fan)
    assert L.launches == before
    j = np.asarray(jlt._gather_rows_impl(
        jnp.asarray(src).astype(dtype), jnp.asarray(idx.numpy()),
        interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(fan.float().numpy(), j)


def _layer(dispatch: str, top_k: int, seed: int = 3):
    cfg = tconfig.MoEConfig(num_experts=E, top_k=top_k,
                            gate="topk" if top_k > 1 else "switch",
                            dispatch=dispatch, d_ff_expert=20,
                            use_pallas_gate=True)
    g = torch.Generator().manual_seed(seed)
    params = moe.init_moe_params(g, cfg, 16, 20, E)
    x = torch.randn(2, 13, 16, generator=g)
    return cfg, params, x


def _run(cfg, params, x):
    """Output, aux loss and the gradients of x and of every parameter."""
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    xx = x.clone().requires_grad_()
    y, aux, _ = moe.moe_apply(cfg, p, xx, num_experts=E)
    w = torch.linspace(-1.0, 1.0, y.numel()).reshape(y.shape)
    ((y * w).sum() + aux).backward()
    return [y, aux, xx.grad] + [p[k].grad for k in sorted(p)]


@pytest.mark.parametrize("top_k", [1, 4])
@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_moe_apply_fanout_equals_gather_form(monkeypatch, dispatch, top_k):
    """``moe_apply`` with the dispatch passing ``dest`` (the fan-out form)
    equals, bitwise, the same call with the dispatch's gather given no
    ``dest`` (the gather form): output, aux loss, and the gradients of
    the input and of every parameter (the backward is the scatter-add
    either way).  The default run does reach the fan-out form."""
    cfg, params, x = _layer(dispatch, top_k)
    forms = []
    real = L._gather_rows
    monkeypatch.setattr(L, "_gather_rows", lambda src, idx, dest=None: (
        forms.append(dest is not None) or real(src, idx, dest)))
    fan = _run(cfg, params, x)
    assert forms[0]                       # the dispatch passed dest
    take = layout.take_rows
    monkeypatch.setattr(layout, "take_rows",
                        lambda src, idx, dest=None: take(src, idx))
    forms.clear()
    plain = _run(cfg, params, x)
    assert not any(forms)
    for a, b in zip(fan, plain, strict=True):
        assert torch.equal(a, b)
