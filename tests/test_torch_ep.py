"""The MoE layer across ranks: the port's ``sharded_moe_apply`` on gloo CPU
ranks (``launch.mesh.spawn``, one process per rank) against the
reference's on the conftest's fake devices at the same mesh shape, the
same numpy inputs (E=8 experts, top-2, capacity 1.0 so that ``sort`` and
``dense`` drop, 62 tokens so that 1x4 and 2x2 pad), f32.  Also the dense
dispatch at one device, the grouped path at 1x4 against the port's own
one-device layer, the collective count per layer, the α–β resolution at
M = 2, 4, 8, and context-parallel attention at 1x2 against one
process."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.core import alltoall as jalltoall
from repro.core import config as jconfig
from repro.core import gating as jgating
from repro.core import layout as jlayout
from repro.core import moe as jmoe
from repro.core import tuning as jtuning
from repro.launch.mesh import make_smoke_mesh
from repro_torch.core import alltoall, gating, layout, moe, tuning
from repro_torch.core import config as tconfig
from repro_torch.launch.mesh import spawn

E, D, F, T = 8, 16, 24, 62
BASE = dict(num_experts=E, top_k=2, gate="topk", capacity_factor=1.0,
            d_ff_expert=F, aux_loss_weight=0.01, router_z_loss_weight=0.001)
# the reference's fabric pair, read from its module (the port carries the
# same paper pair; the test hands both sides one explicit pair)
FABRIC = ("pcie_eth100", (jalltoall.PCIE, jalltoall.ETH100))
TFABRIC = ("pcie_eth100", (alltoall.LinkSpec(jalltoall.PCIE.alpha,
                                             jalltoall.PCIE.beta),
                           alltoall.LinkSpec(jalltoall.ETH100.alpha,
                                             jalltoall.ETH100.beta)))
H = dict(a2a="hierarchical", a2a_inner=2)
CASES = {
    (1, 2): [("sort", dict(dispatch="sort")),
             ("dense", dict(dispatch="dense")),
             ("grouped", dict(dispatch="grouped"))],
    (1, 4): [("sort", dict(dispatch="sort")),
             ("sort-hier", dict(dispatch="sort", **H)),
             ("dense-hier", dict(dispatch="dense", **H)),
             ("grouped", dict(dispatch="grouped")),
             ("grouped-hier", dict(dispatch="grouped", **H)),
             ("grouped-overlap2", dict(dispatch="grouped", overlap_chunks=2)),
             ("grouped-hier-overlap2", dict(dispatch="grouped",
                                            overlap_chunks=2, **H)),
             ("grouped-int8", dict(dispatch="grouped", payload_dtype="int8",
                                   **H)),
             ("grouped-bound1", dict(dispatch="grouped",
                                     grouped_ep_bound_factor=1.0))],
    (2, 2): [("sort", dict(dispatch="sort")),
             ("dense", dict(dispatch="dense")),
             ("grouped", dict(dispatch="grouped")),
             ("grouped-overlap2-int8", dict(dispatch="grouped",
                                            overlap_chunks=2,
                                            payload_dtype="int8"))],
}
# normwise relative budgets of the int8 wire (the reference's QWIRE_TOLS
# for int8: outputs 5e-2, gradients 1e-1)
QWIRE = (5e-2, 1e-1)


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f32(T, D), "gy": f32(T, D),
            "params": {"gate_w": f32(D, E) * D ** -.5,
                       "w_up": f32(E, D, F) * D ** -.5,
                       "w_gate": f32(E, D, F) * D ** -.5,
                       "w_out": f32(E, F, D) * F ** -.5}}


def _reference(shape, fields, inputs):
    mesh = make_smoke_mesh(shape)
    cfg = jconfig.MoEConfig(use_pallas_gate=False, **{**BASE, **fields})
    p = jax.tree.map(jnp.asarray, inputs["params"])
    x, gy = jnp.asarray(inputs["x"]), jnp.asarray(inputs["gy"])

    def loss(p, x):
        y, aux, met = jmoe.sharded_moe_apply(mesh, cfg, p, x, num_experts=E,
                                             act="swiglu")
        return jnp.sum(y * gy) + aux, (y, aux, met)

    prev = jtuning.set_tuning(fabric=FABRIC)
    try:
        (_, (y, aux, met)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(p, x)
    finally:
        jtuning.set_tuning(*prev)
    return {"y": np.asarray(y), "aux": float(aux),
            "metrics": {k: float(v) for k, v in met.items()},
            "dx": np.asarray(gx),
            "grads": {k: np.asarray(v) for k, v in gp.items()}}


@pytest.fixture(scope="module")
def runs():
    """Every case of every mesh shape on the port's ranks (one spawn per
    shape) and on the reference."""
    inputs = _inputs()
    out = {}
    for shape, cases in CASES.items():
        ranks = spawn(torch_ranks.layer_rank, shape[0] * shape[1],
                      backend="gloo", threads=1,
                      args=(shape, inputs,
                            [(n, {**BASE, **f}, "swiglu") for n, f in cases],
                            TFABRIC))
        for name, fields in cases:
            out[shape, name] = ([r[name] for r in ranks],
                                _reference(shape, fields, inputs))
    return out


def _assemble(ranks, shape, key):
    """The ranks' token rows back in global order, padding cut."""
    return np.concatenate([r[key] for r in ranks])[:T]


def _close(got, want, what, tol=1e-5):
    """Within ``tol`` of the larger of 1 and the reference's max."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _port_grads(ranks, shape):
    """gate_w summed over every rank, the experts over the data ranks of
    each model column and concatenated over the columns."""
    Dd, M = shape
    out = {"gate_w": sum(r["grads"]["gate_w"] for r in ranks)}
    for k in ranks[0]["grads"]:
        if k == "gate_w":
            continue
        out[k] = np.concatenate([
            sum(ranks[d * M + m]["grads"][k] for d in range(Dd))
            for m in range(M)])
    return out


ALL = [(s, n) for s, cases in CASES.items() for n, _ in cases]


@pytest.mark.parametrize("shape,name", ALL,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in ALL])
def test_sharded_layer_matches_reference(runs, shape, name):
    """y, aux, metrics and the gradients of x and of every leaf equal the
    reference's sharded_moe_apply on the same mesh shape: f32 within 1e-5
    of each output's max (the int8 wire within the reference's QWIRE
    budgets, normwise)."""
    ranks, ref = runs[shape, name]
    y = _assemble(ranks, shape, "y")
    dx = _assemble(ranks, shape, "dx")
    grads = _port_grads(ranks, shape)
    if "int8" in name:
        rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa
        assert rel(y, ref["y"]) < QWIRE[0]
        assert rel(dx, ref["dx"]) < QWIRE[1]
        for k, g in grads.items():
            assert rel(g, ref["grads"][k]) < QWIRE[1], k
    else:
        _close(y, ref["y"], "y")
        _close(dx, ref["dx"], "dx")
        for k, g in grads.items():
            _close(g, ref["grads"][k], k)
    for r in ranks:
        _close(r["aux"], ref["aux"], "aux", 1e-6)
        for k, v in r["metrics"].items():
            _close(v, ref["metrics"][k], k, 1e-6)


@pytest.mark.parametrize("shape,name", ALL,
                         ids=[f"{s[0]}x{s[1]}-{n}" for s, n in ALL])
def test_collectives_per_layer(runs, shape, name):
    """The AllToAll collectives one layer's forward issues: the
    reference's expected_grouped_a2a_eqns on the grouped path, a dispatch
    and a combine payload exchange (of its stages each) on the others."""
    for r in runs[shape, name][0]:
        want = (r["expected"] if name.startswith("grouped")
                else 2 * r["stages"])
        assert r["exchanges"] == want, (r["exchanges"], want)


def test_grouped_across_ranks_equals_one_device(runs):
    """Dropless grouped at 1x4 equals the port's own one-device layer on the
    same global tokens (f32, 1e-5 of the max)."""
    inputs = _inputs()
    cfg = tconfig.MoEConfig(**BASE, dispatch="grouped")
    p = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y, aux, _ = moe.moe_apply(cfg, p, x, num_experts=E, act="swiglu")
    ranks, _ = runs[(1, 4), "grouped"]
    _close(_assemble(ranks, (1, 4), "y"), y.detach().numpy(), "y")
    for r in ranks:
        _close(r["aux"], float(aux.detach()), "aux", 1e-6)


# ---------------------------------------------------------------------------
# the dense dispatch on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("top_k,drop", [(1, False), (2, True), (4, True)])
def test_plan_cumsum_slots_equal_plan_sort_and_reference(top_k, drop):
    """plan_cumsum's slots, weights, counts and offsets equal plan_sort's
    and the reference's plan_cumsum (virtual expert E on some rows)."""
    S = 40
    x = np.random.default_rng(top_k).standard_normal((S, E)).astype(
        np.float32)
    fields = dict(num_experts=E, top_k=top_k, gate="topk")
    jg = jgating.route(jconfig.MoEConfig(use_pallas_gate=False, **fields),
                       jnp.asarray(x))
    tg = gating.route(tconfig.MoEConfig(**fields), torch.from_numpy(x))
    if drop:
        ei = np.where((np.arange(S) % 7 == 0)[:, None], E,
                      np.asarray(jg.expert_index))
        jg = jg._replace(expert_index=jnp.asarray(ei, jnp.int32))
        tg = tg._replace(expert_index=torch.from_numpy(ei).to(torch.int32))
    C = 6
    jp = jlayout.plan_cumsum(jg, E, C, drop_bucket=drop)
    tp = layout.plan_cumsum(tg, E, C, drop_bucket=drop)
    sp = layout.plan_sort(tg, E, C, drop_bucket=drop)
    for f in ("slot", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      getattr(sp, f).numpy(), f)
    np.testing.assert_allclose(tp.weight.numpy(), np.asarray(jp.weight),
                               atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_moe_apply_matches_reference(mesh1, top_k):
    """moe_apply(dispatch="dense") forward and gradients (x and every leaf)
    equal the reference's sharded_moe_apply at 1x1, f32 within 1e-5 of
    each output's max."""
    inputs = _inputs(seed=9)
    fields = dict(BASE, top_k=top_k, dispatch="dense")
    ref = _reference((1, 1), dict(dispatch="dense", top_k=top_k), inputs)
    cfg = tconfig.MoEConfig(**fields)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in inputs["params"].items()}
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y, aux, met = moe.moe_apply(cfg, p, x, num_experts=E, act="swiglu")
    loss = (y * torch.from_numpy(inputs["gy"])).sum() + aux
    keys = sorted(p)
    g = torch.autograd.grad(loss, [x] + [p[k] for k in keys])
    _close(y.detach().numpy(), ref["y"], "y")
    _close(g[0].numpy(), ref["dx"], "dx")
    for k, gk in zip(keys, g[1:]):
        _close(gk.numpy(), ref["grads"][k], k)
    _close(float(aux.detach()), ref["aux"], "aux", 1e-6)
    for k, v in met.items():
        _close(float(v), ref["metrics"][k], k, 1e-6)


# ---------------------------------------------------------------------------
# tuning across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [2, 4, 8])
@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
@pytest.mark.parametrize("T_shard", [8, 2048])
def test_resolution_at_model_sizes_matches_reference(M, dispatch, T_shard):
    """resolve_moe_config of the paper preset's "auto" knobs at M ranks
    equals the reference's under one explicit LinkSpec pair (read from
    the reference's module) and the reference's compute rate."""
    from repro import configs as jconfigs
    from repro_torch import configs
    jcfg = dataclasses.replace(jconfigs.get_config("hetumoe-paper-16e").moe,
                               dispatch=dispatch)
    tcfg = dataclasses.replace(configs.get_config("hetumoe-paper-16e").moe,
                               dispatch=dispatch)
    prev = tuning.set_tuning(flops=jtuning.NOMINAL_FLOPS)
    try:
        for dt in ("float32", "bfloat16"):
            jr = jtuning.resolve_moe_config(
                jcfg, model_size=M, tokens_per_shard=T_shard, d_model=2048,
                dtype=getattr(jnp, dt), fabric=FABRIC)
            tr = tuning.resolve_moe_config(
                tcfg, model_size=M, tokens_per_shard=T_shard, d_model=2048,
                dtype=getattr(torch, dt), fabric=TFABRIC)
            for knob in tuning.TUNED_KNOBS + ("a2a_inner",):
                assert getattr(tr, knob) == getattr(jr, knob), (dt, knob)
            moe.validate_dispatch_config(tr, model_size=M,
                                         tokens_per_shard=T_shard)
            assert moe.expected_grouped_a2a_eqns(tr, M) == \
                jmoe.expected_grouped_a2a_eqns(jr, M)
    finally:
        tuning.set_tuning(*prev)


def test_expert_tp_identity_and_context_parallel_attention_runs():
    """Expert TP is ported: on one device (no mesh: a data axis of size 1)
    ``expert_tp_axis="data"`` is the identity, bitwise the layer without
    it, and an axis outside the mesh's raises ValueError (the layer under
    TP across ranks: test_torch_expert_tp.py).  Context-parallel
    attention is ported too: at 1x2 with one row (each rank 64 of its 128
    positions, the row past q_chunk 32: the flash path), ``full_attention``
    over the row group gives one process's output and gradients (f32,
    within 1e-5 of each one's max; test_torch_cp.py holds it against the
    reference)."""
    from repro_torch.models import attention
    cfg = tconfig.MoEConfig(**BASE)
    inputs = _inputs()
    p = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    x = torch.from_numpy(inputs["x"])
    y, aux, _ = moe.sharded_moe_apply(None, cfg, p, x, num_experts=E,
                                      expert_tp_axis="data")
    y0, aux0, _ = moe.sharded_moe_apply(None, cfg, p, x, num_experts=E)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    with pytest.raises(ValueError, match="valid axis names"):
        moe.sharded_moe_apply(None, cfg, p, x, num_experts=E,
                              expert_tp_axis="pod")
    heads = dict(num_heads=4, num_kv_heads=2, head_dim=8)
    rng = np.random.default_rng(3)
    att = {"params": {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
                      for k, s in (("wq", (D, 32)), ("wk", (D, 16)),
                                   ("wv", (D, 16)), ("wo", (32, D)))},
           "x": rng.standard_normal((1, 128, D)).astype(np.float32),
           "gy": rng.standard_normal((1, 128, D)).astype(np.float32)}
    cases = [("causal", heads, True, None, True)]
    ranks = spawn(torch_ranks.cp_attention, 2, backend="gloo", threads=1,
                  args=((1, 2), 1, att, cases, 32))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in att["params"].items()}
    tx = torch.from_numpy(att["x"]).requires_grad_(True)
    ty, _ = attention.full_attention(
        tp, tx, tconfig.AttentionConfig(**heads),
        positions=torch.arange(128, dtype=torch.int32), q_chunk=32)
    keys = sorted(tp)
    want = torch.autograd.grad((ty * torch.from_numpy(att["gy"])).sum(),
                               [tx] + [tp[k] for k in keys])
    got_y = np.concatenate([r["causal"]["y"] for r in ranks], axis=1)
    got_dx = np.concatenate([r["causal"]["dx"] for r in ranks], axis=1)
    assert [r["block"] for r in ranks] == [(0, 1, 0, 64, 2), (0, 1, 64, 128,
                                                              2)]
    assert all(r["causal"]["gathers"] == 1 for r in ranks)
    for got, w in [(got_y, ty), (got_dx, want[0])] + [
            (sum(r["causal"]["grads"][k] for r in ranks), g)
            for k, g in zip(keys, want[1:])]:
        w = w.detach().numpy()
        assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max()
