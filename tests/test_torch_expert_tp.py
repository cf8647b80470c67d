"""Expert tensor parallelism: the port's ``sharded_moe_apply(expert_tp_axis=
"data")`` on gloo CPU ranks (``launch.mesh.spawn``, one process per rank)
against the reference's on the conftest's fake devices at the same mesh
shape, the same numpy inputs (E=8 experts, top-2, f=24 so that it divides
over 2 and 4 data ranks, 62 tokens so that 2x2, 4x1 and 2x4 pad), f32.
Capacity 1.0 makes ``sort`` and ``dense`` drop, as the reference does at
the same mesh; capacity 8.0 (``-cf8``) drops nothing, where grouped + TP ≡
sort + TP ≡ the one-device layer without TP."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.core import config as jconfig
from repro.core import moe as jmoe
from repro.core import tuning as jtuning
from repro.launch.mesh import make_smoke_mesh
from repro_torch.core import config as tconfig
from repro_torch.core import moe
from repro_torch.launch.mesh import spawn
from test_torch_ep import FABRIC, TFABRIC, _close, _port_grads

E, D, F, T = 8, 16, 24, 62
BASE = dict(num_experts=E, top_k=2, gate="topk", capacity_factor=1.0,
            d_ff_expert=F, aux_loss_weight=0.01, router_z_loss_weight=0.001)
H = dict(a2a="hierarchical", a2a_inner=2)
CF8 = dict(capacity_factor=8.0)
CASES = {
    (2, 2): [("sort", dict(dispatch="sort")),
             ("dense", dict(dispatch="dense")),
             ("grouped", dict(dispatch="grouped")),
             ("grouped-overlap2", dict(dispatch="grouped", overlap_chunks=2)),
             ("grouped-int8", dict(dispatch="grouped", payload_dtype="int8")),
             ("grouped-bound1", dict(dispatch="grouped",
                                     grouped_ep_bound_factor=1.0)),
             ("sort-cf8", dict(dispatch="sort", **CF8)),
             ("grouped-cf8", dict(dispatch="grouped", **CF8))],
    (4, 1): [("sort", dict(dispatch="sort")),
             ("dense", dict(dispatch="dense")),
             ("grouped", dict(dispatch="grouped")),
             ("grouped-overlap2", dict(dispatch="grouped", overlap_chunks=2)),
             ("sort-cf8", dict(dispatch="sort", **CF8)),
             ("grouped-cf8", dict(dispatch="grouped", **CF8))],
    (2, 4): [("sort-hier", dict(dispatch="sort", **H)),
             ("dense-hier", dict(dispatch="dense", **H)),
             ("grouped", dict(dispatch="grouped")),
             ("grouped-hier-overlap2-int8", dict(dispatch="grouped",
                                                 overlap_chunks=2,
                                                 payload_dtype="int8", **H))],
}
# normwise relative budgets of the int8 wire against the reference (its
# QWIRE_TOLS for int8: outputs 5e-2, gradients 1e-1): a value within
# rounding of a quantization step may land one step apart on the two
# sides
QWIRE = (5e-2, 1e-1)


def _inputs(seed=26):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"x": f32(T, D), "gy": f32(T, D),
            "params": {"gate_w": f32(D, E) * D ** -.5,
                       "w_up": f32(E, D, F) * D ** -.5,
                       "w_gate": f32(E, D, F) * D ** -.5,
                       "w_out": f32(E, F, D) * F ** -.5}}


def _reference(shape, fields, inputs):
    """The reference's layer with expert TP over ``data`` at ``shape``:
    y, aux, metrics and the gradients of sum(y·gy) + aux."""
    mesh = make_smoke_mesh(shape)
    cfg = jconfig.MoEConfig(use_pallas_gate=False, **{**BASE, **fields})
    p = jax.tree.map(jnp.asarray, inputs["params"])
    x, gy = jnp.asarray(inputs["x"]), jnp.asarray(inputs["gy"])

    def loss(p, x):
        y, aux, met = jmoe.sharded_moe_apply(mesh, cfg, p, x, num_experts=E,
                                             act="swiglu",
                                             expert_tp_axis="data")
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
    shape, expert TP over ``data``) and on the reference."""
    inputs = _inputs()
    out = {}
    for shape, cases in CASES.items():
        ranks = spawn(torch_ranks.layer_rank, shape[0] * shape[1],
                      backend="gloo", threads=1,
                      args=(shape, inputs,
                            [(n, {**BASE, **f}, "swiglu") for n, f in cases],
                            TFABRIC, "data"))
        for name, fields in cases:
            out[shape, name] = ([r[name] for r in ranks],
                                _reference(shape, fields, inputs))
    return out


def _assemble(ranks, key):
    """The ranks' token rows back in global order, padding cut."""
    return np.concatenate([r[key] for r in ranks])[:T]


ALL = [(s, n) for s, cases in CASES.items() for n, _ in cases]
IDS = [f"{s[0]}x{s[1]}-{n}" for s, n in ALL]


@pytest.mark.parametrize("shape,name", ALL, ids=IDS)
def test_tp_layer_matches_reference(runs, shape, name):
    """y, aux, metrics and the gradients of x and of every leaf (gate_w
    summed over the ranks; each expert leaf summed over its data ranks,
    whose f-slices are disjoint) equal the reference's expert-TP layer on
    the same mesh shape: f32 within 1e-5 of each output's max (the int8
    wire within the reference's QWIRE budgets, normwise)."""
    ranks, ref = runs[shape, name]
    y, dx = _assemble(ranks, "y"), _assemble(ranks, "dx")
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


@pytest.mark.parametrize("shape,name", ALL, ids=IDS)
def test_tp_collectives_per_layer(runs, shape, name):
    """A layer's forward issues 2 expert-TP collectives on sort and dense
    (the all-gather of the received buffer and the reduce-scatter of the
    FFN rows) and 3 per overlap window on grouped (the chunks', the count
    matrices' all-gathers and the reduce-scatter); its AllToAlls stay
    the reference's expected_grouped_a2a_eqns on grouped and a dispatch
    and a combine exchange (of their stages each) on the others at
    model > 1."""
    for r in runs[shape, name][0]:
        grouped = name.startswith("grouped")
        windows = 2 if "overlap2" in name else 1
        assert r["tp_collectives"] == (3 * windows if grouped else 2)
        want = (r["expected"] if grouped
                else 2 * r["stages"] if shape[1] > 1 else 0)
        assert r["exchanges"] == want, (r["exchanges"], want)


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_grouped_tp_equals_sort_tp_equals_no_tp(runs, shape):
    """At capacity 8 nothing drops: grouped + TP equals sort + TP on the
    same mesh (outputs and every gradient), and both equal the port's
    one-device grouped layer without TP on the same global tokens, f32
    within 1e-5 of each max (tests/test_grouped_tp.py:74,102)."""
    inputs = _inputs()
    g, s = runs[shape, "grouped-cf8"][0], runs[shape, "sort-cf8"][0]
    for key in ("y", "dx"):
        _close(_assemble(g, key), _assemble(s, key), key)
    gg, gs = _port_grads(g, shape), _port_grads(s, shape)
    for k in gg:
        _close(gg[k], gs[k], k)
    cfg = tconfig.MoEConfig(**{**BASE, **CF8}, dispatch="grouped")
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in inputs["params"].items()}
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y, aux, _ = moe.moe_apply(cfg, p, x, num_experts=E, act="swiglu")
    loss = (y * torch.from_numpy(inputs["gy"])).sum() + aux
    keys = sorted(p)
    one = torch.autograd.grad(loss, [x] + [p[k] for k in keys])
    _close(_assemble(g, "y"), y.detach().numpy(), "y")
    _close(_assemble(g, "dx"), one[0].numpy(), "dx")
    for k, gk in zip(keys, one[1:]):
        _close(gg[k], gk.numpy(), k)


def test_expert_tp_axis_and_width_are_checked():
    """An axis other than None or "data" raises the reference's ValueError
    naming the mesh's axes (a typo must not silently disable TP); an
    expert width that does not divide over the data axis raises."""
    cfg = tconfig.MoEConfig(**BASE)
    inputs = _inputs()
    p = {k: torch.from_numpy(v) for k, v in inputs["params"].items()}
    x = torch.from_numpy(inputs["x"])
    with pytest.raises(ValueError, match="valid axis names"):
        moe.sharded_moe_apply(None, cfg, p, x, num_experts=E,
                              expert_tp_axis="model")
    five = types.SimpleNamespace(shape={"data": 5, "model": 1}, world=5,
                                 rank=0, data_index=0)
    with pytest.raises(ValueError, match="does not divide over the data"):
        moe.sharded_moe_apply(five, cfg, p, x, num_experts=E,
                              expert_tp_axis="data")
