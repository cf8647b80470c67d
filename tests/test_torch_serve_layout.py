"""The served state stored by the reference's serving rule: the port's
``Transformer(cfg, mesh=, fsdp=)`` on four gloo CPU ranks
(``launch.mesh.spawn``, one spawn for every mesh shape: 2x2, 4x1, 1x4 over
one world; rank bodies in ``tests/torch_ranks.py``) against the reference
and one process, over one weight tree (the reference's ``init_model``
through ``convert.params_from_numpy(..., serving=True)``).  The model:
the paper preset's smoke config (2 ``moe`` layers, d=128, 4 experts of
f=256) with swiglu experts and a top-2 gate, f32, its tuned knobs pinned.

Each rank stores its E/M experts and, under expert TP (the decode step's
layout), their f-slice over ``data``: each expert leaf 1/(M·D) of the
whole; the dense leaves whole, or with ``fsdp`` as the reference's
``param_shardings(fsdp=True)`` says.  The prefill gathers each block's
experts whole in f; the decode step computes on the stored slice.  The
collectives a rank logs (``core/alltoall.collectives``) in a prefill, a
decode step and a train step equal ``launch/dryrun``'s plan of them, op
for op."""
import collections
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import param_shapes, params_from_numpy
from repro_torch.core.config import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun, shard
from repro_torch.launch.mesh import spawn, tree_paths
from repro_torch.models.transformer import Transformer
from repro_torch.serving.engine import serve_config

ARCH = "hetumoe-paper-16e"
SERVE_MESHES = ((2, 2), (4, 1), (1, 4))
STEPS = 6
# 3 rows are whole over data at 2x2 and pad to the world of 4; caches of
# S + STEPS = 12 positions: 2 kv heads over model=2 (heads), the positions
# over model=4 (1x4)
B, S = 3, 6
PINNED = dict(gate="topk", top_k=2, a2a="flat", overlap_chunks=1,
              grouped_block_m=None, grouped_ep_bound_factor=None)
# (mesh, dispatch, fsdp, B, S): at 1x4 two rows of 16 split over two
# ranks each (context parallelism's row gathers)
TRAIN_CELLS = [(m, d, f, b, 16) for m, b in (((2, 2), 4), ((1, 4), 2))
               for d in ("sort", "grouped") for f in (False, True)]


def _cfgs():
    """(reference, port) f32 configs; the reference's plain gate."""
    jc = jconfigs.smoke_config(ARCH)
    tc = configs.smoke_config(ARCH)
    jc = jc.replace(act="swiglu", dtype="float32", moe=dataclasses.replace(
        jc.moe, use_pallas_gate=False, dispatch="grouped", **PINNED))
    tc = tc.replace(act="swiglu", dtype="float32", moe=dataclasses.replace(
        tc.moe, dispatch="grouped", **PINNED))
    return jc, tc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The ranks' runs, one process's greedy run and the reference's."""
    jc, tc = _cfgs()
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(3),
                                                   jc))
    path = tmp_path_factory.mktemp("serve_layout") / "tree.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    prompt = np.random.default_rng(29).integers(0, 512, (B, S)).astype(
        np.int32)
    ranks = spawn(torch_ranks.serve_layout_rank, 4, backend="gloo",
                  threads=1, args=(str(path), tc, prompt, STEPS,
                                   SERVE_MESHES, TRAIN_CELLS))
    one = Transformer(serve_config(tc), device="cpu",
                      params=params_from_numpy(tree, tc))
    one_run = torch_ranks._served_run(one, torch.from_numpy(prompt).long(),
                                      STEPS)
    c = jengine.serve_config(jc)
    params = jax.tree.map(jnp.asarray, tree)
    one_device = jmesh.make_smoke_mesh((1, 1))
    prefill = jengine.build_prefill(c, one_device, cache_len=S + STEPS,
                                    batch=B)
    step = jengine.build_decode(c, one_device, batch=B)
    logits, caches = prefill(params, jnp.asarray(prompt))
    out, rows = [prompt], []
    for i in range(STEPS):
        rows.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        out.append(np.asarray(tok))
        if i + 1 < STEPS:
            logits, caches = step(params, tok, caches)
    ref = dict(tokens=np.concatenate(out, 1), logits=np.stack(rows))
    return dict(ranks=ranks, one=one_run, ref=ref, tree=tree, jc=jc, tc=tc)


def _ref_leaf(tree, cfg, path):
    """The reference's stacked leaf and super-block index of a port path."""
    parts = path.split("/")
    if parts[0] != "blocks":
        leaf = tree
        for p in parts:
            leaf = leaf[p]
        return leaf, None
    i, P = int(parts[1]), len(cfg.block_pattern)
    leaf = tree["blocks"][i % P]
    for p in parts[2:]:
        leaf = leaf[p]
    return leaf, i // P


CELLS = [(m, f) for m in SERVE_MESHES for f in (False, True)]
IDS = [f"{m[0]}x{m[1]}-{'fsdp' if f else 'nofsdp'}" for m, f in CELLS]


@pytest.mark.parametrize("mesh,fsdp", CELLS, ids=IDS)
def test_stored_blocks_are_the_reference_shards(served, mesh, fsdp):
    """Each rank's stored expert leaves are, exactly, the shard the
    reference's ``param_shardings(fsdp=, expert_tp=True)`` puts on that
    device (1/(M·D) of the leaf); under ``fsdp`` every leaf is; without
    it every dense leaf is whole."""
    tree, jc = served["tree"], served["jc"]
    jm = jmesh.make_smoke_mesh(mesh)
    specs = jmesh.param_shardings(jm, tree, fsdp=fsdp, expert_tp=True)
    D, M = mesh
    for r, res in enumerate(served["ranks"]):
        stored = res[mesh, "grouped", fsdp]["stored"]
        dev = jm.devices.flat[r]
        for path, block in stored.items():
            leaf, s = _ref_leaf(tree, jc, path)
            expert = shard.is_expert(path)
            if expert or fsdp:
                spec = _ref_leaf(specs, jc, path)[0]
                arr = jax.device_put(leaf, spec)
                want = next(np.asarray(x.data) for x in arr.addressable_shards
                            if x.device == dev)
                want = want if s is None else want[s]
            else:
                want = leaf if s is None else leaf[s]
            np.testing.assert_array_equal(block, want, err_msg=path)
            if expert and D * M > 1:
                whole = leaf[s]
                assert block.size * D * M == whole.size, path


@pytest.mark.parametrize("mesh,fsdp", CELLS, ids=IDS)
def test_stored_bytes_equal_the_dry_run(served, mesh, fsdp):
    """A rank's stored bytes equal ``dryrun.count_pair``'s stored params
    for the same config, mesh and layout, and the layout is what the
    model reports (``(fsdp, expert_tp)``: expert TP on at every mesh of
    more than one rank)."""
    tc = serve_config(served["tc"])
    rec = dryrun.count_pair(tc, ShapeConfig("t", S + STEPS, B, "decode"),
                            {"data": mesh[0], "model": mesh[1]},
                            fsdp=fsdp, expert_tp=True)
    for res in served["ranks"]:
        run = res[mesh, "grouped", fsdp]
        assert run["layout_key"] == (fsdp, True)
        assert run["stored_bytes"] == rec["stored_bytes"]["params"]


SERVED = [(m, n) for m in ((2, 2), (4, 1)) for n in ("nofsdp", "fsdp",
                                                     "no_tp")]


@pytest.mark.parametrize("mesh,run", SERVED,
                         ids=[f"{m[0]}x{m[1]}-{n}" for m, n in SERVED])
def test_prefill_decode_match_one_process_and_reference(served, mesh, run):
    """Greedy tokens equal one process's and the reference's on every rank
    (the stored slice, ``fsdp``, and ``REPRO_EXPERT_TP=0``'s experts
    stored whole in f), the ranks' logits bitwise equal, and every
    step's logits within atol 1e-4 of both (f32;
    ``test_torch_serve_ranks.py``'s bounds)."""
    ranks = served["ranks"]
    key = ((mesh, "no_tp") if run == "no_tp"
           else (mesh, "grouped", run == "fsdp"))
    for r, res in enumerate(ranks):
        got = res[key]
        np.testing.assert_array_equal(got["logits"], ranks[0][key]["logits"],
                                      err_msg=f"rank {r}")
        for want in (served["one"], served["ref"]):
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            np.testing.assert_allclose(got["logits"], want["logits"],
                                       rtol=0, atol=1e-4)
    if run == "no_tp":
        assert ranks[0][key]["layout_key"] == (False, False)


@pytest.mark.parametrize("mesh", ((2, 2), (4, 1)), ids=["2x2", "4x1"])
def test_fsdp_serving_is_bitwise_without(served, mesh):
    """Dense leaves stored sharded and gathered block by block give the
    same bits as dense leaves stored whole: tokens and every step's
    logits."""
    for res in served["ranks"]:
        a, b = res[mesh, "grouped", False], res[mesh, "grouped", True]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["logits"], b["logits"])


@pytest.mark.parametrize("mesh", ((2, 2), (4, 1)), ids=["2x2", "4x1"])
def test_stored_slice_matches_whole_f_views(served, mesh):
    """The decode on the stored, contiguous f-slice against the same
    computation on views of the rank's experts held whole in f (serving's
    layout before the slice was stored), the same weights: each step's
    logits within 1e-6 of that step's largest |logit| (f32)."""
    for res in served["ranks"]:
        got = res[mesh, "grouped", False]["logits"]
        views = res[mesh, "views"]["logits"]
        scale = np.abs(views).max(axis=(1, 2))
        err = np.abs(got - views).max(axis=(1, 2)) / scale
        assert (err <= 1e-6).all(), err


def _serve_log(tc, mesh, dispatch, fsdp, expert_tp, decode, rank=0):
    c = serve_config(tc, dispatch=dispatch)
    rec = dryrun.count_pair(
        c, ShapeConfig("t", S + STEPS if decode else S, B,
                       "decode" if decode else "prefill"),
        {"data": mesh[0], "model": mesh[1]}, fsdp=fsdp, expert_tp=expert_tp,
        rank=rank)
    return rec["plan"].log()


LOGS = [(m, d, f, p) for m in ((2, 2), (1, 4)) for d in ("grouped", "sort")
        for f in (False, True) for p in ("prefill", "decode")
        if not (d == "sort" and f)]


@pytest.mark.parametrize("mesh,dispatch,fsdp,phase", LOGS, ids=[
    f"{m[0]}x{m[1]}-{d}-{'fsdp' if f else 'nofsdp'}-{p}"
    for m, d, f, p in LOGS])
def test_serving_collectives_equal_the_dry_run(served, mesh, dispatch, fsdp,
                                               phase):
    """A prefill's and a decode step's collectives on every rank (kind,
    axis, group size, wire dtype, the rank's input shape, count), each
    with its greedy tokens' gather over ``data``, equal the dry run's
    plan of them for that rank (``dryrun.serve_plan``): the experts'
    gathers over ``data`` in the prefill, expert TP's on the stored slice
    in the decode, FSDP's gathers of the dense leaves, the exchanges, the
    context-parallel prefill's k/v gathers and last-row broadcast, the
    decode's heads or partial-softmax gathers over ``model``, the token
    routes and the outputs' all-gathers."""
    for r, res in enumerate(served["ranks"]):
        want = _serve_log(served["tc"], mesh, dispatch, fsdp, True,
                          phase == "decode", r)
        assert want
        got = collections.Counter(res[mesh, dispatch, fsdp]["logs"][phase])
        assert got == want, (r, got - want, want - got)


@pytest.mark.parametrize("mesh", ((2, 2),), ids=["2x2"])
def test_whole_f_decode_collectives_equal_the_dry_run(served, mesh):
    """``REPRO_EXPERT_TP=0``: the experts stored whole in f, the decode
    step without expert TP — its collectives equal the dry run's for
    ``expert_tp=False``."""
    for r, res in enumerate(served["ranks"]):
        want = _serve_log(served["tc"], mesh, "grouped", False, False, True,
                          r)
        assert collections.Counter(res[mesh, "no_tp"]["logs"]["decode"]) \
            == want


@pytest.mark.parametrize("mesh,dispatch,fsdp,b,s", TRAIN_CELLS, ids=[
    f"{m[0]}x{m[1]}-{d}-{'fsdp' if f else 'nofsdp'}"
    for m, d, f, _, _ in TRAIN_CELLS])
def test_train_collectives_equal_the_dry_run(served, mesh, dispatch, fsdp,
                                             b, s):
    """One train step's collectives on every rank equal
    ``dryrun.train_plan``'s: the MoE exchanges forward and backward (twice
    forward under FSDP, whose blocks recompute), FSDP's gathers and
    reduce-scatters, the row-group gathers of a split row (1x4, two rows)
    and the gradient all-reduces; the stored state's bytes equal the dry
    run's params + moments."""
    tc = served["tc"]
    tc = tc.replace(moe=dataclasses.replace(tc.moe, dispatch=dispatch))
    ms = {"data": mesh[0], "model": mesh[1]}
    shapes = param_shapes(tc)
    layout = shard.make_layout(shapes, ms, 0, fsdp=fsdp)
    want = dryrun.train_plan(tc, TrainConfig(), layout, shapes, b, s).log()
    rec = dryrun.count_pair(tc, ShapeConfig("t", s, b, "train"), ms,
                            fsdp=fsdp, tcfg=TrainConfig())
    for r, res in enumerate(served["ranks"]):
        cell = res["train", mesh, dispatch, fsdp]
        got = collections.Counter(cell["log"])
        assert got == want, (r, got - want, want - got)
        assert np.isfinite(cell["loss"])
        assert cell["state_bytes"] == (rec["stored_bytes"]["params"]
                                       + rec["stored_bytes"]["opt"])


def test_layout_refuses_a_width_that_does_not_divide():
    """Stored under expert TP, an expert FFN width that does not divide
    over ``data`` raises naming it; ``Transformer`` refuses params that
    are not the rank's share, naming the leaves."""
    _, tc = _cfgs()
    with pytest.raises(ValueError, match="does not divide over the data"):
        shard.make_layout(param_shapes(tc), {"data": 3, "model": 1}, 0,
                          fsdp=False, expert_tp=True)
    from types import SimpleNamespace
    mesh = SimpleNamespace(shape={"data": 2, "model": 2}, rank=0, world=4,
                           device=torch.device("cpu"), data_index=0,
                           model_index=0, describe=lambda: "2x2")
    whole = {p: torch.zeros(t.shape) for p, t in tree_paths(param_shapes(tc))}
    from repro_torch.launch.mesh import map_paths
    params = map_paths(lambda p, t: whole[p], param_shapes(tc))
    with pytest.raises(ValueError, match="not this rank's share"):
        Transformer(serve_config(tc), device="cpu", mesh=mesh, params=params)
