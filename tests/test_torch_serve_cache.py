"""Served caches stored by the reference's cache rule: the port's
``Transformer(mesh=)`` on four gloo CPU ranks (``launch.mesh.spawn``, one
spawn a mesh; the rank body ``torch_ranks.serve_cache_rank``) against one
process and the reference, over one weight tree (the reference's
``init_model`` through ``convert.params_from_numpy(..., serving=True)``).

The model: the paper preset's smoke config (2 ``moe`` layers, d=128, 4
heads over 2 kv heads of 32, 4 experts) with a top-2 gate and the
dropless grouped dispatch, f32, in two cells: ``ring`` (a danube-style
window of 16 on every layer; a 24-token prompt past it, so each cache is
a ring of 16 filled from a rolled prompt) and ``linear`` (no window, a
12-token prompt into caches of 16).  At 2x2 the 2 kv heads go over
``model`` (the ``heads`` form); at 1x4 they do not divide, so the cache
positions do (``positions``).  Each rank holds its data rank's rows,
prefills its model rank's chunk of their positions (k and v gathered
over the model group), and routes the reference's block of the tokens in
every ``moe`` block.  With the grouped dispatch no token is dropped, so
one process's tokens are the reference's at any mesh.  A run into caches
of 10 positions puts the 1x4 caches in their channels (``channels``)."""
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
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import ShapeConfig
from repro_torch.launch import dryrun, shard
from repro_torch.launch.mesh import cache_spec, spawn
from repro_torch.models.transformer import Transformer

ARCH = "hetumoe-paper-16e"
MESHES = ((2, 2), (1, 4))
FORMS = {(2, 2): "heads", (1, 4): "positions"}
STEPS = 4                  # the prefill's logits and 3 decode steps'
B = 4
# name -> (window, prompt length): caches of S + STEPS positions, a ring of
# the window where it is shorter
CELLS = {"ring": (16, 24), "linear": (None, 12)}
PINNED = dict(gate="topk", top_k=2, dispatch="grouped", a2a="flat",
              overlap_chunks=1, grouped_block_m=None,
              grouped_ep_bound_factor=None)
TOL = 1e-5                 # of each step's (each leaf's) largest magnitude


def _cfgs(window):
    """(reference, port) f32 configs; the reference's plain gate."""
    jc = jconfigs.smoke_config(ARCH)
    tc = configs.smoke_config(ARCH)
    jc = jc.replace(dtype="float32", attention=dataclasses.replace(
        jc.attention, window=window), moe=dataclasses.replace(
        jc.moe, use_pallas_gate=False, **PINNED))
    tc = tc.replace(dtype="float32", attention=dataclasses.replace(
        tc.attention, window=window), moe=dataclasses.replace(
        tc.moe, **PINNED))
    return jc, tc


def _prompts():
    rng = np.random.default_rng(31)
    return {name: rng.integers(0, 512, (B, S)).astype(np.int32)
            for name, (_, S) in CELLS.items()}


def _slot_run():
    """Per cell: 2 slots over caches of S + STEPS, 5 requests of S-token
    prompts (the aligned refill admits each into a free slot) with
    budgets of 2-4 tokens."""
    rng = np.random.default_rng(37)
    return {name: (dict(slots=2, cache_len=S + STEPS),
                   [(u, rng.integers(0, 512, (S,)).astype(np.int32),
                     int(rng.integers(2, 5))) for u in range(5)])
            for name, (_, S) in CELLS.items()}


def _reference(jc, tree, prompt):
    """The reference's greedy run on one device: each step's logits
    (prefill, then decode steps) and ``generate``'s tokens."""
    c = jengine.serve_config(jc)
    params = jax.tree.map(jnp.asarray, tree)
    one = jmesh.make_smoke_mesh((1, 1))
    S = prompt.shape[1]
    prefill = jengine.build_prefill(c, one, cache_len=S + STEPS, batch=B)
    step = jengine.build_decode(c, one, batch=B)
    logits, caches = prefill(params, jnp.asarray(prompt))
    rows = []
    for i in range(STEPS):
        rows.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        if i + 1 < STEPS:
            logits, caches = step(params, tok, caches)
    gen = np.asarray(jengine.generate(params, c, jnp.asarray(prompt),
                                      steps=STEPS, mesh=one))
    return dict(logits=np.stack(rows), tokens=gen)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per cell the reference's run, one process's (its whole caches
    after the last step, its ``SlotServer`` outputs) and per mesh the
    ranks' runs."""
    jc0, _ = _cfgs(None)
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(7),
                                                   jc0))
    path = tmp_path_factory.mktemp("serve_cache") / "tree.pkl"
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    prompts, slot_run = _prompts(), _slot_run()
    cells = [(name, _cfgs(w)[1], prompts[name])
             for name, (w, _) in CELLS.items()]
    ranks = {shape: spawn(torch_ranks.serve_cache_rank, 4, backend="gloo",
                          threads=1, args=(shape, str(path), cells, STEPS,
                                           slot_run))
             for shape in MESHES}
    ref, one = {}, {}
    for name, (window, _) in CELLS.items():
        jc, tc = _cfgs(window)
        ref[name] = _reference(jc, tree, prompts[name])
        model = Transformer(tc, device="cpu",
                            params=params_from_numpy(tree, tc))
        one[name] = torch_ranks._served_run(
            model, torch.from_numpy(prompts[name]).long(), STEPS,
            keep_caches=True)
        one[name]["slot"] = torch_ranks.slot_outputs(model,
                                                     *slot_run[name])
        one[name]["channels"] = torch_ranks._served_run(
            model, torch.from_numpy(prompts[name][:, :torch_ranks
                                                  .CHANNEL_PROMPT]).long(),
            STEPS)
    return dict(ranks=ranks, ref=ref, one=one)


CASES = [(m, c) for m in MESHES for c in CELLS]
IDS = [f"{m[0]}x{m[1]}-{c}" for m, c in CASES]


def _rel(got, want, axes):
    scale = np.abs(want).max(axis=axes)
    return np.abs(got - want).max(axis=axes) / scale


@pytest.mark.parametrize("mesh,cell", CASES, ids=IDS)
def test_tokens_and_logits_match_reference(served, mesh, cell):
    """``generate``'s tokens on every rank equal one process's and the
    reference's ``generate``; the prefill's logits and 3 decode steps'
    (each rank's rows gathered over ``data``) are within 1e-5 of each
    step's largest |logit| of the reference's (f32)."""
    ref, one = served["ref"][cell], served["one"][cell]
    np.testing.assert_array_equal(one["tokens"], ref["tokens"])
    for r, res in enumerate(served["ranks"][mesh]):
        got = res[cell]
        np.testing.assert_array_equal(got["generate"], ref["tokens"],
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["tokens"], ref["tokens"])
        err = _rel(got["logits"], ref["logits"], (1, 2))
        assert (err <= TOL).all(), (r, err)


@pytest.mark.parametrize("mesh,cell", CASES, ids=IDS)
def test_cache_blocks_are_the_cache_spec_blocks(served, mesh, cell):
    """Every cache leaf a rank holds after the prefill and 3 decode steps
    is its block by ``launch/mesh.cache_spec`` (the rows over ``data``,
    the kv heads at 2x2, the ring's or the linear cache's positions at
    1x4) of one process's leaf, within 1e-5 of the leaf's largest
    magnitude; the positions equal."""
    D, M = mesh
    ms = {"data": D, "model": M}
    whole = served["one"][cell]["caches"]
    for r, res in enumerate(served["ranks"][mesh]):
        got = res[cell]["caches"]
        assert set(got) == set(whole)
        for path, w in whole.items():
            spec = cache_spec(ms, w.shape)
            if path.endswith("/k"):
                assert spec[{"heads": 2, "positions": 1}[FORMS[mesh]]] \
                    == "model", (path, spec)
            lay = shard.Layout(ms, r, False, {path: spec})
            want = w[lay.block(path, w.shape)]
            assert got[path].shape == want.shape, (r, path)
            if w.ndim == 0:
                assert got[path] == want, (r, path)
            else:
                err = np.abs(got[path] - want).max() / np.abs(w).max()
                assert err <= TOL, (r, path, err)


@pytest.mark.parametrize("mesh,cell", CASES, ids=IDS)
def test_cache_bytes_and_collectives_equal_the_dry_run(served, mesh, cell):
    """A rank's cache bytes equal the dry run's ``caches`` (its keys and
    values 1/4 of one process's; the positions replicate), and the
    collectives it logs in the prefill and in a decode step (each with
    its greedy tokens' gather over ``data``) equal the dry run's plan of
    them for that rank, op for op."""
    window, S = CELLS[cell]
    tc = _cfgs(window)[1]
    ms = {"data": mesh[0], "model": mesh[1]}

    def kv_bytes(caches):
        return sum(a.nbytes for a in caches.values() if a.ndim)
    one = kv_bytes(served["one"][cell]["caches"])
    for r, res in enumerate(served["ranks"][mesh]):
        got = res[cell]
        for phase, shp in (("prefill", ShapeConfig("t", S, B, "prefill")),
                           ("decode", ShapeConfig("t", S + STEPS, B,
                                                  "decode"))):
            rec = dryrun.count_pair(tc, shp, ms, fsdp=False,
                                    expert_tp=True, rank=r)
            if phase == "decode":
                assert got["cache_bytes"] == rec["stored_bytes"]["caches"]
                assert kv_bytes(got["caches"]) * 4 == one
            want = rec["plan"].log()
            log = collections.Counter(got["logs"][phase])
            assert log == want, (r, phase, log - want, want - log)


@pytest.mark.parametrize("mesh,cell", CASES, ids=IDS)
def test_slot_server_matches_one_process(served, mesh, cell):
    """``SlotServer`` with a mesh (2 slots: over ``data`` at 2x2) gives one
    process's statuses, tokens and steps on every rank over a seeded
    replay of 5 requests."""
    want = served["one"][cell]["slot"]
    assert all(s == "ok" for _, s, *_ in want)
    for res in served["ranks"][mesh]:
        assert res[cell]["slot"] == want


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_a_channel_cut_raises_naming_it(served, mesh):
    """Caches of 10 positions (a 6-token prompt, 4 steps; the ``ring``
    cell's window of 16 is longer, so they are linear): at 2x2 the kv
    heads still divide; at 1x4 neither they nor the positions do, and the
    (4, 10, 2, 32) caches are cut in their channels (8 of 32 a rank),
    where a decode step once raised; served so, every rank's tokens
    equal one process's and its logits are within 1e-5 of each step's
    largest |logit| of one process's, as ``launch/shard.cache_layout_for``
    lays them out without ranks."""
    want = served["one"]["ring"]["channels"]
    form = {(2, 2): "heads", (1, 4): "channels"}[mesh]
    for r, res in enumerate(served["ranks"][mesh]):
        got = res["ring"]["channels"]
        assert got["forms"] == (form,) * 2, r
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        err = _rel(got["logits"], want["logits"], (1, 2))
        assert (err <= TOL).all(), (r, err)
    tc = _cfgs(None)[1]
    lay = shard.cache_layout_for(tc, {"data": 1, "model": 4}, 4, 10)
    assert lay.forms == ("channels",) * 2
    assert [x["block_shape"] for x in lay.leaves()
            if x["path"].endswith("/k")] == [(4, 10, 2, 8)] * 2
