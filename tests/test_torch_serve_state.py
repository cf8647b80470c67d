"""Every served cache stored by the reference's cache rule: the recurrent
states cut over ``model`` and the attention cache's channel cut, on four
gloo CPU ranks (``launch.mesh.spawn``, one spawn a mesh shared by its
cells; the rank body ``torch_ranks.serve_state_rank``) against one
process and the reference, over one weight tree a cell (a seeded draw
in the reference's tree, with the leaves that init to zero or one drawn
away from it, through ``convert.params_from_numpy(..., serving=True)``),
f32.

The cells (``CELLS``), by the form ``launch/mesh.cache_spec`` gives:

* ``rwkv``: rwkv6's smoke config (8 heads of 16) at 1x4 and 2x2: ``s``
  (B, H, hd_k, hd_v) cut in its key dim, the output summed over
  ``model``;
* ``zamba2``: zamba2's smoke config at 2x2 and 1x4: Mamba's ``s`` (B, H,
  hd, N) cut in its head dim, ``conv`` (B, 3, 288) in its channels, the
  shared attention's 2 kv heads over ``model`` (2x2) or its 16 positions
  (1x4);
* ``zamba2-k5``: the same with ``conv_width=5`` (both packages' configs
  replaced alike) at 1x4: ``conv``'s K−1 = 4 positions over ``model``;
* ``rwkv-h``: rwkv6 with d=96 in 16 heads of 6 at 1x4: the heads form;
* ``channels`` / ``channels-ring``: the paper preset's smoke config (2
  kv heads of 32, top-2 grouped) at 1x4 with caches of 15 positions, and
  with a window of 10 and a 13-token prompt (a ring of 10): neither the
  kv heads nor the slots divide over 4, so each cache is cut in its
  channels.

Besides, ``decode_forms`` holds every decode form of a cut state or cache
(RWKV's ``s`` in each of its three inner dims, Mamba's ``s`` in each of
its three with ``conv`` in each of its two, attention's ``heads``,
``positions`` and ``channels``, linear and ring) on each rank's block
against the whole step, including the forms no preset's shapes reach."""
import collections
import concurrent.futures
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
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.config import AttentionConfig, ShapeConfig
from repro_torch.launch import dryrun, shard
from repro_torch.launch.mesh import cache_spec, spawn
from repro_torch.models.transformer import Transformer, init_params

PAPER = "hetumoe-paper-16e"
STEPS = 4                  # the prefill's logits and 3 decode steps'
B = 4
TOL = 1e-5                 # of each step's (each leaf's) largest magnitude
PINNED = dict(gate="topk", top_k=2, dispatch="grouped", a2a="flat",
              overlap_chunks=1, grouped_block_m=None,
              grouped_ep_bound_factor=None)
# name -> (preset, replaced sub-config fields, prompt length, meshes); the
# caches hold the prompt and STEPS positions
CELLS = {
    "rwkv": ("rwkv6-1.6b", {}, 12, ((1, 4), (2, 2))),
    "zamba2": ("zamba2-7b", {}, 12, ((2, 2), (1, 4))),
    "zamba2-k5": ("zamba2-7b", {"ssm": {"conv_width": 5}}, 12, ((1, 4),)),
    "rwkv-h": ("rwkv6-1.6b", {"rwkv": {"head_dim": 6}, "": {"d_model": 96}},
               12, ((1, 4),)),
    "channels": (PAPER, {"attention": {"window": None}}, 11, ((1, 4),)),
    "channels-ring": (PAPER, {"attention": {"window": 10}}, 13, ((1, 4),)),
}
MESHES = ((1, 4), (2, 2))
# (cell, mesh) -> each layer's attention form and each layer's state cuts
FORMS = {
    ("rwkv", (1, 4)): ((None,) * 2, ((("s", 2),),) * 2),
    ("rwkv", (2, 2)): ((None,) * 2, ((("s", 2),),) * 2),
    ("zamba2", (2, 2)): ((None, None, "heads"),
                         ((("s", 2), ("conv", 2)),) * 3),
    ("zamba2", (1, 4)): ((None, None, "positions"),
                         ((("s", 2), ("conv", 2)),) * 3),
    ("zamba2-k5", (1, 4)): ((None, None, "positions"),
                            ((("s", 2), ("conv", 1)),) * 3),
    ("rwkv-h", (1, 4)): ((None,) * 2, ((("s", 1),),) * 2),
    ("channels", (1, 4)): (("channels",) * 2, ((), ())),
    ("channels-ring", (1, 4)): (("channels",) * 2, ((), ())),
}
# the cell SlotServer replays on every mesh
SLOT_CELL = "rwkv"
# leaves drawn away from their zero (or one) init: name -> scale of the draw
PERTURB = {"ln1": 0.1, "ln2": 0.1, "sa_ln": 0.1, "ln": 0.1,
           "final_norm": 0.1, "norm": 0.2, "conv_b": 0.2, "sa_lora_b": 0.1,
           "ln_x": 0.2}
# decode_forms' shapes: the rwkv smoke time mix, zamba2's smoke SSM with a
# conv of width 5 (K-1 = 4 positions), 8 heads over 4 kv heads of 16
FORM_D = 128
FORM_NAMES = ([f"rwkv/s{d}" for d in (1, 2, 3)]
              + [f"mamba/s{s}conv{c}" for s in (1, 2, 3) for c in (1, 2)]
              + [f"attention/{f}{r}" for r in ("", "/ring")
                 for f in ("heads", "positions", "channels")])


def _replace(cfg, changes):
    """``cfg`` with each sub-config's fields replaced (the key ``""``: the
    config's own)."""
    for field, kw in changes.items():
        cfg = cfg.replace(**kw) if not field else cfg.replace(**{
            field: dataclasses.replace(getattr(cfg, field), **kw)})
    return cfg


def _cfgs(cell):
    """(reference, port) f32 configs of ``cell``; the paper preset's MoE
    pinned (top-2, grouped) and the reference's plain gate."""
    arch, changes, _, _ = CELLS[cell]
    jc = _replace(jconfigs.smoke_config(arch).replace(dtype="float32"),
                  changes)
    tc = _replace(configs.smoke_config(arch).replace(dtype="float32"),
                  changes)
    if jc.moe is not None:
        jc = jc.replace(moe=dataclasses.replace(
            jc.moe, use_pallas_gate=False, **PINNED))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **PINNED))
    return jc, tc


def _tree(tc):
    """Smoke parameters in the reference's tree (numpy): the port's seeded
    draw (``init_params``, the reference's leaves and scales) through
    ``convert.params_to_numpy``, the ``PERTURB`` leaves drawn around
    their init."""
    p = params_to_numpy(init_params(tc, torch.Generator().manual_seed(7)),
                        tc)
    rng = np.random.default_rng(21)
    flat, treedef = jax.tree_util.tree_flatten_with_path(p)
    leaves = []
    for path, a in flat:
        if str(getattr(path[-1], "key", "")) in PERTURB:
            a = (a + PERTURB[str(path[-1].key)] * rng.standard_normal(
                a.shape)).astype(np.float32)
        leaves.append(a)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _prompts():
    rng = np.random.default_rng(41)
    return {name: rng.integers(0, 512, (B, S)).astype(np.int32)
            for name, (_, _, S, _) in CELLS.items()}


def _slot_run():
    """2 slots over caches of S + STEPS, 5 requests of S-token prompts with
    budgets of 2-4 tokens."""
    rng = np.random.default_rng(43)
    S = CELLS[SLOT_CELL][2]
    return {SLOT_CELL: (dict(slots=2, cache_len=S + STEPS),
                        [(u, rng.integers(0, 512, (S,)).astype(np.int32),
                          int(rng.integers(2, 5))) for u in range(5)])}


def _reference(jc, tree, prompt):
    """The reference's greedy run on one device: each step's logits
    (prefill, then decode steps) and its tokens."""
    c = jengine.serve_config(jc)
    params = jax.tree.map(jnp.asarray, tree)
    one = jmesh.make_smoke_mesh((1, 1))
    S = prompt.shape[1]
    prefill = jengine.build_prefill(c, one, cache_len=S + STEPS, batch=B)
    step = jengine.build_decode(c, one, batch=B)
    logits, caches = prefill(params, jnp.asarray(prompt))
    rows, toks = [], [prompt]
    for i in range(STEPS):
        rows.append(np.asarray(logits[:, -1], np.float32))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        toks.append(np.asarray(tok, np.int32))
        if i + 1 < STEPS:
            logits, caches = step(params, tok, caches)
    return dict(logits=np.stack(rows), tokens=np.concatenate(toks, 1))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Per cell the reference's run and one process's (its caches after the
    prefill and after the last step, its ``SlotServer`` outputs), and per
    mesh the ranks' runs of its cells (the 1x4 spawn also runs
    ``decode_forms``)."""
    tmp = tmp_path_factory.mktemp("serve_state")
    prompts, slot_run = _prompts(), _slot_run()
    trees, paths = {}, {}
    for name in CELLS:
        tc = _cfgs(name)[1]
        key = (CELLS[name][0], tuple(sorted(
            (f, tuple(sorted(kw.items()))) for f, kw in CELLS[name][1].items()
            if f != "attention")))
        if key not in trees:
            trees[key] = _tree(tc)
            paths[key] = str(tmp / f"tree{len(paths)}.pkl")
            with open(paths[key], "wb") as f:
                pickle.dump(trees[key], f)
        trees[name], paths[name] = trees[key], paths[key]
    forms = (configs.smoke_config("rwkv6-1.6b").rwkv,
             dataclasses.replace(configs.smoke_config("zamba2-7b").ssm,
                                 conv_width=5),
             AttentionConfig(num_heads=8, num_kv_heads=4, head_dim=16),
             FORM_D)

    def ranks_run(shape):
        cells = [(name, _cfgs(name)[1], paths[name], prompts[name])
                 for name, (*_, meshes) in CELLS.items() if shape in meshes]
        return spawn(torch_ranks.serve_state_rank, 4, backend="gloo",
                     threads=1, args=(shape, cells, STEPS, slot_run,
                                      forms if shape == (1, 4) else None))
    # the ranks run while this process takes the reference's and one
    # process's runs
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = {shape: pool.submit(ranks_run, shape) for shape in MESHES}
        ref, one = _one_device(trees, prompts, slot_run)
        ranks = {shape: f.result() for shape, f in spawned.items()}
    return dict(ranks=ranks, ref=ref, one=one)


def _one_device(trees, prompts, slot_run):
    """Per cell the reference's run and one process's."""
    ref, one = {}, {}
    for name in CELLS:
        jc, tc = _cfgs(name)
        ref[name] = _reference(jc, trees[name], prompts[name])
        model = Transformer(tc, device="cpu",
                            params=params_from_numpy(trees[name], tc))
        one[name] = torch_ranks._served_run(
            model, torch.from_numpy(prompts[name]).long(), STEPS,
            keep_caches=True)
        if name in slot_run:
            one[name]["slot"] = torch_ranks.slot_outputs(model,
                                                         *slot_run[name])
    return ref, one


CASES = [(m, c) for c, (*_, meshes) in CELLS.items() for m in meshes]
IDS = [f"{m[0]}x{m[1]}-{c}" for m, c in CASES]


def _rel(got, want, axes):
    scale = np.abs(want).max(axis=axes)
    return np.abs(got - want).max(axis=axes) / scale


@pytest.mark.parametrize("mesh,cell", CASES, ids=IDS)
def test_tokens_and_logits_match_reference(served, mesh, cell):
    """``generate``'s tokens on every rank equal one process's and the
    reference's greedy tokens; the prefill's logits and 3 decode steps'
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
    """The caches' forms and state cuts are the cell's (``FORMS``), and
    every cache leaf a rank holds after the prefill and after 3 decode
    steps is its block by ``launch/mesh.cache_spec`` of one process's
    leaf, within 1e-5 of the leaf's largest magnitude; the positions
    equal."""
    ms = {"data": mesh[0], "model": mesh[1]}
    for r, res in enumerate(served["ranks"][mesh]):
        got = res[cell]
        assert (got["forms"], got["dims"]) == FORMS[cell, mesh], r
        for when in ("prefill_caches", "caches"):
            whole = served["one"][cell][when]
            assert set(got[when]) == set(whole)
            for path, w in whole.items():
                lay = shard.Layout(ms, r, False, {path: cache_spec(ms,
                                                                   w.shape)})
                want = w[lay.block(path, w.shape)]
                assert got[when][path].shape == want.shape, (r, path)
                if w.ndim == 0:
                    assert got[when][path] == want, (r, path)
                else:
                    err = np.abs(got[when][path] - want).max() / np.abs(
                        w).max()
                    assert err <= TOL, (r, when, path, err)


@pytest.mark.parametrize("mesh,cell", CASES, ids=IDS)
def test_cache_bytes_and_collectives_equal_the_dry_run(served, mesh, cell):
    """A rank's cache bytes equal the dry run's ``caches`` (less than one
    process's: every leaf but the positions and rwkv's ``x_last`` cut over
    ``model``), and the collectives it logs in the prefill and in a
    decode step (each with its greedy tokens' gather over ``data``)
    equal the dry run's plan of them for that rank, op for op."""
    S = CELLS[cell][2]
    tc = _cfgs(cell)[1]
    ms = {"data": mesh[0], "model": mesh[1]}
    one = sum(a.nbytes for a in served["one"][cell]["caches"].values())
    for r, res in enumerate(served["ranks"][mesh]):
        got = res[cell]
        for phase, shp in (("prefill", ShapeConfig("t", S, B, "prefill")),
                           ("decode", ShapeConfig("t", S + STEPS, B,
                                                  "decode"))):
            rec = dryrun.count_pair(tc, shp, ms, fsdp=False,
                                    expert_tp=tc.moe is not None, rank=r)
            if phase == "decode":
                assert got["cache_bytes"] == rec["stored_bytes"]["caches"]
                assert got["cache_bytes"] < one
            want = rec["plan"].log()
            log = collections.Counter(got["logs"][phase])
            assert log == want, (r, phase, log - want, want - log)


@pytest.mark.parametrize("mesh", MESHES, ids=["1x4", "2x2"])
def test_slot_server_matches_one_process(served, mesh):
    """``SlotServer`` with a mesh over rwkv6 (2 slots: over ``data`` at
    2x2; each slot's states cut over ``model`` as the batch's are, its
    prefill's written by their blocks) gives one process's statuses,
    tokens and steps on every rank over a seeded replay of 5 requests."""
    want = served["one"][SLOT_CELL]["slot"]
    assert all(s == "ok" for _, s, *_ in want)
    for res in served["ranks"][mesh]:
        assert res[SLOT_CELL]["slot"] == want


@pytest.mark.parametrize("form", FORM_NAMES)
def test_decode_forms(served, form):
    """Each decode form on every rank's block (1x4) against the whole step
    on the same weights, state and token: the output and the rank's
    block of the new state (the written cache) within 1e-5 of their
    largest magnitude."""
    for r, res in enumerate(served["ranks"][(1, 4)]):
        y_err, state_err = res["forms"][form]
        assert y_err <= TOL and state_err <= TOL, (r, y_err, state_err)
