"""Serving across ranks: the port's ``generate``, ``SlotServer`` and
``launch/serve.py`` at mesh 2x2 on gloo CPU ranks (``launch.mesh.spawn``)
against the reference's at ``make_smoke_mesh((2, 2))`` on the conftest's
fake devices, the same weights (the reference's ``init_model`` through
``convert.params_from_numpy``, each rank's experts cut from them) and the
same seeded prompts.  The model: the paper preset's smoke config (2
``moe`` layers, d=128, 4 experts) with swiglu experts and a top-2 gate,
f32, its tuned knobs pinned.  The prefill runs expert parallel, each
decode step expert TP over the data group; the activations and caches are
whole on every rank."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from repro import configs as jconfigs
from repro.core import tuning as jtuning
from repro.launch.mesh import make_smoke_mesh as jmake_smoke_mesh
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import SlotServer as JSlotServer
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.core import tuning
from repro_torch.launch.mesh import spawn
from repro_torch.serving import engine

ARCH = "hetumoe-paper-16e"
SHAPE = (2, 2)
STEPS = 4
S = 6                                   # prompt length
BATCHES = {"b8": 8, "b3": 3, "b1": 1}   # 3 and 1 pad to the world of 4
DISPATCHES = ("grouped", "sort")
PINNED = dict(gate="topk", top_k=2, a2a="flat", overlap_chunks=1,
              grouped_block_m=None, grouped_ep_bound_factor=None)
SLOTS = dict(slots=2, cache_len=16)


def _cfgs(**moe_kw):
    """(reference, port) f32 configs; the reference's plain gate (the same
    semantics as its Pallas one, which the one-device tests hold)."""
    jc = jconfigs.smoke_config(ARCH)
    tc = configs.smoke_config(ARCH)
    jc = jc.replace(act="swiglu", dtype="float32", moe=dataclasses.replace(
        jc.moe, use_pallas_gate=False, **PINNED, **moe_kw))
    tc = tc.replace(act="swiglu", dtype="float32", moe=dataclasses.replace(
        tc.moe, **PINNED, **moe_kw))
    return jc, tc


def _prompts():
    rng = np.random.default_rng(16)
    return {k: rng.integers(0, 512, (b, S)).astype(np.int32)
            for k, b in BATCHES.items()}


def _slot_specs():
    """A short seeded replay: 5 requests of S-token prompts (the aligned
    refill admits each into a free slot) and budgets of 2-5 tokens."""
    rng = np.random.default_rng(17)
    return [(u, rng.integers(0, 512, (S,)).astype(np.int32),
             int(rng.integers(2, 6))) for u in range(5)]


CLI = ["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len", "5",
       "--gen", "3", "--device", "cpu", "--mesh", "2x2", "--backend", "gloo",
       "--dispatch", "grouped"]


@pytest.fixture(scope="module")
def served():
    """The port's ranks (one spawn) and the reference, over one weight
    tree: per (dispatch, batch) the reference's greedy tokens and
    logits, and its SlotServer's requests."""
    jc, tc = _cfgs()
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(3),
                                                   jc))
    prompts = _prompts()
    ranks = spawn(torch_ranks.serve_rank, 4, backend="gloo", threads=1,
                  args=(SHAPE, tc, tree, prompts, STEPS, DISPATCHES,
                        (SLOTS, _slot_specs()), CLI))
    mesh = jmake_smoke_mesh(SHAPE)
    params = jax.tree.map(jnp.asarray, tree)
    ref = {}
    for dispatch in DISPATCHES:
        c = jengine.serve_config(jc, dispatch=dispatch)
        for name, p in prompts.items():
            B = p.shape[0]
            prefill = jengine.build_prefill(c, mesh, cache_len=S + STEPS,
                                            batch=B)
            step = jengine.build_decode(c, mesh, batch=B)
            logits, caches = prefill(params, jnp.asarray(p))
            out, rows = [p], []
            for i in range(STEPS):
                rows.append(np.asarray(logits[:, -1], np.float32))
                tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
                out.append(np.asarray(tok))
                if i + 1 < STEPS:
                    logits, caches = step(params, tok, caches)
            gen = np.asarray(jengine.generate(params, c, jnp.asarray(p),
                                              steps=STEPS, mesh=mesh))
            ref[dispatch, name] = dict(tokens=gen,
                                       loop_tokens=np.concatenate(out, 1),
                                       logits=np.stack(rows))
    c = jengine.serve_config(jc, dispatch=DISPATCHES[0])
    done = JSlotServer(c, params, mesh=mesh, **SLOTS).run(
        [JRequest(uid=u, prompt=jnp.asarray(p), max_new=m)
         for u, p, m in _slot_specs()])
    ref["slot"] = [(r.uid, r.status, r.error, [int(t) for t in r.out],
                    r.steps_used) for r in done]
    return ranks, ref


CELLS = [(d, b) for d in DISPATCHES for b in BATCHES]


@pytest.mark.parametrize("dispatch,batch", CELLS,
                         ids=[f"{d}-{b}" for d, b in CELLS])
def test_generate_matches_reference_at_2x2(served, dispatch, batch):
    """``generate`` at 2x2 gives the reference's greedy tokens at the same
    mesh, on every rank bitwise; its prefill and decode logits are the
    reference's within atol 1e-4 (f32); ``REPRO_EXPERT_TP=0`` (decode
    without expert TP) gives the same tokens."""
    ranks, ref = served
    want = ref[dispatch, batch]
    np.testing.assert_array_equal(want["loop_tokens"], want["tokens"])
    for r, res in enumerate(ranks):
        got = res[dispatch, batch]
        np.testing.assert_array_equal(got["tokens"], ranks[0][
            dispatch, batch]["tokens"], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["logits"], ranks[0][
            dispatch, batch]["logits"], err_msg=f"rank {r} logits")
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["loop_tokens"], got["tokens"])
        np.testing.assert_array_equal(got["no_tp"], got["tokens"])
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=1e-4)


def test_slot_server_matches_reference_at_2x2(served):
    """``SlotServer`` at 2x2 (grouped, 2 slots, caches of 16) completes a
    seeded replay of 5 requests with the reference server's statuses,
    tokens and steps, in its order, on every rank; its step is eager, and
    asking for a captured one across ranks raises, saying why."""
    ranks, ref = served
    for res in ranks:
        assert res["slot"] == ref["slot"]
        assert res["slot_graph"] is False
        assert "CUDA graph capture cannot hold" in res["graph_refusal"]
    assert all(s == "ok" for _, s, *_ in ref["slot"])


def test_serve_cli_runs_at_2x2(served):
    """``launch.serve.main(["--mesh", "2x2", "--backend", "gloo", ...])``
    runs in the ranks ``spawn`` started: rank 0 prints the banner (mesh,
    backend, expert TP, the eager decode) and the result; the others
    print nothing."""
    ranks, _ = served
    text = ranks[0]["cli"]
    assert "mesh=2x2 backend=gloo ranks=4" in text
    assert "expert_tp=data decode=eager (collectives across ranks)" in text
    assert "-> (3, 8)" in text
    assert all(r["cli"] == "" for r in ranks[1:])


class _FakeMesh(types.SimpleNamespace):
    """A mesh's shape and world, what the decode-config checks read."""


@pytest.mark.parametrize("shape,batch", [((2, 2), 8), ((2, 2), 3),
                                         ((1, 4), 1), ((2, 4), 6)])
def test_decode_config_resolves_like_reference(shape, batch):
    """``resolve_decode_config`` at a mesh resolves the paper preset's
    "auto" knobs (grouped) at the decode step's tokens a rank as the
    reference's does (the same fabric pair and compute rate);
    ``validate_decode_config`` raises where the reference's raises: 3
    overlap windows do not divide the bound at these tiny batches, and a
    hierarchical inner of 3 does not divide the model axis; the messages
    are the reference's word for word."""
    from test_torch_ep import FABRIC, TFABRIC
    jc = jconfigs.get_config(ARCH)
    tc = configs.get_config(ARCH)
    jc = jc.replace(moe=dataclasses.replace(jc.moe, dispatch="grouped"))
    tc = tc.replace(moe=dataclasses.replace(tc.moe, dispatch="grouped"))
    jmesh = jmake_smoke_mesh(shape)
    tmesh = _FakeMesh(shape={"data": shape[0], "model": shape[1]},
                      world=shape[0] * shape[1])
    jprev = jtuning.set_tuning(mode="auto", fabric=FABRIC)
    prev = tuning.set_tuning(mode="auto", fabric=TFABRIC,
                             flops=jtuning.NOMINAL_FLOPS)
    try:
        jr = jengine.resolve_decode_config(jc, jmesh, batch)
        tr = engine.resolve_decode_config(tc, batch, tmesh)
        for knob in tuning.TUNED_KNOBS + ("a2a_inner",):
            assert getattr(tr.moe, knob) == getattr(jr.moe, knob), knob
        engine.validate_decode_config(tc, batch, mesh=tmesh)
        jengine.validate_decode_config(jc, jmesh, batch)
        for bad in (dict(overlap_chunks=3), dict(a2a="hierarchical",
                                                 a2a_inner=3)):
            jb = jc.replace(moe=dataclasses.replace(jc.moe, **bad))
            tb = tc.replace(moe=dataclasses.replace(tc.moe, **bad))
            with pytest.raises(ValueError) as je:
                jengine.validate_decode_config(jb, jmesh, batch)
            with pytest.raises(ValueError) as te:
                engine.validate_decode_config(tb, batch, mesh=tmesh)
            assert str(te.value) == str(je.value)
    finally:
        jtuning.set_tuning(*jprev)
        tuning.set_tuning(*prev)


def test_payload_dtype_overrides_like_reference():
    """``serve_config(payload_dtype=)`` sets the grouped exchange's wire
    dtype as the reference's does, and refuses it on a dense preset."""
    jc, tc = _cfgs()
    for pd in ("int8", "float8_e4m3fn"):
        assert (engine.serve_config(tc, payload_dtype=pd).moe.payload_dtype
                == jengine.serve_config(jc, payload_dtype=pd).moe
                .payload_dtype == pd)
    assert engine.serve_config(tc, payload_dtype=None) is tc
    with pytest.raises(ValueError, match="has no MoE layer"):
        engine.serve_config(configs.smoke_config("yi-6b"),
                            payload_dtype="int8")
