"""Context parallelism: a batch with fewer rows than ranks, each row's
positions split over the ranks that share it (``launch/mesh.token_block``),
on gloo CPU ranks (``launch.mesh.spawn``, one spawn of four ranks; rank
bodies in ``tests/torch_ranks.py``) against the JAX package on the
conftest's fake devices, from the same numpy inputs: ``full_attention``
at 1x4 (B=1: four ranks a row; B=2: two) and 2x2 (B=2) against the
reference's with no mesh and with its context-parallel ``mesh8``, forward
and gradients; the MoE layer's cut of a split batch against the
reference's device slices (tokens, routes, capacity drops); one train
step of the paper's smoke model (grouped, its exchange bound dropping
rows) at 2x2 and 1x4 against the reference trainer at the same mesh; the
MoE knobs resolved from ``batch·seq / world`` tokens a rank; and the
batches that do not cut, refused with ``ValueError``.  Tolerances are
stated at each assertion."""
import dataclasses
import functools
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro import configs as jconfigs
from repro.core import capacity as jcapacity
from repro.core import config as jconfig
from repro.core import gating as jgating
from repro.core import layout as jlayout
from repro.core import tuning as jtuning
from repro.launch import train as jtrain
from repro.models import attention as jattn
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import cut_batch
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import train as ptrain
from repro_torch.launch.mesh import spawn
from repro_torch.training import train_step as ts
from test_torch_fsdp import RTOL, _close, _flatten_state

# the reference's context-parallel oracle (tests/test_flash_attention.py:
# test_context_parallel_flash_matches_single): GQA 4:2, head dim 16,
# d 64, S 128, q_chunk 32 (S past it: the flash path)
D_MODEL, S_ATTN, Q_CHUNK = 64, 128, 32
HEADS = dict(num_heads=4, num_kv_heads=2, head_dim=16)
# (name, AttentionConfig fields beyond HEADS, causal, window, flash):
# flash False runs both sides under REPRO_FLASH=0 (the chunked baseline,
# each rank chunking its own query rows)
ATTN_CASES = [("causal", {}, True, None, True),
              ("window48-cap50", {"attn_softcap": 50.0}, True, 48, True),
              ("noncausal", {}, False, None, True),
              ("window48-cap50-chunked", {"attn_softcap": 50.0}, True, 48,
               False)]
# (key, mesh shape, batch rows): four ranks a row, two ranks a row
ATTN_MESHES = [("1x4-B1", (1, 4), 1), ("1x4-B2", (1, 4), 2),
               ("2x2-B2", (2, 2), 2)]
# the MoE cut: top-2 of 8 experts, sort at capacity 0.5: 64 tokens a rank,
# 128 routes over 8 experts of capacity 8 (drops)
CUT_D, CUT_E = 16, 8
CUT_MOE = dict(num_experts=CUT_E, top_k=2, gate="topk", capacity_factor=0.5,
               d_ff_expert=24, dispatch="sort", use_pallas_gate=False)
CUT_MESHES = [("2x2-B2", (2, 2), 2, 128), ("1x4-B1", (1, 4), 1, 256)]
# the paper's smoke model, grouped, the exchange bound at half the
# dropless one: rows past it drop, by each rank's own tokens
ARCH = "hetumoe-paper-16e"
PAPER_MOE = {"dispatch": "grouped", "grouped_ep_bound_factor": 0.5}
TRAIN_CELLS = [("paper-2x2-B2", (2, 2), 2, 32),
               ("paper-1x4-B1", (1, 4), 1, 32)]
TRAIN_STEPS = 2          # the first step's lr is 0 (one warm-up step)
# tokens a rank: 2x2 at batch 2 x 64 against batch 4 x 32 (128 tokens a
# rank both), the α–β tuner resolving the "auto" knobs
BANNERS = [("2x2-B2-S64", dict(batch=2, seq=64)),
           ("2x2-B4-S32", dict(batch=4, seq=32))]
# FSDP's reduce-scatter (``launch/shard._reduce_scatter``) over the model
# groups of 2 and of 4, along dim 1 of (6, 8, 3), in pieces of one row of
# the n blocks (16 bytes) and whole
RS_SHAPES, RS_DIM, RS_PIECES = [(2, 2), (1, 4)], 1, (16, None)


def _rs_inputs():
    """Each of four ranks' (6, 8, 3) f32 values, exact in bf16."""
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (4, 6, 8, 3)).astype(np.float32))
    return x.to(torch.bfloat16).float().numpy()


def _attn_inputs():
    rng = np.random.default_rng(7)
    d, q, kv = D_MODEL, 4 * 16, 2 * 16

    def w(*shape):
        return (rng.standard_normal(shape) * shape[0] ** -0.5).astype(
            np.float32)
    return {"params": {"wq": w(d, q), "wk": w(d, kv), "wv": w(d, kv),
                       "wo": w(q, d)},
            "x": rng.standard_normal((2, S_ATTN, d)).astype(np.float32),
            "gy": rng.standard_normal((2, S_ATTN, d)).astype(np.float32)}


def _cut_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((2, 256, CUT_D)).astype(np.float32),
            rng.standard_normal((CUT_D, CUT_E)).astype(np.float32))


_SMOKE = jconfigs.smoke_config


def _paper_f32(arch):
    cfg = _SMOKE(arch)
    return cfg.replace(dtype="float32", moe=dataclasses.replace(cfg.moe,
                                                                **PAPER_MOE))


@pytest.fixture(scope="module")
def init_params():
    return jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                  _paper_f32(ARCH)))


@pytest.fixture(scope="module")
def ranks(init_params, tmp_path_factory):
    """One spawn of four ranks for every cell of this file."""
    path = tmp_path_factory.mktemp("cp") / "init.pkl"
    path.write_bytes(pickle.dumps(init_params))
    attn = _attn_inputs()
    x, gate_w = _cut_inputs()
    cases = [(n, dict(HEADS, **f), c, w, fl) for n, f, c, w, fl in ATTN_CASES]
    jobs = [(("attn", key), "cp_attention", (shape, B, attn, cases, Q_CHUNK))
            for key, shape, B in ATTN_MESHES]
    jobs += [(("cut", key), "cp_moe_cut", (shape, x[:B, :S], gate_w,
                                           CUT_MOE))
             for key, shape, B, S in CUT_MESHES]
    jobs += [(("train", key), "cp_train",
              (shape, ARCH, str(path), dict(steps=TRAIN_STEPS, batch=B, seq=S,
                                            tune="off", dispatch="grouped",
                                            moe=PAPER_MOE)))
             for key, shape, B, S in TRAIN_CELLS]
    jobs += [(("banner", key), "cp_banner",
              ((2, 2), ARCH, dict(steps=1, dispatch="grouped", **kw)))
             for key, kw in BANNERS]
    jobs += [(("rs", shape), "cp_reduce_scatter",
              (shape, _rs_inputs(), RS_DIM, RS_PIECES)) for shape in RS_SHAPES]
    return spawn(torch_ranks.jobs_rank, 4, backend="gloo", threads=1,
                 args=(jobs,))


# ---------------------------------------------------------------------------
# the token blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,B,S", [((2, 2), 8, 16), ((1, 4), 4, 16),
                                       ((2, 2), 2, 16), ((4, 1), 1, 16),
                                       ((2, 4), 2, 24), ((1, 2), 1, 6)])
def test_token_blocks_are_the_flattened_blocks(shape, B, S):
    """Rank r's block of a (B, S) batch is the r-th of ``world``
    contiguous blocks of its flattened tokens — ``TokenBlock.flat``, the
    slice the train step cuts each gate draw by — whole rows when the
    rows divide over the ranks, else a chunk of S/n positions of one row
    (n = world / B), its positions the chunk's own."""
    world = shape[0] * shape[1]
    tok = np.arange(B * S).reshape(B, S)
    batch = {"inputs": tok, "emb": np.stack([tok, -tok], axis=-1)}
    T = B * S // world
    for r in range(world):
        blk = pmesh.cut_tokens(shape, r, B, S)
        got = cut_batch(batch, blk)
        want = np.arange(r * T, (r + 1) * T)
        assert blk.flat == slice(r * T, (r + 1) * T)
        np.testing.assert_array_equal(got["inputs"].reshape(-1), want)
        np.testing.assert_array_equal(got["emb"][..., 0].reshape(-1), want)
        assert blk.n == (1 if B % world == 0 else world // B)
        np.testing.assert_array_equal(blk.positions().numpy(),
                                      np.arange(S)[blk.seq])


@pytest.mark.parametrize("key,shape,B", ATTN_MESHES,
                         ids=[m[0] for m in ATTN_MESHES])
def test_mesh_makes_only_the_row_groups_asked(ranks, key, shape, B):
    """``make_mesh(rows=(n,))`` makes the row groups of n consecutive
    ranks and no other size: at 1x4 with one row the world, with two
    ``{0, 1}`` and ``{2, 3}`` (the inner groups), at 2x2 with two the
    model groups; ``token_block`` on a mesh without the row groups of its
    split raises ``ValueError`` naming B, S and the mesh."""
    n = 4 // B
    for r, res in enumerate(ranks):
        start = r // n * n
        assert res["attn", key]["row_groups"] == {
            n: list(range(start, start + n))}
    D, M = shape
    fake = types.SimpleNamespace(shape={"data": D, "model": M}, rank=0,
                                 rows={}, describe=lambda: f"{D}x{M}")
    with pytest.raises(ValueError,
                       match=rf"batch {B} x seq {S_ATTN} .* mesh {D}x{M}"):
        pmesh.token_block(fake, B, S_ATTN)


@pytest.mark.parametrize("key,shape,B,S,mbs", [
    ("B3-1x4", (1, 4), 3, 16, 1),        # neither divides
    ("S781-n2", (1, 4), 2, 781, 1),       # two ranks a row, an odd row
    ("microbatches", (2, 2), 6, 16, 2)])  # 3 rows a microbatch over 4
def test_batches_that_do_not_cut_raise(key, shape, B, S, mbs):
    """A batch that does not cut into the mesh's token blocks raises
    ``ValueError`` naming B, S and the mesh: ``launch.train.run`` before
    it builds the mesh, the train step (per microbatch) before any work
    — never a whole row on every rank."""
    D, M = shape
    rows = B // mbs
    match = rf"batch {rows} x seq {S} .* mesh {D}x{M}"
    if mbs == 1:
        with pytest.raises(ValueError, match=match):
            ptrain.run(ARCH, steps=1, batch=B, seq=S, smoke=True,
                       mesh_shape=shape, device="cpu")
    cfg = configs.smoke_config(ARCH)
    fake = types.SimpleNamespace(shape={"data": D, "model": M},
                                 world=D * M, rank=0,
                                 describe=lambda: f"{D}x{M}")
    step = ts.make_train_step(cfg, TrainConfig(microbatches=mbs),
                              mesh=fake)
    batch = {k: torch.zeros((B, S), dtype=torch.int32)
             for k in ("inputs", "targets")}
    with pytest.raises(ValueError, match=match):
        step(None, batch)


# ---------------------------------------------------------------------------
# attention across the ranks that share a row
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_attention(B, name, cp):
    """The reference's full_attention (y) and jax.grad of sum(y·gy) in x
    and the four projections, jitted; ``cp``: on the conftest's ``mesh8``
    (2x4), its context-parallel flash path (its chunked path under
    ``REPRO_FLASH=0``)."""
    from repro.launch.mesh import make_smoke_mesh
    _, fields, causal, window, flash = next(c for c in ATTN_CASES
                                            if c[0] == name)
    mesh = make_smoke_mesh((2, 4)) if cp else None
    inp = _attn_inputs()
    cfg = jconfig.AttentionConfig(**HEADS, **fields)
    p = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    x = jnp.asarray(inp["x"][:B])
    gy = jnp.asarray(inp["gy"][:B])

    def f(p, x):
        y, _ = jattn.full_attention(p, x, cfg, positions=jnp.arange(S_ATTN),
                                    causal=causal, window=window,
                                    q_chunk=Q_CHUNK, mesh=mesh)
        return jnp.sum(y * gy), y
    with torch_ranks.env("REPRO_FLASH", "1" if flash else "0"):
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
    return (np.asarray(y), np.asarray(gx),
            {k: np.asarray(v) for k, v in gp.items()})


def _assemble(parts, B, what):
    out = np.zeros((B, S_ATTN, D_MODEL), np.float32)
    for r in parts:
        r0, r1, s0, s1, _ = r["block"]
        out[r0:r1, s0:s1] = r[what]
    return out


@pytest.mark.parametrize("case", ATTN_CASES, ids=[c[0] for c in ATTN_CASES])
@pytest.mark.parametrize("key,shape,B", ATTN_MESHES,
                         ids=[m[0] for m in ATTN_MESHES])
def test_context_parallel_attention_matches_reference(ranks, key, shape, B,
                                                      case):
    """Each rank attends its chunk of a row against the row's keys
    gathered over its row group (one gather a forward; the flash path,
    or the chunked one under ``REPRO_FLASH=0``): the chunks put
    together equal the reference's ``full_attention`` with no mesh, and,
    at two rows, with its context-parallel ``mesh8`` (2x4), within the
    reference's own oracle tolerance (rtol 1e-4, atol 1e-5); dx and the
    four projections' gradients (summed over the ranks) within 1e-4 of
    each one's max against ``jax.grad`` of the reference."""
    parts = [r["attn", key] for r in ranks]
    name = case[0]
    res = [p[name] for p in parts]
    assert all(p["block"][4] == 4 // B for p in parts)
    assert all(r["gathers"] == 1 for r in res)
    y = _assemble([dict(r, block=p["block"]) for r, p in zip(res, parts)],
                  B, "y")
    dx = _assemble([dict(r, block=p["block"]) for r, p in zip(res, parts)],
                   B, "dx")
    refs = [_ref_attention(B, name, False)]
    if B == 2:
        refs.append(_ref_attention(B, name, True))
    for jy, jgx, jgp in refs:
        np.testing.assert_allclose(y, jy, rtol=1e-4, atol=1e-5)
        for got, want, what in [(dx, jgx, "x")] + [
                (sum(r["grads"][k] for r in res), jgp[k], k)
                for k in sorted(jgp)]:
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-4, (what, err)


# ---------------------------------------------------------------------------
# the MoE layer's cut
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,shape,B,S", CUT_MESHES,
                         ids=[m[0] for m in CUT_MESHES])
def test_moe_cut_is_the_reference_device_slice(ranks, key, shape, B, S):
    """Rank r's tokens of a split batch are the reference MoE layer's
    device-r slice of the flattened tokens (and ``moe.rank_tokens``'
    block), bitwise; its routes and its sort plan's slots at capacity
    0.5 — tokens dropped among them — equal the reference's gate and
    ``plan_sort`` on that slice."""
    x, gate_w = _cut_inputs()
    x = x[:B, :S]
    flat = x.reshape(-1, CUT_D)
    T = flat.shape[0] // 4
    cfg = jconfig.MoEConfig(**CUT_MOE)
    dropped = 0
    for r, res in enumerate(ranks):
        got = res["cut", key]
        want = flat[r * T:(r + 1) * T]
        np.testing.assert_array_equal(got["tokens"], want)
        assert got["is_rank_tokens"] and got["flat"] == (r * T, (r + 1) * T)
        gate = jgating.route(cfg, jgating.router_logits(
            cfg, jnp.asarray(want), jnp.asarray(gate_w)))
        plan = jlayout.plan_sort(gate, CUT_E, jcapacity.expert_capacity(
            cfg, T, CUT_E), drop_bucket=True)
        np.testing.assert_array_equal(got["expert_index"],
                                      np.asarray(gate.expert_index))
        np.testing.assert_array_equal(got["slot"], np.asarray(plan.slot))
        dropped += int((got["slot"] < 0).sum())
    assert dropped > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("key,shape,B,S", TRAIN_CELLS,
                         ids=[c[0] for c in TRAIN_CELLS])
def test_paper_train_step_with_split_rows_matches_reference(
        ranks, monkeypatch, key, shape, B, S):
    """Two AdamW steps of the paper's f32 smoke model (the first at lr 0,
    a warm-up step), grouped with its exchange bound dropping rows, at
    2x2 with 2 rows and at 1x4 with one (every row split over 2 or 4
    ranks): loss, ce, aux, grad norm and lr of each step on every rank
    within rtol 2e-5 of the reference trainer at the same mesh (its MoE
    layer cuts the same tokens, so the same rows drop);
    every leaf of params, moments and counters within 2e-5 of its max,
    but the elements of the expert weights whose AdamW denominator is
    near eps (``_near_eps_close``)."""
    monkeypatch.setattr(jconfigs, "smoke_config", _paper_f32)
    prev = jtuning.set_tuning()
    try:
        st, hist = jtrain.run(ARCH, steps=TRAIN_STEPS, batch=B, seq=S,
                              smoke=True, mesh_shape=shape, log_every=1000,
                              tune="off")
    finally:
        jtuning.set_tuning(*prev)       # tune="off" is the process's mode
    flat = {k: np.asarray(v) for k, v in _flatten_state(st).items()}
    for r in ranks:
        got = r["train", key]["history"]
        assert len(got) == TRAIN_STEPS
        for s, (t, j) in enumerate(zip(got, hist, strict=True)):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(t[k], j[k], rtol=2e-5, atol=1e-9,
                                           err_msg=f"step {s} {k}")
            assert t["skipped"] == 0
        assert r["train", key]["gathers"] == 2       # a layer, a step
    whole = ranks[0]["train", key]["whole"]
    assert set(whole) == set(flat)
    _close(whole, {k: w for k, w in flat.items() if not _expert_weight(k)},
           key)
    _near_eps_close(whole, flat, sum(j["lr"] for j in hist), key)


def _expert_weight(key: str) -> bool:
    return key.startswith(".params/") and "/moe/w_" in key


def _near_eps_close(got, want, lrs, what):
    """Every expert weight within 2e-5 of its leaf's max (``RTOL``) but
    the elements whose AdamW denominator sqrt(v̂) — from the reference's
    second moment after the run's steps — is under 10·eps: there the
    gradients are ~1e-9 (experts that the bound starves of rows), the
    step m̂ / (sqrt(v̂) + eps) follows their last bits (their moments
    still agree within 2e-5 of each leaf's max), and such an element is
    held within 2·Σlr, the most two steps can move it."""
    tc = TrainConfig()
    for k in filter(_expert_weight, want):
        w = np.asarray(want[k], np.float64)
        diff = np.abs(np.asarray(got[k], np.float64) - w)
        v = np.asarray(want[".opt/v/" + k[len(".params/"):]], np.float64)
        near = np.sqrt(v / (1 - tc.b2 ** TRAIN_STEPS)) < 10 * tc.eps
        assert diff[~near].max() <= RTOL * np.abs(w).max(), (what, k)
        assert diff[near].max(initial=0.0) <= 2 * lrs, (what, k)


def test_tokens_a_rank_resolve_the_moe_knobs(ranks):
    """``launch.train.run`` resolves the "auto" MoE knobs from batch·seq /
    world tokens a rank: at 2x2, batch 2 x 64 (rows split over two ranks)
    prints the knobs of batch 4 x 32 — the same 128 tokens a rank."""
    a, b = (ranks[0]["banner", key] for key, _ in BANNERS)
    assert a.startswith("dispatch=grouped") and a == b


@pytest.mark.parametrize("shape", RS_SHAPES, ids=["2x2", "1x4"])
def test_fsdp_reduce_scatter_sums_in_group_order(ranks, shape):
    """FSDP's reduce-scatter hands model-group rank j block j of the sum
    of the group's tensors, summed in f32 in group-rank order — bitwise,
    whether the blocks cross as bf16 or as f32 and whether in pieces of
    one row or whole (a gradient the size of a whole table crosses in
    pieces, not in a second whole-size copy)."""
    xs = _rs_inputs()
    M = shape[1]
    for r, res in enumerate(ranks):
        members = range(r // M * M, r // M * M + M)
        want = xs[members[0]].copy()
        for j in members[1:]:
            want += xs[j]                     # f32, in group-rank order
        block = np.split(want, M, axis=RS_DIM)[r % M]
        for key, got in res["rs", shape].items():
            np.testing.assert_array_equal(got, block, err_msg=str(key))

