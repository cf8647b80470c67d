"""The windowed presets against the JAX package: ``h2o-danube-3-4b``
(every layer a 4096-wide sliding window) and ``gemma2-9b`` (``local`` /
``global`` alternation, attention softcap 50, final softcap 30, GeGLU,
tied embeddings scaled by sqrt(d)) at smoke size (window and
``local_window`` 32, head dim 32), held to the reference's ``init_model``
weights through ``convert.params_from_numpy``.  Prefill logits past the
window (prompt 48 on ``_attend``, prompt 600 on the flash path), greedy
tokens and decode-step logits through ring caches (a prefill longer than
the ring, and a ring that wraps during decode), gemma2's long-context
variant, ring caches against linear ones under the same window, a train
step on ``_attend`` (2 x 32) and one on the flash path at the presets' own
head dims (120, 256; seq 600, the window acting), ``convert`` over
``("local", "global")``, ``is_subquadratic`` and the serving and training
CLIs.
The reference runs on ``mesh1`` with its Pallas kernels in interpret mode;
every tolerance is stated at its assertion."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import io as jio
from repro.core import config as jconfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro.training import train_step as jts
from repro_torch import configs
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 state_from_numpy, state_to_numpy)
from repro_torch.core.config import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as F
from repro_torch.models import attention as tattn
from repro_torch.launch import serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as T
from repro_torch.serving import engine
from repro_torch.training import train_step as ts
from test_torch_presets import (RNG, cfgs, check_train_step, jax_logits,
                                jax_params, port_logits, port_model, prompt)

ARCHS = ("h2o-danube-3-4b", "gemma2-9b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs (smoke widths; the
    parallel test workers would otherwise contend for the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_presets_copy_the_reference(arch):
    """get_config and smoke_config equal the reference's field by field;
    the smoke versions keep the window (32), the local window (32) and
    gemma2's pattern, caps, GeGLU and tied, scaled embeddings."""
    for get in ("get_config", "smoke_config"):
        t, j = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
        assert t.moe is None and j.moe is None
        assert dataclasses.asdict(t.attention) == dataclasses.asdict(
            j.attention)
        for f in dataclasses.fields(t):
            if f.name not in ("moe", "attention"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.head_dim == j.head_dim
    full, smoke = configs.get_config(arch), configs.smoke_config(arch)
    if arch == "gemma2-9b":
        assert full.head_dim == 256 and full.local_window == 4096
        assert smoke.block_pattern == ("local", "global")
        assert (smoke.local_window, smoke.attention.attn_softcap,
                smoke.final_softcap) == (32, 50.0, 30.0)
        assert smoke.tie_embeddings and smoke.scale_embeddings
    else:
        assert full.head_dim == 120 and full.attention.window == 4096
        assert smoke.attention.window == 32


def test_is_subquadratic_matches_the_reference():
    """The port's ``is_subquadratic`` is the reference's for every preset
    it registers (danube: every layer windowed; gemma2's global layers
    are not; the recurrent rwkv6 and zamba2, whose shared attention
    decodes windowed, are; internvl2 is not)."""
    for arch in configs.ARCHS:
        assert (configs.get_config(arch).is_subquadratic
                == jconfigs.get_config(arch).is_subquadratic), arch
    assert configs.get_config("h2o-danube-3-4b").is_subquadratic
    assert not configs.get_config("gemma2-9b").is_subquadratic
    for arch in ("rwkv6-1.6b", "zamba2-7b"):
        assert configs.get_config(arch).is_subquadratic, arch
    assert not configs.get_config("internvl2-2b").is_subquadratic


# ---------------------------------------------------------------------------
# prefill, decode, generate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_past_the_window(mesh1, arch):
    """f32 logits at every position of a (2, 48) prompt — 16 positions
    past the 32-wide window, on ``_attend`` — atol 1e-4 (f32 sums in other
    orders through two blocks and the head; gemma2's final cap keeps the
    logits within 30)."""
    jc, tc = cfgs(arch)
    toks = prompt(S=48)
    np.testing.assert_allclose(port_logits(port_model(arch, tc), toks),
                               jax_logits(arch, jc, toks, mesh1), atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_on_the_flash_path(mesh1, arch, monkeypatch):
    """A (1, 600) prompt takes the flash forward (past q_chunk = 512) with
    the 32-wide window biting on every row past 32: f32 logits at every
    position within atol 1e-4 of the reference's Pallas flash path
    (interpret mode); the forward runs once per layer, with its layer's
    window."""
    calls = []
    fwd = F.flash_fwd
    monkeypatch.setattr(F, "flash_fwd",
                        lambda *a: calls.append(a[7]) or fwd(*a))
    jc, tc = cfgs(arch)
    toks = prompt(B=1, S=600)
    t = port_logits(port_model(arch, tc), toks)
    j = jax_logits(arch, jc, toks, mesh1)
    np.testing.assert_allclose(t, j, atol=1e-4)
    # the window each layer's flash forward was given
    want = [T.block_window(k, tc) for k in T.layer_kinds(tc)]
    assert calls == want and 32 in calls


def _decode_both(arch, S, steps, mesh, long_context=False, B=2):
    """Last-token logits of the reference's compiled prefill and decode
    steps and of the port's, greedy, over a cache of S + steps: (port,
    reference) lists of (B, V) arrays, and the port's caches."""
    jc, tc = cfgs(arch)
    toks = prompt(B=B, S=S)
    L = S + steps
    jp = jax.tree.map(jnp.asarray, jax_params(arch))
    jl, jcache = jengine.build_prefill(jc, mesh, cache_len=L,
                                       long_context=long_context)(
        jp, jnp.asarray(toks))
    step = jengine.build_decode(jc, mesh, batch=B, long_context=long_context)
    model = port_model(arch, tc)
    js, ts_ = [np.asarray(jl[:, -1])], []
    with torch.inference_mode():
        caches = model.init_caches(B, L, long_context=long_context)
        h, _, caches = model.forward(torch.from_numpy(toks).long(),
                                     caches=caches, long_context=long_context)
        tl = model.logits_from_hidden(h[:, -1:])
        ts_.append(tl[:, -1].numpy())
        for _ in range(steps):
            tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
            jl, jcache = step(jp, jnp.asarray(tok), jcache)
            tl, caches = model.decode_step(torch.from_numpy(tok).long(),
                                           caches, long_context=long_context)
            js.append(np.asarray(jl[:, -1]))
            ts_.append(tl[:, -1].numpy())
    return ts_, js, caches


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S,steps", [(48, 4), (20, 16)],
                         ids=["prefill past the ring", "ring wraps in decode"])
def test_decode_steps_through_ring_caches(mesh1, arch, S, steps):
    """The reference's compiled prefill + decode steps against the port's
    over a cache of S + steps > 32 (the windowed layers' caches are rings
    of 32): a 48-token prefill fills the ring from its last 32 positions
    (slot p % 32), a 20-token one wraps at decode step 12.  Last-token
    f32 logits within atol 1e-4 at every step; gemma2's global layers
    keep linear caches of S + steps."""
    t, j, caches = _decode_both(arch, S, steps, mesh1)
    for i, (a, b) in enumerate(zip(t, j, strict=True)):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"step {i}")
    _, tc = cfgs(arch)
    lens = [c["k"].shape[1] for c in caches]
    assert lens == [S + steps if T.block_window(k, tc) is None else 32
                    for k in T.layer_kinds(tc)]
    assert all(c["pos"] == S + steps for c in caches)


def test_gemma2_long_context_caps_the_global_layers(mesh1):
    """``long_context=True``: gemma2's global layers take the 32-wide
    local window and ring caches too, as the reference's variant does;
    prefill + 16 decode steps past the window, logits within atol 1e-4 at
    every step, and they differ from the full-context run's."""
    t, j, caches = _decode_both("gemma2-9b", 20, 16, mesh1,
                                long_context=True)
    for i, (a, b) in enumerate(zip(t, j, strict=True)):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"step {i}")
    assert [c["k"].shape[1] for c in caches] == [32, 32]
    full, _, _ = _decode_both("gemma2-9b", 20, 16, mesh1)
    assert np.abs(full[-1] - t[-1]).max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_through_ring_caches(mesh1, arch):
    """Greedy token ids equal to the reference's ``generate`` over 20
    steps from a (2, 24) prompt (the rings wrap at step 8), f32; and with
    ``long_context`` for gemma2."""
    jc, tc = cfgs(arch)
    toks = prompt(S=24)
    jp = jax.tree.map(jnp.asarray, jax_params(arch))
    model = port_model(arch, tc)
    for lc in ((False, True) if arch == "gemma2-9b" else (False,)):
        j = np.asarray(jengine.generate(jp, jc, jnp.asarray(toks), steps=20,
                                        mesh=mesh1, long_context=lc))
        t = engine.generate(model, torch.from_numpy(toks).long(), steps=20,
                            long_context=lc).numpy()
        np.testing.assert_array_equal(t, j, err_msg=f"long_context={lc}")


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_caches_equal_linear_caches_under_the_window(arch):
    """In the port alone: decode over ring caches of 32 against linear
    caches of the full length under the same window, from a 40-token
    prefill over 12 steps (both past the window): the same greedy tokens,
    and logits within atol 1e-5 (the same terms, summed in another slot
    order)."""
    _, tc = cfgs(arch)
    model = port_model(arch, tc)
    toks = torch.from_numpy(prompt(S=40)).long()
    L = 52
    runs = []
    for linear in (False, True):
        with torch.inference_mode():
            caches = model.init_caches(2, L)
            if linear:
                caches = [tattn.init_cache(tc.attention, 2, L, tc.d_model,
                                           torch.float32, "cpu")
                          for _ in caches]
            h, _, caches = model.forward(toks, caches=caches)
            logits = model.logits_from_hidden(h[:, -1:])
            out = [logits[:, -1]]
            for _ in range(12):
                tok = logits[:, -1].argmax(-1, keepdim=True)
                logits, caches = model.decode_step(tok, caches)
                out.append(logits[:, -1])
        runs.append((torch.stack(out), caches))
    (ring, rc), (lin, lc) = runs
    assert any(c["k"].shape[1] == 32 for c in rc)
    assert all(c["k"].shape[1] == L for c in lc)
    torch.testing.assert_close(ring, lin, rtol=0, atol=1e-5)
    assert torch.equal(ring.argmax(-1), lin.argmax(-1))


def test_ring_fill_and_decode_slots():
    """fill_cache(ring=True) after S >= W tokens keeps the last W
    positions, position p at slot p % W; decode_attention(ring=True)
    writes slot pos % W and reads each slot's position back as pos -
    ((pos - s) mod W), -1 before the prompt's start (the reference's
    arithmetic).  Without ring, a full cache still raises."""
    cfg = configs.smoke_config("h2o-danube-3-4b").attention
    W, S = 8, 13
    kv = {n: torch.arange(S, dtype=torch.float32)[None, :, None, None]
          .expand(1, S, cfg.num_kv_heads, 32).clone() for n in ("k", "v")}
    cache = tattn.init_cache(cfg, 1, W, 128, torch.float32)
    tattn.fill_cache(cache, kv, ring=True)
    assert cache["pos"] == S
    got = cache["k"][0, :, 0, 0].tolist()
    assert got == [float(p) for s in range(W)
                   for p in range(S - W, S) if p % W == s]
    linear = tattn.init_cache(cfg, 1, W, 128, torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        tattn.fill_cache(linear, kv)


# ---------------------------------------------------------------------------
# training, convert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_train_step_matches_reference(mesh1, arch):
    """One f32 batch (2 x 32, on ``_attend``, below q_chunk): the
    loss, the gradients and one AdamW step against the reference, with
    ``test_torch_presets.check_train_step``'s tolerances (loss rtol 2e-6,
    each gradient leaf within 1e-5 of its max, metrics rtol 2e-6,
    parameters atol 1e-5 but for 1e-4 of them within 2·lr)."""
    check_train_step(arch, None, mesh1)


# the presets' own head dims, at smoke width otherwise
HEAD_DIMS = {"h2o-danube-3-4b": 120, "gemma2-9b": 256}


@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_train_step_on_the_flash_path(mesh1, arch, monkeypatch):
    """One f32 batch of 1 x 600 (past q_chunk = 512: the flash forward and
    its dq and dk/dv backward, the 32-wide window acting on every row past
    32) at the preset's own head dim (danube 120, gemma2 256) and smoke
    width otherwise, from the reference's ``init_model`` weights: the loss
    within rtol 2e-6 and every gradient leaf within 1e-5 of its max |grad|
    against ``jax.value_and_grad`` of the reference's forward + chunked CE
    on its Pallas flash kernels (interpret mode) — ``check_train_step``'s
    tolerances; and the step's flash launches: the forward, dq and dk/dv
    once per layer, each layer given its own window."""
    calls = {n: [] for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    for n in calls:
        fn = getattr(F, n)
        monkeypatch.setattr(F, n, lambda *a, n=n, fn=fn: (
            calls[n].append(a[-2]) or fn(*a)))          # the window
    jc, tc = cfgs(arch)
    d = HEAD_DIMS[arch]
    jc = jc.replace(attention=dataclasses.replace(jc.attention, head_dim=d))
    tc = tc.replace(attention=dataclasses.replace(tc.attention, head_dim=d))
    p0 = jax.tree.map(np.asarray, JT.init_model(RNG, jc))
    jb = JSyntheticLM(jc, 1, 600).next_batch(0)
    tb = SyntheticLM(tc, 1, 600, device="cpu").next_batch(0)

    def jloss(p, b):
        h, aux, _ = JT.forward(p, b["inputs"], jc, mesh=mesh1)
        return jts.chunked_ce_loss(p, jc, h, b["targets"], b["loss_mask"],
                                   mesh1) + aux
    jv, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, p0), jb)
    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=1)
    state = ts.init_train_state(tc, TrainConfig(**kw),
                                params=params_from_numpy(p0, tc),
                                device="cpu")
    loss, _, _, grads = ts.loss_and_grads(state.params, tb, tc)
    np.testing.assert_allclose(float(loss), float(jv), rtol=2e-6)
    for (path, j), t in zip(
            jax.tree_util.tree_flatten_with_path(jg)[0],
            jax.tree.leaves(params_to_numpy(grads, tc)), strict=True):
        j = np.asarray(j)
        err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)
    windows = [T.block_window(k, tc) for k in T.layer_kinds(tc)]
    assert {n: len(c) for n, c in calls.items()} == dict.fromkeys(
        calls, tc.num_layers)
    assert calls["flash_fwd"] == windows and 32 in windows
    # the backward walks the layers last to first
    assert calls["flash_dq"] == calls["flash_dkv"] == windows[::-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_a_windowed_preset(capsys, arch):
    """The training CLI on a windowed preset's smoke config, 2 steps of
    batch 2 x 40 (past the window of 32, on ``_attend``): a finite loss
    and no skipped step at each logged step, and no dispatch printed."""
    tlaunch.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                  "2", "--seq", "40", "--log-every", "1", "--device",
                  "cpu"])
    out = capsys.readouterr().out
    steps = re.findall(r"step +(\d+) loss (\S+) .* skip (\d+)", out)
    assert [s for s, _, _ in steps] == ["0", "1"], out
    assert all(np.isfinite(float(x)) and k == "0" for _, x, k in steps)
    assert "dispatch=" not in out


def test_local_global_params_round_trip(mesh1):
    """gemma2's ("local", "global") blocks share attn's leaves: the
    reference's tree through params_from_numpy and params_to_numpy comes
    back bitwise, layer 0 local and layer 1 global each with an MLP of
    2·d_ff GeGLU columns; a reference TrainState's checkpoint keys cross
    into the port and back bitwise."""
    jc, tc = cfgs("gemma2-9b")
    p0 = jax_params("gemma2-9b")
    port = params_from_numpy(p0, tc)
    assert T.layer_kinds(tc) == ["local", "global"]
    for blk in port["blocks"]:
        assert set(blk) == {"ln1", "attn", "ln2", "mlp"}
        assert tuple(blk["mlp"]["w_in"].shape) == (tc.d_model, 2 * tc.d_ff)
    assert "lm_head" not in port
    back = params_to_numpy(port, tc)
    flat_j = jax.tree_util.tree_flatten_with_path(p0)
    flat_t = jax.tree_util.tree_flatten_with_path(back)
    assert flat_j[1] == flat_t[1]
    for (path, a), (_, b) in zip(flat_j[0], flat_t[0], strict=True):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(
            path))
    jtc = jconfig.TrainConfig(learning_rate=3e-3, warmup_steps=1,
                              total_steps=3)
    jstate = jts.init_train_state(RNG, jc, jtc)
    want = {k: np.asarray(v) for k, v in jio._flatten(jstate).items()}
    got = state_to_numpy(state_from_numpy(want, tc, device="cpu"), tc)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_a_windowed_preset(capsys, arch):
    """The CLI serves a windowed preset's smoke config past its window (a
    40-token prompt and 6 new tokens over rings of 32) and prints no
    dispatch; a token row of 46."""
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "40", "--gen", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dispatch=" not in out and "-> (2, 46)" in out
