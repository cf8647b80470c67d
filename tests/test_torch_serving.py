"""The whole slice against the JAX package: the reference model's
parameters (``init_model``) go through ``convert.params_from_numpy`` into
the port's ``Transformer`` (CPU, plain kernel versions); the reference
runs on ``mesh1`` with its Pallas kernels in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.transformer import Transformer
from repro_torch.serving import engine

ARCH = "hetumoe-paper-16e"
RNG = jax.random.PRNGKey(5)


def _cfgs(dtype="float32", dispatch="grouped"):
    jc = jconfigs.smoke_config(ARCH)
    jc = jc.replace(dtype=dtype, moe=dataclasses.replace(
        jc.moe, use_pallas_gate=True, dispatch=dispatch))
    tc = configs.smoke_config(ARCH)
    tc = tc.replace(dtype=dtype, moe=dataclasses.replace(tc.moe,
                                                         dispatch=dispatch))
    return jc, tc


@pytest.fixture(scope="module")
def jax_params():
    jc, _ = _cfgs()
    return JT.init_model(RNG, jc)


def _port(jax_params, tc):
    tree = jax.tree.map(np.asarray, jax_params)
    return Transformer(tc, device="cpu", params=params_from_numpy(tree, tc))


def _prompt(B=2, S=16, seed=6):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _jax_logits(params, cfg, toks, mesh):
    def f(p, t):
        h, _, _ = JT.forward(p, t, cfg, mesh=mesh)
        return JT.logits_from_hidden(p, cfg, h, mesh)
    return np.asarray(jax.jit(f)(params, jnp.asarray(toks)).astype(
        jnp.float32))


def _port_logits(model, toks):
    with torch.inference_mode():
        h, _, _ = model.forward(torch.from_numpy(toks).long())
        return model.logits_from_hidden(h).float().numpy()


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_prefill_logits_match_reference_f32(jax_params, mesh1, dispatch):
    """f32 logits at every position, atol 1e-4."""
    jc, tc = _cfgs(dispatch=dispatch)
    toks = _prompt()
    np.testing.assert_allclose(_port_logits(_port(jax_params, tc), toks),
                               _jax_logits(jax_params, jc, toks, mesh1),
                               atol=1e-4)


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_prefill_logits_match_reference_bf16(jax_params, mesh1, dispatch):
    """bf16 logits within 0.05 of the reference's, against logits up to
    ~4 (0.03 seen): both sides round every product to bf16, but their f32
    sums add in other orders, so single roundings land one bf16 ulp
    (2^-8 relative) apart and pass through two blocks and the lm head.
    The argmax must agree on at least 90% of positions."""
    jc, tc = _cfgs("bfloat16", dispatch)
    toks = _prompt()
    t = _port_logits(_port(jax_params, tc), toks)
    j = _jax_logits(jax_params, jc, toks, mesh1)
    assert np.abs(t - j).max() <= 0.05
    assert (t.argmax(-1) == j.argmax(-1)).mean() >= 0.9


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_greedy_generate_matches_reference(jax_params, mesh1, dispatch):
    """Greedy token ids equal over 6 steps, f32, prompt (2, 16)."""
    jc, tc = _cfgs(dispatch=dispatch)
    toks = _prompt()
    j = np.asarray(jengine.generate(jax_params, jc, jnp.asarray(toks),
                                    steps=6, mesh=mesh1))
    t = engine.generate(_port(jax_params, tc), torch.from_numpy(toks).long(),
                        steps=6).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_long_prefill_logits_match_reference_f32(jax_params, mesh1,
                                                 dispatch):
    """A 600-token prompt (over q_chunk=512) takes the flash path on both
    sides: the port's kernels' plain versions against the reference's
    Pallas flash kernel in interpret mode.  f32 logits at every position,
    atol 1e-4, as the short prefill."""
    jc, tc = _cfgs(dispatch=dispatch)
    toks = _prompt(B=1, S=600)
    np.testing.assert_allclose(_port_logits(_port(jax_params, tc), toks),
                               _jax_logits(jax_params, jc, toks, mesh1),
                               atol=1e-4)


@pytest.mark.parametrize("dispatch", ["grouped", "sort"])
def test_long_prompt_greedy_generate_matches_reference(jax_params, mesh1,
                                                       dispatch):
    """Greedy token ids equal over 4 steps after a flash-path prefill of
    520 tokens, f32, then decode steps over a cache of 524."""
    jc, tc = _cfgs(dispatch=dispatch)
    toks = _prompt(B=1, S=520)
    j = np.asarray(jengine.generate(jax_params, jc, jnp.asarray(toks),
                                    steps=4, mesh=mesh1))
    t = engine.generate(_port(jax_params, tc), torch.from_numpy(toks).long(),
                        steps=4).numpy()
    np.testing.assert_array_equal(t, j)


def test_decode_step_matches_reference_expert_tp_quirk(jax_params, mesh1):
    """The reference's decode at mesh (1, 1) takes the expert-TP branch at
    degree 1 (an identity there, with two extra row gathers); the port has
    no TP and still gives the same logits after prefill + 3 decode steps,
    f32 atol 1e-4."""
    jc, tc = _cfgs()
    toks = _prompt(S=12)
    prefill = jengine.build_prefill(jc, mesh1, cache_len=16)
    step = jengine.build_decode(jc, mesh1, batch=2)
    jl, jcache = prefill(jax_params, jnp.asarray(toks))
    model = _port(jax_params, tc)
    with torch.inference_mode():
        caches = model.init_caches(2, 16)
        h, _, caches = model.forward(torch.from_numpy(toks).long(),
                                     caches=caches)
        tl = model.logits_from_hidden(h[:, -1:])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
        for i in range(3):
            tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
            jl, jcache = step(jax_params, jnp.asarray(tok), jcache)
            tl, caches = model.decode_step(torch.from_numpy(tok).long(),
                                           caches)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, err_msg=f"step {i}")


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                "8", "--gen", "3", "--dispatch", "sort", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "dispatch=sort (flag)" in out and "-> (2, 11)" in out


def test_serve_cli_repeat_serves_the_same_tokens(capsys):
    """``--repeat`` serves the same prompts again on one model, with the
    same tokens, and prints each run's prefill and decode times."""
    stats = {}
    out = serve.run(ARCH, smoke=True, batch=2, prompt_len=8, gen=3,
                    device="cpu", repeat=2, stats=stats)
    out_text = capsys.readouterr().out
    lines = [ln for ln in out_text.splitlines() if "-> (2, 11)" in ln]
    assert len(lines) == 2 and all("ms/step" in ln for ln in lines)
    assert "median of runs 2-2: prefill" in out_text
    assert stats["decode_steps"] == 2
    torch.testing.assert_close(
        out, serve.run(ARCH, smoke=True, batch=2, prompt_len=8, gen=3,
                       device="cpu"))


@pytest.mark.parametrize("argv", [["--mesh", "0x2"], ["--dispatch", "nope"],
                                  ["--repeat", "0"]])
def test_serve_cli_rejects_unported_flags(argv):
    """Bad flags exit through argparse (a mesh across ranks serves since
    slice 16: tests/test_torch_serve_ranks.py)."""
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", *argv])


def test_generate_validates_like_reference(jax_params, mesh1):
    """The reference's argument checks raise the same errors; a prompt of
    513 tokens, one past q_chunk, is served through the flash path and
    gives the reference's greedy tokens (f32)."""
    jc, tc = _cfgs()
    model = Transformer(tc, device="cpu")
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="valid options"):
        engine.generate(model, prompt, steps=2, dispatch="scatter")
    with pytest.raises(ValueError, match="cache_len"):
        engine.generate(model, prompt, steps=2, cache_len=1)
    toks = _prompt(B=1, S=513)
    j = np.asarray(jengine.generate(jax_params, jc, jnp.asarray(toks),
                                    steps=2, mesh=mesh1))
    t = engine.generate(_port(jax_params, tc), torch.from_numpy(toks).long(),
                        steps=2).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("act", ["relu", "swiglu", "gelu"])
def test_layers_match_reference(act):
    """rms_norm (the 1+scale form), softcap, the MLP, embed and rope in
    f32 at 1e-5."""
    from repro.models import attention as jattn
    from repro.models import layers as jl
    from repro_torch.models import attention as tattn
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(41)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    cols = 48 if act == "swiglu" else 24
    mlp = {"w_in": rng.standard_normal((16, cols)).astype(np.float32),
           "w_out": rng.standard_normal((24, 16)).astype(np.float32)}
    table = rng.standard_normal((10, 16)).astype(np.float32)
    ids = np.array([[1, 9, 0]], np.int32)
    pos = np.arange(5, dtype=np.int32)
    T = torch.from_numpy
    pairs = [
        (jl.rms_norm(jnp.asarray(x), jnp.asarray(scale)),
         tl.rms_norm(T(x), T(scale))),
        (jl.softcap(jnp.asarray(x), 2.0), tl.softcap(T(x), 2.0)),
        (jl.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                      jnp.asarray(x), act),
         tl.apply_mlp({k: T(v) for k, v in mlp.items()}, T(x), act)),
        (jl.embed(jnp.asarray(table), jnp.asarray(ids), jnp.float32, True),
         tl.embed(T(table), T(ids), torch.float32, True)),
        (jattn.rope(jnp.asarray(x).reshape(2, 5, 2, 8), jnp.asarray(pos),
                    1e4),
         tattn.rope(T(x).reshape(2, 5, 2, 8), T(pos), 1e4)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the step-builder cache (one step per key; on the CPU a build counts)
# ---------------------------------------------------------------------------

def test_same_key_same_step_and_distinct_batches_distinct_steps(jax_params):
    _, tc = _cfgs()
    model = _port(jax_params, tc)
    engine.clear_step_cache()
    s1 = engine.build_decode(model, batch=2, cache_len=12)
    s2 = engine.build_decode(model, batch=2, cache_len=12)
    s3 = engine.build_decode(model, batch=4, cache_len=12)
    assert s1 is s2 and s1 is not s3
    assert s1.graph is None and s1.capacity == 12        # eager on the CPU
    assert engine.build_decode(model, batch=2, cache_len=16) is not s1
    p1 = engine.build_prefill(model, cache_len=12, batch=2)
    assert p1 is engine.build_prefill(model, cache_len=12, batch=2)
    assert engine.trace_budget_report() == {}
    engine.clear_step_cache(model)
    assert not engine.trace_counts


def test_generate_reuses_its_steps(jax_params, mesh1):
    """The first ``generate`` builds its prefill and decode steps once
    each; a second identical call builds nothing, gives the same tokens
    (the reference's greedy tokens), and ``trace_budget_report`` reports
    a key only past its budget."""
    jc, tc = _cfgs()
    model = _port(jax_params, tc)
    toks = _prompt(S=8)
    engine.clear_step_cache()
    a = engine.generate(model, torch.from_numpy(toks).long(), steps=5)
    first = dict(engine.trace_counts)
    assert sorted(k[0] for k in first) == ["decode", "prefill"]
    assert all(v == 1 for v in first.values()), first
    b = engine.generate(model, torch.from_numpy(toks).long(), steps=5)
    assert dict(engine.trace_counts) == first
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    j = np.asarray(jengine.generate(jax_params, jc, jnp.asarray(toks),
                                    steps=5, mesh=mesh1))
    np.testing.assert_array_equal(a.numpy(), j)
    assert engine.trace_budget_report() == {}
    over = dict(first)
    over[next(iter(over))] = 3
    assert list(engine.trace_budget_report(counts=over).values()) == [3]
    assert engine.trace_budget_report(budget=3, counts=over) == {}


def test_two_models_of_one_config_generate_their_own_tokens(jax_params):
    """The model is in the key: two models of one config with other
    weights each decode through their own step (a captured graph binds
    its model's weights), each giving the tokens it gives alone."""
    _, tc = _cfgs()
    a = _port(jax_params, tc)
    b = Transformer(tc, device="cpu", seed=3)
    toks = torch.from_numpy(_prompt(S=8)).long()
    engine.clear_step_cache()
    ta = engine.generate(a, toks, steps=5)
    alone_b = engine.generate(b, toks, steps=5)
    engine.clear_step_cache()
    tb = engine.generate(b, toks, steps=5)
    assert not torch.equal(ta, tb)
    torch.testing.assert_close(tb, alone_b, rtol=0, atol=0)
    torch.testing.assert_close(engine.generate(a, toks, steps=5), ta,
                               rtol=0, atol=0)
    assert len([k for k in engine.trace_counts if k[0] == "decode"]) == 2


def test_generate_refuses_a_full_linear_cache(jax_params):
    """The full-cache check lives in the caller's host mirror of the
    position: decode step i writes position S + i."""
    _, tc = _cfgs()
    model = _port(jax_params, tc)
    toks = torch.from_numpy(_prompt(S=8)).long()
    engine.generate(model, toks, steps=3, cache_len=10)      # positions 8, 9
    with pytest.raises(ValueError, match="cache of 10 positions is full"):
        engine.generate(model, toks, steps=4, cache_len=10)


def test_decode_step_takes_its_gate_noise_as_an_input():
    """A noisy gate's decode draws (``decode_noise``, seed 0, the same at
    every step) passed in give the step's own draws' logits bitwise; the
    cache position is a 0-d int32 tensor advanced in place."""
    from repro_torch.models import transformer as T
    _, tc = _cfgs()
    tc = tc.replace(moe=dataclasses.replace(tc.moe, gate="gshard", top_k=2))
    model = Transformer(tc, device="cpu", seed=1)
    toks = torch.from_numpy(_prompt(S=8)).long()
    outs = []
    with torch.inference_mode():
        for noise in (None, T.decode_noise(tc, 2, model.device)):
            caches = model.init_caches(2, 12)
            pos = [c["pos"] for c in caches]
            model.forward(toks, caches=caches)
            lg, caches = model.decode_step(toks[:, -1:], caches, noise=noise)
            outs.append(lg)
            assert all(c["pos"] is p and p.dtype == torch.int32
                       and p.dim() == 0 and int(p) == 9
                       for c, p in zip(caches, pos))
    assert T.decode_noise(tc.replace(moe=dataclasses.replace(
        tc.moe, gate="topk")), 2, model.device) is None
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_raw_step_factories_match_reference(jax_params, mesh1):
    """The eager factories ``make_prefill_step`` (fresh caches) and
    ``make_serve_step`` against the reference's: prefill's last logits and
    two decode steps' within f32 atol 1e-4, and the built steps
    (``build_prefill``, ``build_decode``) bitwise the eager ones."""
    jc, tc = _cfgs()
    model = _port(jax_params, tc)
    toks = _prompt(S=10)
    jl, jcache = jengine.make_prefill_step(jc, mesh1, cache_len=14)(
        jax_params, jnp.asarray(toks))
    tl, caches = engine.make_prefill_step(tc, cache_len=14)(
        model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    jstep = jengine.make_serve_step(jc, mesh1)
    tstep = engine.make_serve_step(engine.resolve_decode_config(tc, 2))
    with engine.holding_decode(model, batch=2, cache_len=14) as built:
        built.reset()
        bl, _ = engine.build_prefill(model, cache_len=14, batch=2)(
            torch.from_numpy(toks).long(), built.caches)
        torch.testing.assert_close(bl, tl, rtol=0, atol=0)
        for i in range(2):
            tok = np.array(jnp.argmax(jl[:, -1], -1))[:, None]
            jl, jcache = jstep(jax_params, jnp.asarray(tok), jcache)
            tl, caches = tstep(model, torch.from_numpy(tok).long(), caches)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, err_msg=f"step {i}")
            torch.testing.assert_close(
                built(torch.from_numpy(tok).long()), tl, rtol=0, atol=0)
