"""The port's seeded traffic replay against the reference's: the
workloads bitwise, the router skew, and replays of the reference's three
benchmark scenarios (``benchmarks/bench_traffic.py``: poisson, bursty,
and bursty over a skewed router) at the paper model's smoke config with
the same statuses, decode steps, tokens and counts (f32; the reference on
``mesh1`` with its Pallas kernels in interpret mode, the port on the CPU
with the kernels' plain versions)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.serving import SlotServer as JSlotServer
from repro.serving import traffic as jtraffic
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.models.transformer import Transformer
from repro_torch.serving import (Request, SlotServer, TrafficConfig, replay,
                                 skew_router, synthesize_workload)

ARCH = "hetumoe-paper-16e"
SLOTS, CACHE_LEN = 4, 24                # bench_traffic.py's


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the smoke widths are too small to share out,
    and the parallel test workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    jc = jconfigs.smoke_config(ARCH).replace(dtype="float32")
    jc = jc.replace(moe=dataclasses.replace(jc.moe, use_pallas_gate=True))
    return jc, configs.smoke_config(ARCH).replace(dtype="float32")


@pytest.fixture(scope="module")
def env():
    jc, tc = _cfgs()
    params = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0),
                                                    jc))
    model = Transformer(tc, device="cpu", params=params_from_numpy(params,
                                                                   tc))
    return jc, tc, params, model


def _sig(wl):
    return [(at, r.uid, np.asarray(r.prompt).tolist(), r.max_new)
            for at, r in wl]


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_workload_is_the_references_bitwise(arrival):
    """Arrivals, uids, prompt ids and budgets equal the reference's for
    the same seed (int64 tensors on the CPU); another seed differs."""
    jc, tc = _cfgs()
    tcfg = TrafficConfig(num_requests=10, arrival=arrival, seed=5)
    jcfg = jtraffic.TrafficConfig(num_requests=10, arrival=arrival, seed=5)
    wl = synthesize_workload(tcfg, tc)
    assert _sig(wl) == _sig(jtraffic.synthesize_workload(jcfg, jc))
    assert all(r.prompt.dtype == torch.int64 for _, r in wl)
    assert _sig(wl) != _sig(synthesize_workload(
        dataclasses.replace(tcfg, seed=6), tc))
    assert all(at <= bt for (at, _), (bt, _) in zip(wl, wl[1:]))


def test_bursty_arrivals_and_config_validation():
    _, tc = _cfgs()
    wl = synthesize_workload(
        TrafficConfig(num_requests=10, arrival="bursty", burst_size=4,
                      burst_every=8), tc)
    assert [at for at, _ in wl] == [0] * 4 + [8] * 4 + [16] * 2
    with pytest.raises(ValueError, match="arrival"):
        TrafficConfig(arrival="uniform")
    with pytest.raises(ValueError, match="num_requests"):
        TrafficConfig(num_requests=0)


def test_skew_router_biases_one_column_and_copies(env):
    """On a parameter tree and on a model: every ``gate_w``'s column 1
    gains 16 in its own dtype, bitwise the reference's; the other columns
    and the input stay as they were, and the new model shares every other
    weight with its input."""
    jc, tc, params, model = env
    before = [blk.moe["gate_w"].clone() for blk in model.blocks]
    want = jtraffic.skew_router(jax.tree.map(jnp.asarray, params), bias=16.0,
                                expert=1)
    skewed = skew_router(model, bias=16.0, expert=1)
    tree = params_from_numpy(params, tc)
    tree_skewed = skew_router(tree, bias=16.0, expert=1)
    for i, (blk, new) in enumerate(zip(model.blocks, skewed.blocks)):
        assert torch.equal(blk.moe["gate_w"], before[i])
        gw = new.moe["gate_w"]
        np.testing.assert_array_equal(
            gw.numpy(), np.asarray(want["blocks"][i % len(
                jc.block_pattern)]["moe"]["gate_w"])[i // len(
                    jc.block_pattern)])
        torch.testing.assert_close(gw[:, 1], before[i][:, 1] + 16.0,
                                   rtol=0, atol=0)
        mask = torch.arange(gw.shape[-1]) != 1
        assert torch.equal(gw[:, mask], before[i][:, mask])
        assert (gw.argmax(-1) == 1).all()
        assert new.attn["wq"].data_ptr() == blk.attn["wq"].data_ptr()
        assert torch.equal(tree_skewed["blocks"][i]["moe"]["gate_w"], gw)
        assert torch.equal(tree["blocks"][i]["moe"]["gate_w"], before[i])


# bench_traffic.py's scenarios: (TrafficConfig fields, skewed router)
SCENARIOS = {
    "poisson": (dict(arrival="poisson", rate=0.4, seed=7), False),
    "bursty": (dict(arrival="bursty", burst_size=6, burst_every=8, seed=11),
               False),
    "skewed": (dict(arrival="bursty", burst_size=6, burst_every=8, seed=11),
               True)}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_replay_matches_reference(env, mesh1, scenario):
    """The reference's benchmark scenario (12 requests, 4 slots, a cache
    of 24, grouped, queue limit 16) replayed on both servers: the same
    statuses, decode steps, tokens out, completed / rejected / failed /
    evicted counts and every request's greedy tokens; the wall-clock
    fields are sane."""
    jc, tc, params, model = env
    kw, skew = SCENARIOS[scenario]
    jp = jax.tree.map(jnp.asarray, params)
    if skew:
        jp, model = jtraffic.skew_router(jp), skew_router(model)
    jwl = jtraffic.synthesize_workload(
        jtraffic.TrafficConfig(num_requests=12, **kw), jc)
    twl = synthesize_workload(TrafficConfig(num_requests=12, **kw), tc)
    jrep = jtraffic.replay(JSlotServer(jc, jp, slots=SLOTS,
                                       cache_len=CACHE_LEN, mesh=mesh1,
                                       dispatch="grouped",
                                       queue_limit=4 * SLOTS), jwl)
    trep = replay(SlotServer(model, slots=SLOTS, cache_len=CACHE_LEN,
                             dispatch="grouped", queue_limit=4 * SLOTS), twl)
    for f in ("statuses", "decode_steps", "tokens_out", "completed",
              "rejected", "failed", "evicted", "slot_utilization"):
        assert getattr(trep, f) == getattr(jrep, f), f
    assert ([[int(t) for t in r.out] for _, r in twl]
            == [[int(t) for t in r.out] for _, r in jwl])
    assert trep.completed == 12 and 0.0 < trep.slot_utilization <= 1.0
    assert trep.p99_per_token_s >= trep.p50_per_token_s > 0.0
    assert trep.p99_first_token_s >= trep.p50_first_token_s > 0.0
    assert "completed=12" in trep.summary()


def test_replay_counts_rejections(env):
    """An inadmissible request (prompt longer than the cache) shows up as
    a rejection in the report, not a hang or a crash."""
    _, _, _, model = env
    srv = SlotServer(model, slots=1, cache_len=8, dispatch="grouped")
    wl = [(0, Request(uid=0, prompt=torch.zeros(4, dtype=torch.long),
                      max_new=2)),
          (0, Request(uid=1, prompt=torch.zeros(32, dtype=torch.long),
                      max_new=2))]
    rep = replay(srv, wl)
    assert rep.rejected == 1 and rep.completed == 1
    assert rep.statuses == {0: "ok", 1: "rejected"}
    assert not math.isnan(rep.p50_per_token_s)
