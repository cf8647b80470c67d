"""The port's ``SlotServer`` against the reference's: every scenario of the
reference's ``test_serving.py`` (the grouped server against ``generate``)
and ``test_faults.py`` (the mixed workload, the oversized prompt,
backpressure, the deadline, ``decode_row`` containment, the stall), run
on both servers over the same weights (the reference's ``init_model``
through ``convert.params_from_numpy``; the reference on ``mesh1`` with its
Pallas kernels in interpret mode, the port on the CPU with the kernels'
plain versions).  Statuses, errors, greedy tokens, steps used, the order
of completion and ``plan.fired`` must be the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import faults as JF
from repro.models import transformer as JT
from repro.serving import Request as JRequest
from repro.serving import SlotServer as JSlotServer
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as F
from repro_torch.models.transformer import Transformer
from repro_torch.serving import Request, SlotServer, engine, generate

GEN = 5
P = 6                                   # prompt length


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the smoke widths are too small to share out,
    and the parallel test workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(reference, port) f32 smoke configs; the reference runs its Pallas
    gate, as the port always runs its kernel."""
    jc = jconfigs.smoke_config(arch).replace(dtype="float32")
    tc = configs.smoke_config(arch).replace(dtype="float32")
    if jc.moe is not None:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, use_pallas_gate=True))
    return jc, tc


class Env:
    """One preset's weights on both sides, and seeded prompts of P tokens
    (numpy int32)."""

    def __init__(self, arch, seed=0):
        self.jc, self.tc = _cfgs(arch)
        self.params = jax.tree.map(np.asarray, JT.init_model(
            jax.random.PRNGKey(seed), self.jc))
        self.jparams = jax.tree.map(jnp.asarray, self.params)
        self.model = Transformer(self.tc, device="cpu",
                                 params=params_from_numpy(self.params,
                                                          self.tc))
        rng = np.random.default_rng(seed + 1)
        self.prompts = [rng.integers(0, self.tc.vocab_size, (P,)).astype(
            np.int32) for _ in range(4)]

    def refs(self, n, dispatch=None):
        """The port's batch-1 greedy ``generate`` continuations."""
        return [generate(self.model, torch.from_numpy(p[None]).long(),
                         steps=GEN, dispatch=dispatch)[0, P:].tolist()
                for p in self.prompts[:n]]

    def both(self, mesh, specs, plan_sites=None, **kw):
        """Run the reference's and the port's server over the request
        specs ``(uid, prompt ndarray, max_new, extra kwargs)``, each under
        its own plan of ``plan_sites`` (``{site: (steps, mode,
        stall_s)}``); returns (reference done, port done, reference plan,
        port plan)."""
        jplan, tplan = (None, None) if plan_sites is None else (
            _plan(JF, plan_sites), _plan(F, plan_sites))
        jreqs = [JRequest(uid=u, prompt=jnp.asarray(p, jnp.int32),
                          max_new=m, **x) for u, p, m, x in specs]
        treqs = [Request(uid=u, prompt=torch.from_numpy(p.astype(np.int64)),
                         max_new=m, **x) for u, p, m, x in specs]
        with JF.active(jplan):
            jd = JSlotServer(self.jc, self.jparams, mesh=mesh, **kw).run(
                jreqs)
        with F.active(tplan):
            td = SlotServer(self.model, **kw).run(treqs)
        return jd, td, jplan, tplan


def _plan(mod, sites):
    return mod.FaultPlan(sites={
        s: mod.FaultSpec(steps=st, mode=m, stall_s=ss)
        for s, (st, m, ss) in sites.items()})


def _summary(done):
    return [(r.uid, r.status, r.error, [int(t) for t in r.out],
             r.steps_used) for r in done]


@pytest.fixture(scope="module")
def starcoder():
    return Env("starcoder2-3b")


@pytest.fixture(scope="module")
def dbrx():
    return Env("dbrx-132b")


def test_mixed_workload_matches_reference(starcoder, mesh1):
    """Oversized + out-of-range + poisoned-prefill + poisoned-decode
    requests drain on both servers with the same statuses, errors and
    tokens; the healthy outputs are the port's greedy ``generate``."""
    e = starcoder
    V = e.tc.vocab_size
    specs = [(i, p, GEN, {}) for i, p in enumerate(e.prompts)]
    specs += [(10, np.zeros(64, np.int32), 3, {}),
              (11, np.full(4, V, np.int32), 3, {})]
    sites = {"serve.prefill_logits": ((1,), "nan", 0.05),
             "serve.step_logits": ((2,), "inf", 0.05)}
    jd, td, jp, tp = e.both(mesh1, specs, sites, slots=2,
                            cache_len=P + GEN + 2, queue_limit=8)
    assert _summary(td) == _summary(jd)
    assert tp.fired == jp.fired
    by = {r.uid: r for r in td}
    assert by[1].status == "failed" and "prefill" in by[1].error
    assert by[2].error == "non_finite_decode_logits"
    assert by[10].error.startswith("prompt_too_long")
    assert by[11].error.startswith("token_out_of_range")
    refs = e.refs(4)
    for uid in (0, 3):
        assert by[uid].status == "ok" and by[uid].out == refs[uid]
    assert ("serve.prefill_logits", 1) in tp.fired
    assert ("serve.step_logits", 2) in tp.fired


def test_oversized_prompt_structured_rejection_no_prefill(starcoder):
    e = starcoder
    srv = SlotServer(e.model, slots=1, cache_len=8)
    big = Request(uid=0, prompt=torch.zeros(8, dtype=torch.long), max_new=2)
    assert srv.submit(big) is True                # consumed, not admitted
    assert big.status == "rejected" and big.done
    assert big.error == "prompt_too_long:8>cache_len-1=7"
    assert not srv.active
    edge = Request(uid=1, prompt=torch.zeros(7, dtype=torch.long), max_new=2)
    assert srv.submit(edge) is True and edge.status == "active"
    bad = Request(uid=2, prompt=torch.zeros((2, 3), dtype=torch.long),
                  max_new=2)
    assert srv.submit(bad) and bad.error == "bad_prompt_shape:(2, 3)"


def test_queue_backpressure_and_limit_validation(starcoder):
    e = starcoder
    srv = SlotServer(e.model, slots=1, cache_len=16, queue_limit=2)
    p = torch.from_numpy(e.prompts[0]).long()
    rs = [Request(uid=i, prompt=p, max_new=2) for i in range(3)]
    assert srv.enqueue(rs[0]) and srv.enqueue(rs[1])
    assert srv.enqueue(rs[2]) is False
    assert rs[2].status == "rejected" and rs[2].error == "queue_full"
    with pytest.raises(ValueError, match="queue_limit"):
        SlotServer(e.model, slots=1, cache_len=16, queue_limit=0)


def test_deadline_evicts_but_server_survives(starcoder, mesh1):
    e = starcoder
    specs = [(0, e.prompts[0], 25, {}),
             (1, e.prompts[1], GEN, {"deadline_steps": 100})]
    jd, td, _, _ = e.both(mesh1, specs, slots=2, cache_len=32,
                          default_deadline_steps=2)
    assert _summary(td) == _summary(jd)
    by = {r.uid: r for r in td}
    assert by[0].status == "evicted" and by[0].error == "deadline"
    assert by[0].steps_used == 2
    assert by[1].status == "ok" and by[1].out == e.refs(2)[1]


def test_stall_site_fires_without_breaking_decode(starcoder, mesh1):
    e = starcoder
    jd, td, jp, tp = e.both(mesh1, [(0, e.prompts[0], GEN, {})],
                            {"serve.step": ((0,), "stall", 0.01)},
                            slots=1, cache_len=P + GEN + 2)
    assert _summary(td) == _summary(jd)
    assert td[0].status == "ok" and td[0].out == e.refs(1)[0]
    assert tp.fired == jp.fired == [("serve.step", 0)]


def test_slot_server_grouped_matches_generate_and_reference(dbrx, mesh1):
    """Under dispatch='grouped' the port's server gives, on every slot,
    the port's batch-1 grouped ``generate`` tokens and the reference
    server's tokens and statuses (the reference's acceptance bar)."""
    e = dbrx
    specs = [(i, p, 4, {}) for i, p in enumerate(e.prompts[:3])]
    jd, td, _, _ = e.both(mesh1, specs, slots=2, cache_len=P + 4 + 2,
                          dispatch="grouped")
    assert _summary(td) == _summary(jd)
    refs = [generate(e.model, torch.from_numpy(p[None]).long(), steps=4,
                     dispatch="grouped")[0, P:].tolist()
            for p in e.prompts[:3]]
    assert sorted(r.uid for r in td) == [0, 1, 2]
    for r in td:
        assert r.status == "ok" and r.out == refs[r.uid], r.uid


def test_decode_row_poison_contained_under_grouped_dispatch(dbrx, mesh1):
    """``serve.decode_row`` poisons one seeded element of step 1's
    batched logits, inside the decode step: exactly the slot it lands in
    fails, on both servers the same; the others finish with the clean
    grouped ``generate`` tokens."""
    e = dbrx
    specs = [(i, p, GEN, {}) for i, p in enumerate(e.prompts[:3])]
    jd, td, jp, tp = e.both(mesh1, specs, {"serve.decode_row": ((1,), "nan", 0.05)},
                            slots=2, cache_len=P + GEN + 2,
                            dispatch="grouped", queue_limit=8)
    assert _summary(td) == _summary(jd)
    assert tp.fired == jp.fired and ("serve.decode_row", 1) in tp.fired
    failed = [r for r in td if r.status == "failed"]
    assert len(failed) == 1
    assert failed[0].error == "non_finite_decode_logits"
    refs = e.refs(3, dispatch="grouped")
    for r in td:
        if r.status == "ok":
            assert r.out == refs[r.uid], r.uid
    assert sum(r.status == "ok" for r in td) == 2


def test_slot_prefill_matches_reference_and_commits_only_on_success(dbrx, mesh1):
    """The slot prefill's last logits within 1e-5 of their max of the
    reference's ``build_slot_prefill`` (f32); its caches land in row
    ``slot`` with the shared position; a poisoned prefill leaves every
    cache tensor as it was."""
    e = dbrx
    p = e.prompts[2]
    jcache = JT.init_caches(e.jc, 2, 12, dtype=jnp.float32)
    jl, jcache = jengine.build_slot_prefill(e.jc, mesh1, cache_len=12)(
        e.jparams, jnp.asarray(p)[None, :], jcache, 1)
    srv = SlotServer(e.model, slots=2, cache_len=12)
    req = Request(uid=0, prompt=torch.from_numpy(p).long(), max_new=3)
    assert srv.submit(req) and srv.active == {0: req}
    tl, _ = engine.build_slot_prefill(e.model, cache_len=12)(
        torch.from_numpy(p[None]).long())
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    assert req.out == [int(np.argmax(want))]
    for c in srv.caches:
        assert int(c["pos"]) == P and not c["k"][1].any()
        assert c["k"][0, :P].abs().sum() > 0
    before = [{k: v.clone() for k, v in c.items()} for c in srv.caches]
    plan = F.FaultPlan(sites={"serve.prefill_logits": F.FaultSpec(
        steps=(7,), mode="nan")})
    poisoned = Request(uid=7, prompt=torch.from_numpy(p).long(), max_new=3)
    with F.active(plan):
        assert srv.submit(poisoned)
    assert poisoned.status == "failed" and poisoned.error.startswith("prefill")
    for c, b in zip(srv.caches, before):
        assert all(torch.equal(c[k], b[k]) for k in b)


def test_live_servers_of_one_key_get_their_own_steps(starcoder):
    """Two live servers of one step key would share its caches: the
    second gets its own instance of the step (and so does a ``generate``
    beside them), and both serve the greedy tokens; once the first is gone
    a new server takes its step back, zeroed.  A frontend or encoder-only
    config is refused."""
    e = starcoder
    p = [torch.from_numpy(q).long() for q in e.prompts[:2]]
    a = SlotServer(e.model, slots=2, cache_len=14)
    b = SlotServer(e.model, slots=2, cache_len=14)
    assert a._step is not b._step
    assert (a._step.caches[0]["k"].data_ptr()
            != b._step.caches[0]["k"].data_ptr())
    ra, rb = (Request(uid=i, prompt=p[i], max_new=GEN) for i in range(2))
    assert a.submit(ra) and b.submit(rb)
    out = generate(e.model, p[0][None], steps=GEN, cache_len=14)
    for _ in range(GEN):
        a.step()
        b.step()
    refs = e.refs(2)
    assert ra.out == refs[0] and rb.out == refs[1]
    assert out[0, P:].tolist() == refs[0]
    step = a._step
    with torch.inference_mode():
        step.caches[0]["pos"].fill_(3)
    del a
    c = SlotServer(e.model, slots=2, cache_len=14)
    assert c._step is step and int(step.caches[0]["pos"]) == 0
    assert engine.trace_budget_report() == {}
    for name in ("hubert-xlarge", "internvl2-2b"):
        cfg = configs.smoke_config(name)
        with pytest.raises(ValueError, match="SlotServer serves token"):
            SlotServer(Transformer(cfg, device="cpu"), slots=1, cache_len=8)
