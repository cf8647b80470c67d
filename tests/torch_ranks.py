"""Rank bodies for the tests across ranks (``test_torch_alltoall.py``,
``test_torch_ep.py``, ``test_torch_ep_train.py``, ``test_torch_expert_tp.py``,
``test_torch_serve_ranks.py``, ``test_torch_fsdp.py``,
``test_torch_ckpt_ranks.py``, ``test_torch_cp.py``,
``test_torch_cp_train.py``, ``test_torch_serve_layout.py``,
``test_torch_serve_cache.py``, ``test_torch_serve_state.py``,
``test_torch_analysis.py``): each runs in a process that
``repro_torch.launch.mesh.spawn`` starts, over gloo on the CPU, and returns
numpy arrays.  Imports no JAX: the spawned ranks load only the port."""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from repro_torch.core import alltoall, moe, tuning
from repro_torch.core.config import MoEConfig
from repro_torch.launch.mesh import make_mesh


@contextlib.contextmanager
def env(name, value):
    """``os.environ[name] = value`` for the block; the value the process
    had (or its absence) is put back after it."""
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def _np(t):
    return None if t is None else t.detach().float().numpy()


def exchange_rank(rank, shape, x, g, inners, counts, qdts):
    """The AllToAll forms on this rank's chunk array ``x[rank]`` (M, c, d):
    flat, hierarchical per ``inner``, their backwards against cotangent
    ``g[rank]``, the grouped exchange with ``counts[rank]`` and the
    quantized exchange per wire dtype (forward and backward)."""
    mesh = make_mesh(shape, device="cpu")
    xl = torch.from_numpy(x[rank]).requires_grad_(True)
    gl = torch.from_numpy(g[rank])
    out = {}

    def fwd_bwd(name, fn):
        alltoall.exchanges = 0
        y = fn(xl)
        out[name + "/n"] = alltoall.exchanges
        (dx,) = torch.autograd.grad(y, xl, gl)
        out[name] = _np(y)
        out[name + "/dx"] = _np(dx)

    fwd_bwd("flat", lambda v: alltoall.flat_all_to_all(v, mesh.model_group))
    M = shape[1]
    for inner in inners:
        fwd_bwd(f"hier{inner}", lambda v, i=inner: alltoall.all_to_all(
            v, mesh, mode="hierarchical", inner=i))
        fwd_bwd(f"direct{inner}", lambda v, i=inner:
                alltoall.hierarchical_all_to_all(v, mesh, inner=i,
                                                 outer=M // i))
    c = torch.from_numpy(counts[rank])
    for mode, inner in [("flat", 1)] + [("hierarchical", i) for i in inners]:
        rt, rc = alltoall.grouped_all_to_all(xl.detach(), c, mesh, mode=mode,
                                             inner=inner)
        out[f"grouped/{mode}{inner}"] = _np(rt)
        out[f"grouped/{mode}{inner}/counts"] = rc.numpy()
        for q in qdts:
            key = f"q/{q}/{mode}{inner}"
            y, rc = alltoall.quantized_exchange(xl, c, mesh, mode=mode,
                                                inner=inner, payload_dtype=q)
            (dx,) = torch.autograd.grad(y, xl, gl)
            out[key], out[key + "/counts"] = _np(y), rc.numpy()
            out[key + "/dx"] = _np(dx)
            y, none = alltoall.quantized_exchange(
                xl.detach().to(torch.bfloat16), None, mesh, mode=mode,
                inner=inner, payload_dtype=q, out_dtype=torch.float32)
            assert none is None and y.dtype == torch.float32
            out[key + "/combine"] = _np(y)
    return out


def layer_rank(rank, shape, inputs, cases, fabric, tp=None):
    """``sharded_moe_apply`` on this rank's tokens for every case
    ``(name, MoEConfig fields, act)``: y, aux, metrics, the exchanges (and
    expert-TP collectives) of the forward and this rank's gradients of
    ``sum(y·gy) + aux``; ``tp`` is the ``expert_tp_axis``, under which the
    rank holds the f-slice of its experts that serving stores
    (``launch/shard.Layout(expert_tp=True)``: data index ``di`` of D the
    slice ``[di·f/D, (di+1)·f/D)``)."""
    tuning.set_tuning(fabric=fabric)
    mesh = make_mesh(shape, device="cpu")
    M, m = shape[1], mesh.model_index
    D, di = shape[0], mesh.data_index

    def share(k, v, n):
        if k == "gate_w":
            return v
        v = v[m * n:(m + 1) * n]
        if tp is None or D == 1:
            return v
        f = v.shape[1 if k == "w_out" else 2] // D
        cut = slice(di * f, (di + 1) * f)
        return np.ascontiguousarray(v[:, cut] if k == "w_out"
                                    else v[..., cut])
    x = torch.from_numpy(inputs["x"])
    gy = torch.from_numpy(inputs["gy"])
    xl, valid, _, _ = moe.rank_tokens(mesh, x)
    gyl = moe.rank_tokens(mesh, gy)[0]
    out = {}
    for name, fields, act in cases:
        cfg = MoEConfig(**fields)
        E = cfg.num_experts
        n = E // M
        p = {k: torch.from_numpy(share(k, v, n)).requires_grad_(True)
             for k, v in inputs["params"].items()
             if act in ("swiglu", "geglu") or k != "w_gate"}
        xr = xl.clone().requires_grad_(True)
        alltoall.exchanges = alltoall.tp_collectives = 0
        y, aux, met = moe.sharded_moe_apply(mesh, cfg, p, xr, num_experts=E,
                                            act=act, valid=valid,
                                            expert_tp_axis=tp)
        ex, tpc = alltoall.exchanges, alltoall.tp_collectives
        loss = (y * gyl).sum() + aux
        keys = sorted(p)
        grads = torch.autograd.grad(loss, [xr] + [p[k] for k in keys])
        resolved = tuning.resolve_moe_config(
            cfg, model_size=M, tokens_per_shard=xl.shape[0],
            d_model=xl.shape[1], dtype=xl.dtype)
        out[name] = {"y": _np(y), "aux": float(aux),
                     "metrics": {k: float(v) for k, v in met.items()},
                     "exchanges": ex, "tp_collectives": tpc,
                     "expected": moe.expected_grouped_a2a_eqns(resolved, M),
                     "stages": moe.grouped_a2a_stages(resolved, M),
                     "dx": _np(grads[0]),
                     "grads": {k: _np(g) for k, g in zip(keys, grads[1:])}}
    return out


def _f32_smoke(monkeypatch_target, **moe_kw):
    """Make ``configs.smoke_config`` give the f32 variant (the parity
    tests' precision), with ``moe_kw`` replacing MoE fields."""
    from repro_torch import configs
    base = configs.smoke_config

    def f32(arch):
        cfg = base(arch)
        return cfg.replace(dtype="float32", moe=dataclasses.replace(
            cfg.moe, **moe_kw))
    monkeypatch_target.smoke_config = f32


def train_rank(rank, shape, arch, init_params, kw, tune, flops, skip,
               noisy=None):
    """``launch.train.run`` at ``shape`` from the reference's initial
    parameters (f32 smoke model): the history and this rank's final
    parameters (replicated and expert leaves); with ``skip`` (a
    checkpoint directory) then :func:`skip_rank`'s check; with ``noisy``
    (run keywords) the history of one more run, e.g. a noisy gate's."""
    from repro_torch import tree
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    _f32_smoke(train.configs)
    tuning.set_tuning(flops=flops)
    state, hist = train.run(arch, smoke=True, mesh_shape=shape,
                            device="cpu", init_params=init_params,
                            log_every=1000, **kw, **tune)
    leaves = tree.leaves(state.params)
    mask = tree.leaves(T.expert_leaf_mask(state.params))
    return {"history": hist,
            "replicated": [_np(p) for p, f in zip(leaves, mask) if not f],
            "experts": [_np(p) for p, f in zip(leaves, mask) if f],
            "skip": skip_rank(rank, shape, arch, init_params, skip) if skip
            else None,
            "noisy": None if noisy is None else train.run(
                arch, smoke=True, mesh_shape=shape, device="cpu",
                init_params=init_params, log_every=1000, **noisy)[1]}


def skip_rank(rank, shape, arch, init_params, ckpt_dir):
    """Three f32 steps of ``make_train_step`` at ``shape`` with a NaN
    injected into this rank's gradients at step 1 on rank 1 only: each
    rank's skipped counts, and whether step 1 left its params and moments
    bitwise unchanged; then :func:`ckpt_rank` into ``ckpt_dir``."""
    from repro_torch import configs, tree
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import faults
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training import train_step as ts
    mesh = make_mesh(shape, device="cpu")
    cfg = configs.smoke_config(arch)
    cfg = cfg.replace(dtype="float32")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=3)
    plan = faults.plan_from_specs(["train.grads:nan@1"]) if rank == 1 \
        else None
    step = ts.make_train_step(cfg, tcfg, faults=plan, mesh=mesh)
    state = ts.init_train_state(cfg, tcfg, device="cpu", mesh=mesh,
                                params=params_from_numpy(init_params, cfg,
                                                         mesh))
    ds = SyntheticLM(cfg, batch=4, seq_len=16, device="cpu")
    skipped, unchanged = [], []
    with faults.active(plan):
        for s in range(3):
            new, m = step(state, ds.next_batch(s), step=s)
            skipped.append(int(m["skipped"]))
            unchanged.append(all(
                torch.equal(a, b) for a, b in zip(
                    tree.leaves((new.params, new.opt)),
                    tree.leaves((state.params, state.opt)))))
            state = new
    return {"skipped": skipped, "unchanged": unchanged,
            "ckpt": ckpt_rank(rank, shape, arch, init_params, ckpt_dir)}


def ckpt_rank(rank, shape, arch, init_params, ckpt_dir):
    """``launch.train.run`` at ``shape`` (f32 smoke, the stored layout its
    own) saving every 2 of 4 steps into ``ckpt_dir``, then a resume there
    from the step-2 checkpoint (the step-4 files removed on rank 0) to
    step 4: the two runs' final states (reference checkpoint keys, rank
    0) and the resume's start."""
    import glob
    import os

    import torch.distributed as dist

    from repro_torch import configs, convert
    from repro_torch.launch import train
    kw = dict(steps=4, batch=4, seq=16, smoke=True, device="cpu",
              mesh_shape=shape, init_params=init_params, log_every=1000,
              ckpt_dir=ckpt_dir)
    cfg = configs.smoke_config(arch)
    st = {}
    state, _ = train.run(arch, ckpt_every=2, stats=st, **kw)
    whole = convert.state_to_numpy(state, cfg, layout=st["layout"])
    if rank == 0:
        for f in glob.glob(os.path.join(ckpt_dir, "ckpt_00000004.*")):
            os.remove(f)
    dist.barrier()
    state, hist = train.run(arch, resume=True, stats=st, **kw)
    return {"start": hist[0]["step"], "saves": len(st["save_s"]),
            "whole": whole,
            "resumed": convert.state_to_numpy(state, cfg,
                                              layout=st["layout"])}


def _scalars(state):
    """The state's replicated scalars as Python numbers."""
    return [float(t) for t in (state.opt["count"], state.step,
                               state.skipped, state.nonfinite_streak,
                               state.good_streak, state.loss_scale)]


def load_tree(path):
    """A tree the test process pickled to ``path`` (a spawned rank's
    arguments cross a pipe that blocks the next rank's start while this
    one imports: megabytes of arguments serialise the ranks' startup)."""
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def fsdp_train_rank(rank, arch, init_path, cells, shape_skip):
    """Per cell ``(key, shape, run keywords, twin)``: ``launch.train.run``
    with ``fsdp=True`` and, where ``twin``, then ``fsdp=False`` from the
    reference's initial parameters (f32 smoke model, pickled at
    ``init_path``: :func:`load_tree`): the histories, the
    final states whole (reference checkpoint keys, rank 0), the
    replicated scalars and the parameters this rank stores; then the FSDP
    draw against one process's (:func:`fsdp_draw_check`) and the skip
    check at ``shape_skip`` (:func:`fsdp_skip_rank`)."""
    from repro_torch import configs, convert, tree
    from repro_torch.launch import train
    _f32_smoke(train.configs)
    cfg = configs.smoke_config(arch)
    init_params = load_tree(init_path)
    out = {}
    for key, shape, kw, twin in cells:
        for fsdp in (True, False)[:1 + twin]:
            st = {}
            state, hist = train.run(arch, steps=3, smoke=True, device="cpu",
                                    mesh_shape=shape,
                                    init_params=init_params, log_every=1000,
                                    fsdp=fsdp, stats=st, **kw)
            out[key, fsdp] = dict(
                history=hist, scalars=_scalars(state),
                whole=convert.state_to_numpy(state, cfg,
                                             layout=st["layout"]),
                stored=sum(t.numel() for t in tree.leaves(state.params)))
    out["draw"] = fsdp_draw_check(shape_skip, arch)
    out["skip"] = fsdp_skip_rank(rank, shape_skip, arch, init_params)
    return out


def fsdp_draw_check(shape, arch):
    """``init_train_state`` at ``shape`` under FSDP, drawing its own
    weights (each leaf whole, then cut): gathered whole on rank 0, bitwise
    one process's draw; and each stored leaf's shape, the layout's
    block."""
    from repro_torch import configs, convert, tree
    from repro_torch.core.config import TrainConfig
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import make_mesh, tree_paths
    from repro_torch.training import train_step as ts
    cfg = configs.smoke_config(arch)
    tcfg = TrainConfig()
    mesh = make_mesh(shape, device="cpu")
    layout = shard.layout_for(cfg, mesh, fsdp=True)
    state = ts.init_train_state(cfg, tcfg, device="cpu", mesh=mesh,
                                layout=layout)
    one = ts.init_train_state(cfg, tcfg, device="cpu")
    shapes = convert.param_shapes(cfg)
    blocks = all(tuple(t.shape) == layout.block_shape(p, s.shape)
                 for (p, t), (_, s) in zip(tree_paths(state.params),
                                           tree_paths(shapes), strict=True))
    whole = [layout.to_host(p, t) for p, t in tree_paths(state.params)]
    equal = mesh.rank != 0 or all(
        torch.equal(w, o.detach())
        for w, o in zip(whole, tree.leaves(one.params), strict=True))
    return {"blocks": blocks, "equal": equal}


def fsdp_skip_rank(rank, shape, arch, init_params):
    """:func:`skip_rank`'s check under FSDP: three f32 steps with a NaN in
    rank 1's gradients at step 1; each rank's skipped counts and whether
    step 1 left every block of its params and moments bitwise
    unchanged."""
    from repro_torch import configs, tree
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import faults
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import shard
    from repro_torch.training import train_step as ts
    mesh = make_mesh(shape, device="cpu")
    cfg = configs.smoke_config(arch)
    layout = shard.layout_for(cfg, mesh, fsdp=True)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=3)
    plan = faults.plan_from_specs(["train.grads:nan@1"]) if rank == 1 \
        else None
    step = ts.make_train_step(cfg, tcfg, faults=plan, mesh=mesh,
                              layout=layout)
    state = ts.init_train_state(cfg, tcfg, device="cpu", mesh=mesh,
                                layout=layout,
                                params=params_from_numpy(init_params, cfg,
                                                         mesh, fsdp=True))
    ds = SyntheticLM(cfg, batch=4, seq_len=16, device="cpu")
    skipped, unchanged = [], []
    with faults.active(plan):
        for s in range(3):
            new, m = step(state, ds.next_batch(s), step=s)
            skipped.append(int(m["skipped"]))
            unchanged.append(all(
                torch.equal(a, b) for a, b in zip(
                    tree.leaves((new.params, new.opt)),
                    tree.leaves((state.params, state.opt)))))
            state = new
    return {"skipped": skipped, "unchanged": unchanged}


def _serve_model(shape, cfg, tree, dispatch, fsdp=False):
    """This rank's ``Transformer`` of the reference's parameter tree at
    mesh ``shape``, stored by the serving layout (its share cut by
    ``convert.params_from_numpy(..., serving=True)``)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import serve_config
    mesh = make_smoke_mesh(shape, device="cpu")
    cfg = serve_config(cfg, dispatch=dispatch)
    return Transformer(cfg, device="cpu", mesh=mesh, fsdp=fsdp,
                       params=params_from_numpy(tree, cfg, mesh, fsdp=fsdp,
                                                serving=True))


def greedy_logits(model, prompt, steps):
    """Greedy generation through the step builders, recording the logits
    each token is read from: ``(tokens (B, S + steps), logits (steps, B,
    V))``, the tokens those of ``engine.generate`` (each rank's rows'
    argmax gathered over ``data``, as ``generate`` samples; the logits
    gathered the same way)."""
    from repro_torch.serving import engine
    B, S = prompt.shape
    out, logits = [prompt], []
    with torch.inference_mode():
        prefill = engine.build_prefill(model, cache_len=S + steps, batch=B)
        with engine.holding_decode(model, batch=B,
                                   cache_len=S + steps) as step:
            step.reset()
            last, _ = prefill(prompt, step.caches)
            for i in range(steps):
                logits.append(engine.whole_rows(
                    model, last[:, -1].float().clone(), B))
                tok = engine.whole_rows(
                    model, last[:, -1].argmax(-1, keepdim=True), B)
                out.append(tok)
                if i + 1 < steps:
                    last = step(tok, step_index=i)
    return torch.cat(out, 1).numpy(), torch.stack(logits).numpy()


def serve_rank(rank, shape, cfg, tree, prompts, steps, dispatches, slot_run,
               cli_argv):
    """Serving at mesh ``shape`` on this rank: per dispatch mode and prompt
    batch, ``generate``'s tokens, the same greedy run's logits
    (:func:`greedy_logits`) and ``generate``'s tokens again from a model
    built under ``REPRO_EXPERT_TP=0`` (experts stored whole in f, no
    expert TP); ``SlotServer`` over ``slot_run`` (its keyword
    arguments and request specs ``(uid, prompt, max_new)``) with the first
    dispatch mode; then ``launch.serve.main(cli_argv)``'s printout."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.serving import Request, SlotServer, engine, generate
    torch.manual_seed(0)
    out = {}
    for dispatch in dispatches:
        model = _serve_model(shape, cfg, tree, dispatch)
        with env("REPRO_EXPERT_TP", "0"):
            whole_f = _serve_model(shape, cfg, tree, dispatch)
        for name, p in prompts.items():
            prompt = torch.from_numpy(p).long()
            toks = generate(model, prompt, steps=steps).numpy()
            ref_toks, logits = greedy_logits(model, prompt, steps)
            no_tp = generate(whole_f, prompt, steps=steps).numpy()
            out[dispatch, name] = dict(tokens=toks, loop_tokens=ref_toks,
                                       logits=logits, no_tp=no_tp)
        if dispatch == dispatches[0]:
            kw, specs = slot_run
            srv = SlotServer(model, **kw)
            done = srv.run([Request(uid=u, prompt=torch.from_numpy(
                p.astype(np.int64)), max_new=m) for u, p, m in specs])
            out["slot"] = [(r.uid, r.status, r.error, [int(t) for t in r.out],
                            r.steps_used) for r in done]
            out["slot_graph"] = srv._step.graph is not None
            try:
                engine.build_decode(model, batch=2, cache_len=8, graph=True)
                out["graph_refusal"] = None
            except ValueError as e:
                out["graph_refusal"] = str(e)
        engine.clear_step_cache(model)
        engine.clear_step_cache(whole_f)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        serve.main(cli_argv)
    out["cli"] = text.getvalue()
    return out


def _ckpt_run(arch, init_params, ckpt_dir, **kw):
    """``launch.train.run`` of the f32 smoke model at 2x2 under FSDP, 4
    steps saving every 2 into ``ckpt_dir``: (state, history, stats)."""
    from repro_torch.launch import train
    _f32_smoke(train.configs)
    st = {}
    state, hist = train.run(arch, steps=4, batch=4, seq=16, smoke=True,
                            device="cpu", mesh_shape=(2, 2), fsdp=True,
                            init_params=init_params, log_every=1000,
                            ckpt_dir=ckpt_dir, ckpt_every=2, stats=st, **kw)
    return state, hist, st


def _restore_whole(arch, shape, fsdp, direc):
    """A fresh state at ``shape`` restored from ``direc`` into this
    rank's blocks: (step, the whole state on rank 0, the stored shapes of
    the params' leaves)."""
    from repro_torch import configs, convert, tree
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.core.config import TrainConfig
    from repro_torch.launch import shard
    from repro_torch.training import train_step as ts
    cfg = configs.smoke_config(arch)
    mesh = make_mesh(shape, device="cpu")
    layout = shard.layout_for(cfg, mesh, fsdp=fsdp)
    tpl = ts.init_train_state(cfg, TrainConfig(), device="cpu", mesh=mesh,
                              layout=layout)
    state, step = restore_checkpoint(direc, tpl, cfg=cfg, layout=layout)
    return (step, convert.state_to_numpy(state, cfg, layout=layout),
            [tuple(t.shape) for t in tree.leaves(state.params)])


def ckpt_main_rank(rank, arch, init_params, dirs):
    """The checkpoint across ranks: a 2x2 FSDP run saving every 2 of 4
    steps into ``dirs["run"]`` (its final state whole); that directory
    restored at 1x4 without FSDP; a copy with the step-4 npz truncated
    (rank 0) restored at 2x2 under FSDP (the fallback); the reference's
    checkpoint ``dirs["ref"]`` restored at 2x2 under FSDP."""
    import shutil

    import torch.distributed as dist

    from repro_torch import configs, convert
    from repro_torch.core import faults
    state, hist, st = _ckpt_run(arch, init_params, dirs["run"])
    cfg = configs.smoke_config(arch)
    out = {"whole": convert.state_to_numpy(state, cfg, layout=st["layout"]),
           "saves": len(st["save_s"])}
    out["1x4"] = _restore_whole(arch, (1, 4), False, dirs["run"])
    if rank == 0:
        shutil.copytree(dirs["run"], dirs["truncated"])
        faults.corrupt_file(f"{dirs['truncated']}/ckpt_00000004.npz")
    dist.barrier()
    out["fallback"] = _restore_whole(arch, (2, 2), True, dirs["truncated"])
    out["ref"] = _restore_whole(arch, (2, 2), True, dirs["ref"])
    return out


def ckpt_kill_rank(rank, arch, init_params, ckpt_dir, seam):
    """The 2x2 FSDP run of :func:`ckpt_main_rank` under
    ``--inject ckpt.<seam>:kill@2``: rank 0 SIGKILLs itself at that seam
    of the step-2 save (the other ranks wait at the save's barrier until
    ``spawn`` ends them)."""
    from repro_torch.core import faults
    plan = faults.plan_from_specs([f"ckpt.{seam}:kill@2"])
    _ckpt_run(arch, init_params, ckpt_dir, faults=plan)
    return "not killed"


def ckpt_resume_rank(rank, arch, init_params, dirs):
    """For each directory a killed run left: what ``latest_step`` finds
    there, then the run again with ``--resume``: the step it started
    from and its final state whole (rank 0)."""
    from repro_torch import configs, convert
    from repro_torch.checkpoint import latest_step
    _f32_smoke(configs)
    cfg = configs.smoke_config(arch)
    out = []
    for d in dirs:
        found = latest_step(d)
        state, hist, st = _ckpt_run(arch, init_params, d, resume=True)
        out.append({"latest": found, "start": hist[0]["step"],
                    "whole": convert.state_to_numpy(state, cfg,
                                                    layout=st["layout"])})
    return out



# ---------------------------------------------------------------------------
# context parallelism (test_torch_cp.py, test_torch_cp_train.py,
# test_torch_ep.py): a batch with fewer rows than ranks, each row's
# positions split over the ranks that share it
# ---------------------------------------------------------------------------

def jobs_rank(rank, jobs):
    """Each job ``(key, name, args)`` — a function of this module called
    as ``name(rank, *args)`` — in order on this rank: {key: result}."""
    return {key: globals()[name](rank, *args) for key, name, args in jobs}


def _f32_any(target):
    """Make ``target.smoke_config`` (a configs module) give the f32
    variant of any preset."""
    base = target.smoke_config
    target.smoke_config = lambda arch: base(arch).replace(dtype="float32")


def cp_attention(rank, shape, B, inputs, cases, q_chunk):
    """``full_attention`` on this rank's token block of ``inputs["x"][:B]``
    at mesh ``shape`` (``launch/mesh.token_block``) for each case
    ``(name, AttentionConfig fields, causal, window, flash)`` (``flash``
    False: under ``REPRO_FLASH=0``, the chunked path): the block's y and
    dx, this rank's contributions to the projections' gradients of
    ``sum(y·gy)``, the row-group gathers of the forward, and the members
    of each row group the mesh made."""
    import torch.distributed as dist

    from repro_torch.core.config import AttentionConfig
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import cut_tokens, token_block
    from repro_torch.models import attention
    x = torch.from_numpy(inputs["x"][:B])
    gy = torch.from_numpy(inputs["gy"][:B])
    S = x.shape[1]
    mesh = make_mesh(shape, device="cpu",
                     rows=(cut_tokens(shape, 0, B, S).n,))
    blk = token_block(mesh, B, S)
    out = {"block": (blk.rows.start, blk.rows.stop, blk.seq.start,
                     blk.seq.stop, blk.n),
           "row_groups": {n: dist.get_process_group_ranks(g)
                          for n, g in mesh.rows.items()}}
    for name, fields, causal, window, flash in cases:
        cfg = AttentionConfig(**fields)
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in inputs["params"].items()}
        xl = x[blk.rows, blk.seq].clone().requires_grad_(True)
        shard.row_gathers = 0
        with env("REPRO_FLASH", "1" if flash else "0"):
            y, _ = attention.full_attention(
                p, xl, cfg, positions=blk.positions(), causal=causal,
                window=window, q_chunk=q_chunk, block=blk)
            gathers = shard.row_gathers
            keys = sorted(p)
            grads = torch.autograd.grad((y * gy[blk.rows, blk.seq]).sum(),
                                        [xl] + [p[k] for k in keys])
        out[name] = {"y": _np(y), "dx": _np(grads[0]), "gathers": gathers,
                     "grads": {k: _np(g) for k, g in zip(keys, grads[1:])}}
    return out


def cp_train(rank, shape, arch, init_path, kw):
    """``launch.train.run`` of ``arch``'s f32 smoke model at ``shape`` from
    the reference's initial parameters (pickled at ``init_path``) with
    the run keywords ``kw``: the history, the final state whole (rank 0,
    the reference's checkpoint keys) and the row-group gathers a step."""
    from repro_torch import configs, convert
    from repro_torch.launch import shard, train
    base = train.configs.smoke_config
    _f32_any(train.configs)
    try:
        st = {}
        shard.row_gathers = 0
        state, hist = train.run(arch, smoke=True, device="cpu",
                                mesh_shape=shape, log_every=1000,
                                init_params=load_tree(init_path), stats=st,
                                **kw)
        gathers = shard.row_gathers / len(hist)
        cfg = configs.smoke_config(arch)
        if "moe" in kw:
            import dataclasses as dc
            cfg = cfg.replace(moe=dc.replace(cfg.moe, **kw["moe"]))
        whole = convert.state_to_numpy(state, cfg, layout=st["layout"])
    finally:
        train.configs.smoke_config = base
    return {"history": hist, "whole": whole, "gathers": gathers}


def cp_banner(rank, shape, arch, kw):
    """The resolved MoE knobs ``launch.train.run`` prints at ``shape`` for
    the run keywords ``kw`` (rank 0's banner, from ``dispatch=`` to
    ``remat=``; None elsewhere)."""
    import contextlib
    import io
    import re

    from repro_torch.launch import train
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        train.run(arch, smoke=True, device="cpu", mesh_shape=shape,
                  log_every=1000, **kw)
    m = re.search(r"(dispatch=.*?)remat=", text.getvalue())
    return None if rank else (m.group(1) if m else text.getvalue())


def cp_moe_cut(rank, shape, x, gate_w, fields):
    """The MoE layer's cut of a (B, S, d) batch at ``shape``: this rank's
    token block flattened (and whether it is ``moe.rank_tokens``' block),
    the routes and the sort plan's slots (-1: dropped) at the capacity of
    ``fields``."""
    from repro_torch.core import capacity, gating, layout
    from repro_torch.launch.mesh import cut_tokens, token_block
    xg = torch.from_numpy(x)
    B, S, d = xg.shape
    mesh = make_mesh(shape, device="cpu",
                     rows=(cut_tokens(shape, 0, B, S).n,))
    blk = token_block(mesh, B, S)
    mine = xg[blk.rows, blk.seq].reshape(-1, d)
    cfg = MoEConfig(**fields)
    E = cfg.num_experts
    gate = gating.route(cfg, gating.router_logits(cfg, mine,
                                                  torch.from_numpy(gate_w)))
    plan = layout.plan_sort(gate, E, capacity.expert_capacity(
        cfg, mine.shape[0], E), drop_bucket=True)
    return {"tokens": _np(mine),
            "is_rank_tokens": torch.equal(mine, moe.rank_tokens(mesh, xg)[0]),
            "flat": (blk.flat.start, blk.flat.stop),
            "expert_index": gate.expert_index.numpy(),
            "slot": plan.slot.numpy()}


def cp_grads(rank, shape, arch, init_path, B, S):
    """One f32 smoke batch (``SyntheticLM``, seed 0) of ``arch`` at
    ``shape`` through ``train_step.loss_and_grads`` on this rank's token
    block, from the reference's parameters: the loss and the gradients
    summed over the ranks (rank 0, the reference's stacked tree)."""
    import torch.distributed as dist

    from repro_torch import configs, tree
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.data.pipeline import SyntheticLM, cut_batch
    from repro_torch.launch.mesh import cut_tokens, token_block
    from repro_torch.training import train_step as ts
    mesh = make_mesh(shape, device="cpu",
                     rows=(cut_tokens(shape, 0, B, S).n,))
    cfg = configs.smoke_config(arch).replace(dtype="float32")
    params = tree.map_(lambda t: t.requires_grad_(True),
                       params_from_numpy(load_tree(init_path), cfg))
    blk = token_block(mesh, B, S)
    batch = cut_batch(SyntheticLM(cfg, B, S, device="cpu").next_batch(0),
                      blk)
    loss, _, _, grads = ts.loss_and_grads(params, batch, cfg, mesh=mesh,
                                          block=blk)
    leaves = tree.leaves(grads)
    for g in leaves:
        dist.all_reduce(g)
    return {"loss": float(loss), "split": blk.n,
            "grads": params_to_numpy(tree.unflatten(grads, leaves), cfg)
            if rank == 0 else None}


def cp_reduce_scatter(rank, shape, xs, dim, pieces):
    """``launch/shard._reduce_scatter`` over the model group at ``shape``
    of this rank's ``xs[rank]`` (f32 values exact in bf16), sent as bf16
    and as f32 and summed in f32, in pieces of at most each of
    ``pieces`` bytes (None: the module's own): {(dtype, piece): block}."""
    from repro_torch.launch import shard
    mesh = make_mesh(shape, device="cpu")
    x = torch.from_numpy(xs[rank])
    n = shape[1]
    default, out = shard._PIECE_BYTES, {}
    try:
        for piece in pieces:
            shard._PIECE_BYTES = default if piece is None else piece
            for dt in (torch.bfloat16, torch.float32):
                out[str(dt).split(".")[-1], piece] = shard._reduce_scatter(
                    x.to(dt), mesh.model_group, n, dim, torch.float32,
                    "model").numpy()
    finally:
        shard._PIECE_BYTES = default
    return out


def _logged(fn):
    """``fn()``'s result and the collectives it logged
    (``core/alltoall.collectives``)."""
    alltoall.collectives = []
    try:
        out = fn()
        return out, list(alltoall.collectives)
    finally:
        alltoall.collectives = None


def _cache_arrays(caches):
    """Every leaf of per-layer caches by its path, as numpy arrays."""
    from repro_torch.launch.mesh import tree_paths
    return {p: _np(t) for p, t in tree_paths(list(caches))}


def _served_run(model, prompt, steps, keep_caches=False):
    """A greedy run through the step builders: tokens, each step's logits
    (each rank's rows gathered over ``data``, unlogged), and the
    collectives of the prefill and of the first decode step, each with
    its tokens' gather over ``data`` (``generate``'s sampling); with
    ``keep_caches`` the caches (the rank's blocks) after the prefill
    and after the last step, and their bytes."""
    from repro_torch.serving import engine
    B, S = prompt.shape
    out, logits, logs = [prompt], [], {}

    def sample(last):
        return last, engine.whole_rows(
            model, last[:, -1].argmax(-1, keepdim=True), B)
    with torch.inference_mode():
        prefill = engine.build_prefill(model, cache_len=S + steps, batch=B)
        with engine.holding_decode(model, batch=B,
                                   cache_len=S + steps) as step:
            step.reset()
            (last, tok), logs["prefill"] = _logged(
                lambda: sample(prefill(prompt, step.caches)[0]))
            prefilled = _cache_arrays(step.caches) if keep_caches else None
            for i in range(steps):
                logits.append(engine.whole_rows(
                    model, last[:, -1].float().clone(), B))
                out.append(tok)
                if i + 1 < steps:
                    (last, tok), log = _logged(
                        lambda: sample(step(tok, step_index=i)))
                    logs.setdefault("decode", log)
            run = dict(tokens=torch.cat(out, 1).numpy(),
                       logits=torch.stack(logits).numpy(), logs=logs)
            if keep_caches:
                run["caches"] = _cache_arrays(step.caches)
                run["prefill_caches"] = prefilled
                run["cache_bytes"] = sum(
                    t.numel() * t.element_size()
                    for t in engine._cache_leaves(step.caches))
    engine.clear_step_cache(model)
    return run


def _whole_f_views(model, tree, cfg, mesh):
    """``model`` (stored under expert TP) with each expert leaf replaced
    by a view of its f-slice into the rank's experts held whole in f —
    the computation serving ran before the slice was stored."""
    import os

    from repro_torch.convert import params_from_numpy
    with env("REPRO_EXPERT_TP", "0"):
        whole = params_from_numpy(tree, cfg, mesh, serving=True)
    D, di = mesh.shape["data"], mesh.data_index
    for blk, p in zip(model.blocks, whole["blocks"], strict=True):
        for k in ("w_up", "w_gate", "w_out"):
            if k not in p.get("moe", {}):
                continue
            w = p["moe"][k].to(model.dtype)
            f = w.shape[1 if k == "w_out" else 2] // D
            cut = slice(di * f, (di + 1) * f)
            view = w[:, cut] if k == "w_out" else w[..., cut]
            blk.moe[k] = torch.nn.Parameter(view, requires_grad=False)
    return model


def serve_layout_rank(rank, init_path, cfg, prompt, steps, meshes,
                      train_cells):
    """The served state stored by the serving rule, on this rank, at each
    mesh shape of ``meshes`` (all over the one world of four): per
    ``fsdp`` the stored blocks and bytes and a greedy run's tokens,
    logits and logged collectives (grouped; sort's collectives too);
    ``REPRO_EXPERT_TP=0``'s run; the run on views of whole-f experts.
    Then per train cell ``(shape, dispatch, fsdp, B, S)`` one train
    step's logged collectives and its stored-state bytes."""
    import dataclasses as dc
    import os

    from repro_torch import tree as tree_lib
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import shard
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import serve_config
    from repro_torch.training import train_step as ts
    tree = load_tree(init_path)
    prompt = torch.from_numpy(prompt).long()
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape, device="cpu")
        for dispatch in ("grouped", "sort"):
            c = serve_config(cfg, dispatch=dispatch)
            for fsdp in (False, True):
                if dispatch == "sort" and fsdp:
                    continue
                model = Transformer(c, device="cpu", mesh=mesh, fsdp=fsdp,
                                    params=params_from_numpy(
                                        tree, c, mesh, fsdp=fsdp,
                                        serving=True))
                run = _served_run(model, prompt, steps)
                if dispatch == "grouped":
                    run["stored"] = {p: _np(t) for p, t in
                                     shard.mesh_lib.tree_paths(model.tree())}
                    run["stored_bytes"] = model.stored_bytes()
                run["layout_key"] = model.layout_key
                out[shape, dispatch, fsdp] = run
        c = serve_config(cfg, dispatch="grouped")
        with env("REPRO_EXPERT_TP", "0"):
            whole = Transformer(c, device="cpu", mesh=mesh,
                                params=params_from_numpy(tree, c, mesh,
                                                         serving=True))
            out[shape, "no_tp"] = _served_run(whole, prompt, steps)
            out[shape, "no_tp"]["layout_key"] = whole.layout_key
        model = Transformer(c, device="cpu", mesh=mesh,
                            params=params_from_numpy(tree, c, mesh,
                                                     serving=True))
        out[shape, "views"] = _served_run(_whole_f_views(model, tree, c,
                                                         mesh), prompt, steps)
    for shape, dispatch, fsdp, B, S in train_cells:
        tc = cfg.replace(moe=dc.replace(cfg.moe, dispatch=dispatch))
        n = max(1, shape[0] * shape[1] // B)
        mesh = make_mesh(shape, device="cpu", rows=(n,))
        layout = shard.layout_for(tc, mesh, fsdp=fsdp)
        tcfg = TrainConfig()
        state = ts.init_train_state(tc, tcfg, device="cpu", mesh=mesh,
                                    params=params_from_numpy(tree, tc, mesh,
                                                             fsdp=fsdp),
                                    layout=layout)
        step = ts.make_train_step(tc, tcfg, mesh=mesh, layout=layout)
        batch = SyntheticLM(tc, B, S, seed=0, device="cpu").next_batch(0)
        (_, met), log = _logged(lambda: step(state, batch))
        out["train", shape, dispatch, fsdp] = dict(
            log=log, loss=float(met["loss"]),
            state_bytes=sum(t.numel() * t.element_size() for t in
                            tree_lib.leaves((state.params, state.opt))
                            if t.dim() > 0))
    return out


def slot_outputs(model, kw, specs):
    """``SlotServer(model, **kw)`` over requests ``(uid, prompt, max_new)``:
    each finished request's (uid, status, error, tokens, steps used)."""
    from repro_torch.serving import Request, SlotServer
    srv = SlotServer(model, **kw)
    done = srv.run([Request(uid=u, prompt=torch.from_numpy(
        p.astype(np.int64)), max_new=m) for u, p, m in specs])
    return [(r.uid, r.status, r.error, [int(t) for t in r.out],
             r.steps_used) for r in done]


def serve_cache_rank(rank, shape, init_path, cells, steps, slot_run):
    """The served caches stored by the reference's cache rule, on this rank
    at mesh ``shape``: per cell ``(name, cfg, prompt)`` a greedy run's
    tokens, logits, logged collectives, its caches after the last step
    (this rank's blocks) and their bytes, ``generate``'s tokens,
    ``SlotServer``'s outputs over ``slot_run`` (its keyword arguments and
    request specs), and a greedy run of the prompts' first
    ``CHANNEL_PROMPT`` tokens into caches of 10 positions with the
    caches' attention forms (``channels`` at 1x4)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import engine
    tree = load_tree(init_path)
    mesh = make_mesh(shape, device="cpu")
    out = {}
    for name, cfg, prompt in cells:
        model = Transformer(cfg, device="cpu", mesh=mesh,
                            params=params_from_numpy(tree, cfg, mesh,
                                                     serving=True))
        p = torch.from_numpy(prompt).long()
        run = _served_run(model, p, steps, keep_caches=True)
        run["generate"] = engine.generate(model, p, steps=steps).numpy()
        kw, specs = slot_run[name]
        run["slot"] = slot_outputs(model, kw, specs)
        short = p[:, :CHANNEL_PROMPT]
        run["channels"] = _served_run(model, short, steps)
        run["channels"]["forms"] = model.cache_layout(
            p.shape[0], CHANNEL_PROMPT + steps).forms
        engine.clear_step_cache(model)
        out[name] = run
    return out


# the prompt of serve_cache_rank's channel-cut run: caches of 10 positions
# with 4 steps, which neither 2 kv heads nor the positions divide over 4
CHANNEL_PROMPT = 6


def _state_model(mesh, cfg, path):
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.transformer import Transformer
    tree = load_tree(path)
    return Transformer(cfg, device="cpu", mesh=mesh,
                       params=params_from_numpy(tree, cfg, mesh,
                                                serving=True))


def serve_state_rank(rank, shape, cells, steps, slot_run, forms):
    """Every served cache stored by the reference's cache rule, on this
    rank at mesh ``shape``: per cell ``(name, cfg, tree path, prompt)`` a
    greedy run's tokens, logits, logged collectives and caches (this
    rank's blocks, after the prefill and after the last step) and their
    bytes, the caches' forms and state cuts, ``generate``'s tokens, and
    for the cells of ``slot_run`` ``SlotServer``'s outputs; with
    ``forms`` (a list of configs) each decode form's step on this rank's
    block against the whole step (:func:`decode_forms`)."""
    from repro_torch.serving import engine
    mesh = make_mesh(shape, device="cpu")
    out = {}
    for name, cfg, path, prompt in cells:
        model = _state_model(mesh, cfg, path)
        p = torch.from_numpy(prompt).long()
        B, S = p.shape
        run = _served_run(model, p, steps, keep_caches=True)
        lay = model.cache_layout(B, S + steps)
        run["forms"], run["dims"] = lay.forms, lay.dims
        run["generate"] = engine.generate(model, p, steps=steps).numpy()
        if name in slot_run:
            run["slot"] = slot_outputs(model, *slot_run[name])
        engine.clear_step_cache(model)
        out[name] = run
    if forms:
        out["forms"] = decode_forms(mesh, *forms)
    return out


def _cut(mesh, form="whole", length=0, **dims):
    from repro_torch.models.cache_cut import CacheCut
    return CacheCut(form, mesh.shape["model"], mesh.model_index,
                    mesh.model_group, length, tuple(dims.items()))


def _err(got, want):
    """max|got − want| / max|want|."""
    return float((got - want).abs().max() / want.abs().max())


def decode_forms(mesh, rwkv_cfg, ssm_cfg, attn_cfg, d, batch=3):
    """Each decode form of a cut state or cache on this rank's block
    against the whole step (the same seeded weights, state and token on
    every rank): RWKV's ``s`` cut in dims 1-3, Mamba's ``s`` in dims
    1-3 with its ``conv`` in its positions (1) or channels (2), and an
    attention cache in the ``heads``, ``positions`` and ``channels``
    forms, linear and ring.  Per form: the output's error and the new
    state's (the written cache's) against the whole step's block, each
    over the largest magnitude of the whole."""
    from repro_torch.models import attention as A
    from repro_torch.models import mamba2, rwkv6
    gen = torch.Generator().manual_seed(5)

    def rand(*shape):
        return torch.randn(shape, generator=gen)
    x = rand(batch, 1, d)
    out = {}
    p = rwkv6.init_rwkv_block(gen, rwkv_cfg, d)
    H = d // rwkv_cfg.head_dim
    st = {"s": rand(batch, H, rwkv_cfg.head_dim, rwkv_cfg.head_dim),
          "x_last": rand(batch, d)}
    y, new = rwkv6.rwkv_decode_step(p, x, st, rwkv_cfg)
    for dim in (1, 2, 3):
        cut = _cut(mesh, s=dim)
        yc, nc = rwkv6.rwkv_decode_step(
            p, x, dict(st, s=cut.take(st["s"], dim)), rwkv_cfg, cut)
        out[f"rwkv/s{dim}"] = (_err(yc, y),
                               _err(nc["s"], cut.take(new["s"], dim)))
    p = mamba2.init_mamba_block(gen, ssm_cfg, d)
    p["conv_b"] = 0.2 * rand(*p["conv_b"].shape)
    st = {k: rand(*v.shape) if v.ndim else v
          for k, v in mamba2.init_mamba_state(ssm_cfg, batch, d).items()}
    y, new = mamba2.mamba_decode_step(p, x, st, ssm_cfg, d)
    for sd in (1, 2, 3):
        for cd in (1, 2):
            cut = _cut(mesh, s=sd, conv=cd)
            blk = dict(st, s=cut.take(st["s"], sd),
                       conv=cut.take(st["conv"], cd))
            yc, nc = mamba2.mamba_decode_step(p, x, blk, ssm_cfg, d, cut)
            out[f"mamba/s{sd}conv{cd}"] = (_err(yc, y), max(
                _err(nc["s"], cut.take(new["s"], sd)),
                _err(nc["conv"], cut.take(new["conv"], cd))))
    p = A.init_attention(gen, attn_cfg, d)
    hd = attn_cfg.head_dim
    for ring in (False, True):
        W = 12
        kv = {n: rand(batch, W, attn_cfg.num_kv_heads, hd) for n in "kv"}
        pos = 17 if ring else 7
        whole = dict(kv, pos=torch.tensor(pos, dtype=torch.int32))
        ref_cache = {n: t.clone() for n, t in whole.items()}
        y, _ = A.decode_attention(p, x, ref_cache, attn_cfg, ring=ring,
                                  window=W if ring else None)
        for form, dim in (("heads", 2), ("positions", 1), ("channels", 3)):
            cut = _cut(mesh, form, W)
            blk = {n: cut.take(kv[n], dim).clone() for n in "kv"}
            blk["pos"] = torch.tensor(pos, dtype=torch.int32)
            yc, _ = A.decode_attention(p, x, blk, attn_cfg, ring=ring,
                                       window=W if ring else None, cut=cut)
            out[f"attention/{form}{'/ring' if ring else ''}"] = (
                _err(yc, y), max(_err(blk[n], cut.take(ref_cache[n], dim))
                                 for n in "kv"))
    return out


# ---------------------------------------------------------------------------
# the graph-invariant linter (test_torch_analysis.py): a job of the lint's
# own ep4 spawn (repro_torch.analysis.lint.mesh_rank)
# ---------------------------------------------------------------------------

def lint_sequential_windows(mesh):
    """PR 5's anti-pattern in eager form, recorded: two windows of this
    rank's tokens exchanged and computed one after the other
    (``sharded_moe_apply`` at ``overlap_chunks=1`` on each half), linted
    against the ``overlap_chunks=2`` contract of the ep4 cells."""
    from repro_torch.analysis import lint, trace_graph

    spec = lint.parse_cell("grouped/ep4/flat/P1")
    params, xl, valid = lint._inputs(spec, mesh, torch.device("cpu"))
    cfg = lint._cell_cfg(spec)
    half = xl.shape[0] // 2

    def windows(p, v):
        return [moe.sharded_moe_apply(mesh, cfg, p, v[i * half:(i + 1) * half],
                                      num_experts=lint.E, act="swiglu",
                                      valid=valid[i * half:(i + 1) * half])[0]
                for i in range(2)]
    return trace_graph(windows, params, xl, context={
        "cfg": dataclasses.replace(cfg, overlap_chunks=2),
        "model_size": mesh.shape["model"], "tokens_per_shard": xl.shape[0],
        "d_model": lint.D_MODEL, "dtype": torch.bfloat16,
        "direction": "fwd", "label": "sequential-windows"})
