"""Rank bodies for the tests across ranks (``test_torch_alltoall.py``,
``test_torch_ep.py``, ``test_torch_ep_train.py``, ``test_torch_expert_tp.py``,
``test_torch_serve_ranks.py``, ``test_torch_fsdp.py``,
``test_torch_ckpt_ranks.py``, ``test_torch_cp.py``,
``test_torch_cp_train.py``): each runs in a process that
``repro_torch.launch.mesh.spawn`` starts, over gloo on the CPU, and returns
numpy arrays.  Imports no JAX: the spawned ranks load only the port."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import alltoall, moe, tuning
from repro_torch.core.config import MoEConfig
from repro_torch.launch.mesh import make_mesh


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
    ``sum(y·gy) + aux``; ``tp`` is the ``expert_tp_axis``."""
    tuning.set_tuning(fabric=fabric)
    mesh = make_mesh(shape, device="cpu")
    M, m = shape[1], mesh.model_index
    x = torch.from_numpy(inputs["x"])
    gy = torch.from_numpy(inputs["gy"])
    xl, valid, _, _ = moe.rank_tokens(mesh, x)
    gyl = moe.rank_tokens(mesh, gy)[0]
    out = {}
    for name, fields, act in cases:
        cfg = MoEConfig(**fields)
        E = cfg.num_experts
        n = E // M
        p = {k: torch.from_numpy(v if k == "gate_w"
                                 else v[m * n:(m + 1) * n]).requires_grad_(
            True) for k, v in inputs["params"].items()
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


def _serve_model(shape, cfg, tree, dispatch):
    """This rank's ``Transformer`` of the reference's parameter tree at
    mesh ``shape`` (its experts cut by ``convert.params_from_numpy``)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving.engine import serve_config
    mesh = make_smoke_mesh(shape, device="cpu")
    cfg = serve_config(cfg, dispatch=dispatch)
    return Transformer(cfg, device="cpu", mesh=mesh,
                       params=params_from_numpy(tree, cfg, mesh))


def greedy_logits(model, prompt, steps):
    """Greedy generation through the step builders, recording the logits
    each token is read from: ``(tokens (B, S + steps), logits (steps, B,
    V))``, the tokens those of ``engine.generate``."""
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
                logits.append(last[:, -1].float().clone())
                tok = last[:, -1].argmax(-1, keepdim=True)
                out.append(tok)
                if i + 1 < steps:
                    last = step(tok, step_index=i)
    return torch.cat(out, 1).numpy(), torch.stack(logits).numpy()


def serve_rank(rank, shape, cfg, tree, prompts, steps, dispatches, slot_run,
               cli_argv):
    """Serving at mesh ``shape`` on this rank: per dispatch mode and prompt
    batch, ``generate``'s tokens, the same greedy run's logits
    (:func:`greedy_logits`) and ``generate``'s tokens again under
    ``REPRO_EXPERT_TP=0``; ``SlotServer`` over ``slot_run`` (its keyword
    arguments and request specs ``(uid, prompt, max_new)``) with the first
    dispatch mode; then ``launch.serve.main(cli_argv)``'s printout."""
    import contextlib
    import io
    import os

    from repro_torch.launch import serve
    from repro_torch.serving import Request, SlotServer, engine, generate
    torch.manual_seed(0)
    out = {}
    for dispatch in dispatches:
        model = _serve_model(shape, cfg, tree, dispatch)
        for name, p in prompts.items():
            prompt = torch.from_numpy(p).long()
            toks = generate(model, prompt, steps=steps).numpy()
            ref_toks, logits = greedy_logits(model, prompt, steps)
            os.environ["REPRO_EXPERT_TP"] = "0"
            try:
                no_tp = generate(model, prompt, steps=steps).numpy()
            finally:
                del os.environ["REPRO_EXPERT_TP"]
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
    import os

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
        os.environ["REPRO_FLASH"] = "1" if flash else "0"
        cfg = AttentionConfig(**fields)
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in inputs["params"].items()}
        xl = x[blk.rows, blk.seq].clone().requires_grad_(True)
        shard.row_gathers = 0
        y, _ = attention.full_attention(
            p, xl, cfg, positions=blk.positions(), causal=causal,
            window=window, q_chunk=q_chunk, block=blk)
        gathers = shard.row_gathers
        keys = sorted(p)
        grads = torch.autograd.grad((y * gy[blk.rows, blk.seq]).sum(),
                                    [xl] + [p[k] for k in keys])
        del os.environ["REPRO_FLASH"]
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
                    x.to(dt), mesh.model_group, n, dim, torch.float32
                ).numpy()
    finally:
        shard._PIECE_BYTES = default
    return out
