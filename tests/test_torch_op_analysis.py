"""The executed-program analysis (``launch/op_analysis.py``, the twin of
``repro/launch/hlo_analysis.py``), the kernel wrappers' fake route and
cost formulas, and ``launch/dryrun.execute_pair``: one rank's step run on
fake tensors over a fake process group.

The analyzer on hand-built op graphs; each wrapper's formula at the
shapes ``PERF.md``'s kernel table bounds (kernel 3: 50.08 us, kernel 7:
40.22 us by bytes and 55.37 us by its own tile products); the fake route
taken by ``FakeTensor`` operands only; ``execute_pair`` at 2x2 and 1x4
smoke meshes, train and decode, whose logged collectives equal
``count_pair``'s plan and whose stored arguments equal its bytes, and at
16x16 through ``run_pair``; the executed matmul FLOPs of a dense smoke
forward equal to the reference's ``hlo_analysis.analyze`` on the same
config; the memory tracker's peak of a step on real CPU tensors equal to
its peak on fake ones."""
import collections
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch_ranks
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro import configs as jconfigs
from repro.launch import hlo_analysis
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.analysis import OpGraph, OpSite, trace_graph
from repro_torch.core import alltoall
from repro_torch.core.config import ShapeConfig, TrainConfig
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import grouped_ffn as G
from repro_torch.kernels import layout_transform as L
from repro_torch.kernels import topk_gate as K
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as T

torch.set_num_threads(1)

TRAIN = ShapeConfig("train_4k", 64, 8, "train")
DECODE = ShapeConfig("decode_32k", 64, 8, "decode")


def _aten(op, ins, outs, dtype="float32", stack=(), view=False):
    return OpSite(op, "aten", "fwd", stack, (dtype,) * len(ins), ins,
                  (dtype,) * len(outs), outs, view=view)


def test_analyzer_on_hand_built_graphs():
    """mm FLOPs 2MNK and operand + result bytes; a view and an aliasing
    op move nothing; the plain version's ops under a wrapper are its
    inside (the wrapper's formula counts instead); collectives by kind
    at ``Collective.wire_bytes``."""
    k = ops.KernelCall("grouped_matmul", ("bfloat16", "bfloat16", "int32"),
                       ((64, 32), (4, 32, 16), (5,)))
    sites = [
        _aten("aten.mm", ((8, 16), (16, 4)), ((8, 4),)),
        _aten("aten.view", ((8, 4),), ((32,),)),
        _aten("aten.to", ((8, 4),), ((8, 4),), view=True),
        OpSite("grouped_matmul", "kernel", "fwd", (), k.dtypes, k.shapes),
        _aten("aten.mm", ((64, 32), (32, 16)), ((64, 16),),
              stack=("grouped_matmul",)),
        OpSite("all_gather", "collective", "fwd", (), ("bfloat16",),
               ((4, 8),), axis="data", n=4),
        OpSite("all_to_all", "collective", "bwd", (), ("float32",),
               ((2, 8),), ("float32",), ((2, 8),), "model", 2),
    ]
    got = op_analysis.analyze(OpGraph(sites))
    cost = G.matmul_cost(k)
    assert got["flops"] == 2 * 8 * 16 * 4 + 2 * 64 * 32 * 16
    assert got["hbm_bytes"] == (8 * 16 + 16 * 4 + 8 * 4) * 4 + cost.bytes
    assert cost.bytes == (64 * 32 + 4 * 32 * 16 + 64 * 16) * 2 + 5 * 4
    assert got["launches"] == {"aten.mm": 1, "grouped_matmul": 1}
    assert got["kernels"]["grouped_matmul"]["launches"] == 1
    assert [u["op"] for u in got["traffic_top"]] == [
        "fwd/grouped_matmul", "fwd/aten.mm"]
    co = got["collectives"]
    want = {"all_gather": 3 * 4 * 8 * 2, "all_to_all": 2 * 8 * 4 / 2}
    assert co["bytes_by_kind"] == want and co["count"] == 2
    assert co["total_wire_bytes"] == sum(want.values())


def test_einsum_and_inference_matmul_flops():
    """``matmul``, ``linear`` and ``einsum`` reach the recorder whole under
    ``inference_mode``; their FLOPs are the decomposed products'."""
    a, b = torch.randn(2, 3, 8), torch.randn(8, 5)
    w = torch.randn(5, 8)
    q, k = torch.randn(2, 4, 3, 8), torch.randn(2, 6, 3, 8)

    def fn():
        return (a @ b, torch.nn.functional.linear(a, w),
                torch.einsum("bqhd,bkhd->bhqk", q, k))
    with torch.inference_mode():
        g = trace_graph(fn)
    got = op_analysis.analyze(g)["flops"]
    assert got == 2 * (2 * 3 * 8 * 5) * 2 + 2 * 2 * 4 * 6 * 3 * 8
    assert op_analysis.einsum_flops("skc,sk,cd->sd",
                                    [(4, 2, 3), (4, 2), (3, 5)]) == (
        2 * 4 * 2 * 3 + 2 * 4 * 3 * 5)


def test_formulas_reproduce_the_kernel_table():
    """Kernel 3 (bf16, M=4096, K=N=2048, E=16): 167,772,160 B of operands
    and output plus the 68 B of offsets phase 5 counts, 50.08 us by
    bytes.  Kernel 7 (B=8, S=1024, H=16, d=128, causal): 40.22 us by
    bytes, 55.37 us by its own products over the 136 k tiles it
    visits."""
    gm = G.matmul_cost(ops.KernelCall(
        "grouped_matmul", ("bfloat16", "bfloat16", "int32"),
        ((4096, 2048), (16, 2048, 2048), (17,))))
    assert gm.bytes == 167_772_160 + 68
    assert round(1e6 * gm.bytes / ops.HBM_BW, 2) == 50.08
    assert round(1e6 * gm.bound_s, 2) == 50.08
    q = (8, 16, 1024, 128)
    fwd = F.fwd_cost(ops.KernelCall(
        "flash_fwd", ("bfloat16",) * 3 + ("int32",) * 2,
        (q, q, q, (1024,), (1024,)), (128 ** -0.5, True, None, None)))
    assert round(1e6 * fwd.bytes / ops.HBM_BW, 2) == 40.22
    assert round(1e6 * fwd.flops / ops.BF16_FLOPS, 2) == 55.37
    assert F.aligned_tiles(1024, 1024, True, None, F.GROUP) * F.GROUP \
        / F.TILE == 136


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (1024, 1024, True, None), (1000, 1000, True, 100), (600, 600, False,
                                                        None),
    (256, 1024, True, None), (300, 2000, True, 700), (64, 64, True, 1)])
def test_aligned_tiles_are_the_kernels_plans(Sq, Sk, causal, window):
    """On contiguous positions (the queries the last Sq of Sk) the
    analytic tile counts equal the plain twins of the kernels' plans:
    ``visited_k_tiles`` (groups of 16 queries in bf16, 64 in f32) and the
    visited entries of ``visited_q_tiles`` (tiles of 64), which then has
    no ``DV_ONLY``."""
    kp = torch.arange(Sk, dtype=torch.int32)
    qp = kp[Sk - Sq:]
    kt = F.visited_k_tiles(qp, kp, causal, window)
    codes = F.visited_q_tiles(qp, kp, causal, window)
    assert F.aligned_tiles(Sq, Sk, causal, window, F.GROUP) == int(kt.sum())
    assert F.aligned_tiles(Sq, Sk, causal, window, F.TILE) == int(
        F.visited_k_tiles(qp, kp, causal, window, rows=F.TILE).sum())
    assert F.aligned_tiles(Sq, Sk, causal, window, F.TILE) == int(
        (codes > 0).sum())
    assert not bool((codes == F.DV_ONLY).any())


def _wrapper_calls(gen, fake: bool):
    """Each of the ten wrappers once, on tensors made here: real CPU ones,
    or fake ones under ``FakeTensorMode``."""
    def r(*shape, dtype=torch.float32):
        if fake:
            return torch.empty(shape, dtype=dtype)
        return torch.randn(shape, generator=gen).to(dtype)
    idx = torch.tensor([2, -1, 0, 1], dtype=torch.int32)
    offs = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    pos = torch.arange(16, dtype=torch.int32)
    q, k, v, do = (r(1, 2, 16, 16) for _ in range(4))
    lse, delta = r(1, 2, 16), r(1, 2, 16)
    st = (0.25, True, None, None)
    return {
        "topk_gate": K.fused_topk_gate(r(4, 6), 2),
        "gather_rows": L.gather_rows(r(3, 8), idx),
        "scatter_add": L.scatter_add_rows(r(4, 8), idx, 3),
        "gather_rows_rowstep": L.gather_rows_rowstep(r(3, 8), idx),
        "grouped_matmul": G.grouped_matmul(r(4, 8), r(3, 8, 5), offs),
        "grouped_matmul_t": G.grouped_matmul_t(r(4, 5), r(3, 8, 5), offs),
        "grouped_drhs": G.grouped_drhs(r(4, 8), r(4, 5), offs),
        "flash_fwd": F.flash_fwd(q, k, v, pos, pos, *st),
        "flash_dq": F.flash_dq(q, k, v, do, lse, delta, pos, pos, *st),
        "flash_dkv": F.flash_dkv(q, k, v, do, lse, delta, pos, pos, *st),
    }


def test_fake_route_only_for_fake_tensors(monkeypatch):
    """Under ``FakeTensorMode`` every wrapper returns fake outputs of the
    card route's shapes and dtypes without a launch (the counters stay
    put) and stays logged; on real CPU tensors no call reaches the fake
    route and each wrapper gives its plain version's result."""
    seen = []
    real_is_fake = build.is_fake

    def spy(t):
        got = real_is_fake(t)
        seen.append((type(t), got))
        return got
    monkeypatch.setattr(build, "is_fake", spy)
    gen = torch.Generator().manual_seed(0)
    before = ops.launch_counts()
    ops.calls = []
    try:
        real = _wrapper_calls(gen, fake=False)
        assert not any(got for _, got in seen)
        n_real = len(ops.calls)
        seen.clear()
        with FakeTensorMode():
            fake = _wrapper_calls(gen, fake=True)
        names = [c.name for c in ops.calls]
    finally:
        ops.calls = None
    assert ops.launch_counts() == before
    assert seen and all(got for _, got in seen)
    assert all(issubclass(t, FakeTensor) for t, _ in seen)
    assert names[:n_real] == names[n_real:] and len(names) == 2 * n_real
    assert set(names) == set(ops.COSTS)
    for name, out in fake.items():
        outs = out if isinstance(out, tuple) else (out,)
        want = real[name] if isinstance(real[name], tuple) else (real[name],)
        for f, w in zip(outs, want, strict=True):
            assert isinstance(f, FakeTensor) and not isinstance(w,
                                                                FakeTensor)
            assert (f.shape, f.dtype) == (w.shape, w.dtype), name


def _smoke(arch, **moe):
    cfg = configs.smoke_config(arch)
    if moe:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


CELLS = [("hetumoe-paper-16e", TRAIN, {"dispatch": "grouped"}),
         ("dbrx-132b", DECODE, {"dispatch": "grouped"})]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch,shape,moe", CELLS,
                         ids=[f"{a}-{s.mode}" for a, s, _ in CELLS])
def test_execute_pair_matches_the_plan(arch, shape, moe, mesh):
    """The executed step's logged collectives equal ``count_pair``'s plan
    field by field, its stored state (params and moments, or params and
    caches) equals the plan's bytes; the batch argument is the global
    batch every rank is given; the memory keys add up and the process is
    left with no group and its excepthook."""
    cfg = _smoke(arch, **moe)
    ms = {"data": mesh[0], "model": mesh[1]}
    plan = dryrun.count_pair(cfg, shape, ms)
    hook = sys.excepthook
    ran = dryrun.execute_pair(cfg, shape, ms, fsdp=plan["fsdp"],
                              expert_tp=plan["expert_tp"])
    assert not dist.is_initialized() and sys.excepthook is hook
    assert collections.Counter(ran["log"]) == plan["plan"].log()
    assert ran["collectives"] == plan["collectives"]
    st, args = plan["stored_bytes"], ran["arguments"]
    for part in ("params", "opt", "caches"):
        assert args.get(part) == st.get(part), part
    ma = ran["memory_analysis"]
    assert ma["peak_per_device_bytes"] == (
        ma["argument_bytes"] + ma["temp_bytes"] + ma["output_bytes"]
        - ma["alias_bytes"])
    assert ma["argument_bytes"] >= sum(args.values()) and ma[
        "temp_bytes"] > 0
    if shape.mode == "decode":
        assert ma["alias_bytes"] >= args["caches"]       # written in place
        assert "grouped_matmul" in ran["op_analysis"]["kernels"]
    else:
        assert args["batch"] == 3 * shape.global_batch * shape.seq_len * 4
        k = ran["op_analysis"]["kernels"]
        assert {"grouped_matmul_t", "grouped_drhs"} <= set(k)


@pytest.mark.parametrize("arch,shape", [("hetumoe-paper-16e", "train_4k"),
                                        ("dbrx-132b", "decode_32k")])
def test_production_pair_at_16x16(arch, shape, tmp_path, monkeypatch):
    """``run_pair`` at 16x16 executes the pair (256 fake ranks, one
    process): the record holds the reference's memory keys and the
    executed analysis, its collectives (equal to the plan's, or it
    raises) and a roofline whose compute and memory terms are executed
    FLOPs and bytes a rank, with the useful fraction."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    rec = dryrun.run_pair(arch, shape)
    assert set(rec["memory_analysis"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_per_device_bytes"}
    oa, ro = rec["op_analysis"], rec["roofline"]
    assert {"flops", "hbm_bytes", "traffic_top", "launches"} <= set(oa)
    assert ro["compute_s"] == oa["flops"] / dryrun.PEAK_FLOPS
    assert ro["memory_s"] == oa["hbm_bytes"] / dryrun.HBM_BW
    assert ro["executed_flops_total"] == oa["flops"] * 256
    assert ro["useful_fraction"] == rec["model_flops"] / ro[
        "executed_flops_total"]
    assert oa["collectives"]["count"] == rec["collectives"]["count"]
    assert (tmp_path / f"{arch}__{shape}__16x16.json").exists()


@pytest.mark.parametrize("arch", ["yi-6b", "starcoder2-3b"])
def test_dense_forward_flops_equal_the_references(arch):
    """The executed matmul FLOPs of a dense smoke forward and its logits
    (B=2, S=32) equal, exactly, the reference's ``hlo_analysis`` of the
    same config's compiled forward: the same products on both sides."""
    B, S = 2, 32
    jcfg = jconfigs.smoke_config(arch)
    params = jax.eval_shape(lambda r: JT.init_model(r, jcfg),
                            jax.random.key(0))

    def fwd(p, x):
        h, _, _ = JT.forward(p, x, jcfg)
        return JT.logits_from_hidden(p, jcfg, h)
    txt = jax.jit(fwd).lower(params, jax.ShapeDtypeStruct(
        (B, S), jnp.int32)).compile().as_text()
    cfg = configs.smoke_config(arch)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.zeros((B, S), dtype=torch.int32)

    def run():
        h, _, _ = T.forward(p, tok, cfg)
        return T.logits_from_hidden(p, cfg, h)
    with torch.no_grad():
        got = op_analysis.analyze(trace_graph(run))["flops"]
    assert got == hlo_analysis.analyze(txt)["flops"]


def test_tracker_peak_real_equals_fake():
    """One dense smoke train step (no kernel wrapper on its path) on real
    CPU tensors and on fake ones: the memory tracker reports the same
    keys to the byte."""
    cfg = configs.smoke_config("yi-6b")
    shape = ShapeConfig("train_4k", 32, 2, "train")
    tcfg = TrainConfig()

    def measure():
        fn, args, _, _ = dryrun._train_run(cfg, tcfg, shape, None, "cpu",
                                           False)
        with op_analysis.MemoryTracker(args) as mt:
            out = fn()
        return mt.report(out)
    real = measure()
    with FakeTensorMode():
        fake = measure()
    assert real == fake and real["temp_bytes"] > 0


def test_fake_world_leaves_the_process_as_found(tmp_path):
    """``fake_world`` refuses a process that has a group, puts back the
    excepthook and leaves no group; gloo ranks spawn after it; the
    all-gather of a moved dim whose trailing dims have size 1 (Mamba's
    conv channels at one row) crosses as bytes (it raised before)."""
    hook, env = sys.excepthook, os.environ.get("REPRO_EXPERT_TP")
    with dryrun.fake_world(2, 0):
        x = torch.zeros(1, 1, 8, dtype=torch.bfloat16)
        out = alltoall.gather_dim(x, dist.group.WORLD, 2, 2, "model")
        assert out.shape == (1, 1, 16)
        with pytest.raises(RuntimeError, match="no process group"):
            with dryrun.fake_world(4, 0):
                pass
    dryrun.execute_pair(_smoke("dbrx-132b"), DECODE,
                        {"data": 1, "model": 2}, expert_tp=False)
    assert not dist.is_initialized() and sys.excepthook is hook
    assert os.environ.get("REPRO_EXPERT_TP") == env
    assert mesh_lib.spawn(torch_ranks.jobs_rank, 2, backend="gloo",
                          args=([],)) == [{}, {}]
