"""``experiments/torch_make_tables.py`` (the twin of
``experiments/make_tables.py``) over records that ``launch/dryrun.py``
writes: two pairs counted and executed at smoke size on a 2x2 mesh
(rwkv6's decode, whose caches are cut over ``model``, and yi-6b's
training), one counted only, and one skip, in a temporary records
directory; and ``compare`` of tagged records against untagged ones."""
import importlib.util
import pathlib

import pytest

from repro_torch import configs
from repro_torch.core.config import ShapeConfig
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tables():
    spec = importlib.util.spec_from_file_location(
        "torch_make_tables", ROOT / "experiments" / "torch_make_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(arch, shape, mesh_shape, execute=True):
    """``dryrun.run_pair``'s record, counted (and with ``execute``
    executed) for ``arch``'s smoke config at ``shape`` on ``mesh_shape``
    (labelled the production mesh, as the tables read it)."""
    rec = {"arch": arch, "shape": shape.name, "mesh": "16x16", "a2a": None,
           "dispatch": None}
    cfg = configs.smoke_config(arch)
    out = dryrun.count_pair(cfg, shape, mesh_shape)
    out.pop("plan")
    rec.update(out)
    if execute:
        ran = dryrun.execute_pair(cfg, shape, mesh_shape, fsdp=rec["fsdp"],
                                  expert_tp=rec["expert_tp"])
        rec.update(memory_analysis=ran["memory_analysis"],
                   op_analysis=ran["op_analysis"])
    else:
        rec["not_executed"] = dryrun.POD_REASON
    rec["roofline"] = dryrun.roofline(rec)
    return rec


def test_tables_from_dry_run_records(tables, tmp_path, monkeypatch):
    """The dry-run table holds each counted pair's stored GiB by part, its
    model TFLOP a chip and its collectives, the roofline table its three
    terms, dominant term and bound and the reference's executed columns
    (mem/dev GiB, executed TFLOP/dev, useful fraction; "not executed"
    for a record counted only), each in the reference's arch and shape
    order; a skipped pair shows its reason, a pair with no record
    MISSING; the counts close each table."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(tables, "DIR", str(tmp_path))
    ms = {"data": 2, "model": 2}
    recs = [_record("rwkv6-1.6b", ShapeConfig("decode_32k", 64, 4,
                                              "decode"), ms),
            _record("yi-6b", ShapeConfig("train_4k", 32, 4, "train"), ms),
            _record("starcoder2-3b", ShapeConfig("prefill_32k", 32, 4,
                                                 "prefill"), ms,
                    execute=False)]
    for rec in recs:
        dryrun._save(rec)
    skip = dryrun.run_pair("hubert-xlarge", "decode_32k")
    assert "skipped" in skip
    order = [(a, s) for a in tables.ARCH_ORDER for s in tables.SHAPE_ORDER]
    for text, n_cells, stored in (
            (tables.dryrun_table("16x16"), 8, True),
            (tables.roofline_table("16x16"), 8, False)):
        lines = text.splitlines()
        rows = lines[2:2 + len(order)]
        assert [tuple(x.split(" | ")[:2]) for x in rows] == [
            (f"| {a}", s) for a, s in order]
        assert all(x.count(" | ") == n_cells + 1 for x in rows
                   if "MISSING" not in x and "skip" not in x)
        assert "| hubert-xlarge | decode_32k | *skip: encoder-only" in text
        assert "| gemma2-9b | train_4k | MISSING |" in text
        assert "3 pairs" in lines[-1] and "1 documented skips" in lines[-1]
        for rec in recs:
            cells = rows[order.index((rec["arch"], rec["shape"]))].split(
                " | ")
            if stored:
                st = rec["stored_bytes"]
                assert cells[2:7] == [tables.gib(st[k]) if k in st else "—"
                                      for k in tables.STORED]
                assert cells[8] == str(rec["collectives"]["count"])
            else:
                ro = rec["roofline"]
                assert cells[5] == f"**{ro['dominant'].replace('_s', '')}**"
                assert cells[6] == f"{ro['step_time_bound_s']:.2e}"
                if "not_executed" in rec:
                    assert cells[7:] == [tables.NOT_RUN] * 2 + [
                        tables.NOT_RUN + " |"]
                    continue
                ma, oa = rec["memory_analysis"], rec["op_analysis"]
                assert cells[7:] == [
                    tables.gib(ma["peak_per_device_bytes"]),
                    f"{oa['flops'] / 1e12:.2f}",
                    f"{min(ro['useful_fraction'], 9.99):.2f} |"]
    # rwkv6's caches a rank: its states cut over model, not by rows only
    whole = dryrun.count_pair(configs.smoke_config("rwkv6-1.6b"),
                              ShapeConfig("decode_32k", 64, 4, "decode"),
                              {"data": 2, "model": 1})
    assert recs[0]["stored_bytes"]["caches"] < whole["stored_bytes"][
        "caches"]


def test_compare_tagged_records(tables, tmp_path, monkeypatch):
    """``compare`` sets each pair's bound in the records tagged ``TAG``
    beside the untagged ones', with the dominant terms and their ratio,
    and leaves out a pair missing on either side."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(tables, "DIR", str(tmp_path))
    ms = {"data": 2, "model": 2}
    shape = ShapeConfig("train_4k", 32, 4, "train")
    new = _record("yi-6b", shape, ms)
    dryrun._save(new)
    base = dict(new, roofline=dict(
        new["roofline"],
        step_time_bound_s=2 * new["roofline"]["step_time_bound_s"]))
    dryrun._save(base, "baseline")
    dryrun._save(_record("starcoder2-3b", shape, ms), "baseline")
    text = tables.compare("16x16", "baseline")
    lines = text.splitlines()
    assert lines[0].startswith("| arch | shape | baseline bound s (dom) |")
    assert len(lines) == 3                  # starcoder2 has no new record
    dom = new["roofline"]["dominant"].replace("_s", "")
    b = new["roofline"]["step_time_bound_s"]
    assert lines[2] == (f"| yi-6b | train_4k | {2 * b:.2e} ({dom}) | "
                        f"{b:.2e} ({dom}) | 2.00× |")
    out = []
    monkeypatch.setattr("builtins.print", lambda *a: out.append(a))
    tables.main(["--compare", "baseline"])
    assert (text,) in out
