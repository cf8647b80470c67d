"""``experiments/torch_make_tables.py`` (the twin of
``experiments/make_tables.py``) over records that ``launch/dryrun.py``
writes: two pairs counted at smoke size on a 2x2 mesh (rwkv6's decode,
whose caches are cut over ``model``, and yi-6b's training) and one skip,
in a temporary records directory."""
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


def _record(arch, shape, mesh_shape):
    """``dryrun.run_pair``'s record, counted for ``arch``'s smoke config at
    ``shape`` on ``mesh_shape`` (labelled the production mesh, as the
    tables read it)."""
    rec = {"arch": arch, "shape": shape.name, "mesh": "16x16", "a2a": None,
           "dispatch": None}
    out = dryrun.count_pair(configs.smoke_config(arch), shape, mesh_shape)
    out.pop("plan")
    rec.update(out)
    rec["roofline"] = dryrun.roofline(rec)
    return rec


def test_tables_from_dry_run_records(tables, tmp_path, monkeypatch):
    """The dry-run table holds each counted pair's stored GiB by part, its
    model TFLOP a chip and its collectives, the roofline table its three
    terms, dominant term and bound, each in the reference's arch and
    shape order; a skipped pair shows its reason, a pair with no record
    MISSING; the counts close each table."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(tables, "DIR", str(tmp_path))
    ms = {"data": 2, "model": 2}
    recs = [_record("rwkv6-1.6b", ShapeConfig("decode_32k", 64, 4,
                                              "decode"), ms),
            _record("yi-6b", ShapeConfig("train_4k", 32, 4, "train"), ms)]
    for rec in recs:
        dryrun._save(rec)
    skip = dryrun.run_pair("hubert-xlarge", "decode_32k")
    assert "skipped" in skip
    order = [(a, s) for a in tables.ARCH_ORDER for s in tables.SHAPE_ORDER]
    for text, n_cells in (
            (tables.dryrun_table("16x16"), 8),
            (tables.roofline_table("16x16"), 5)):
        lines = text.splitlines()
        rows = lines[2:2 + len(order)]
        assert [tuple(x.split(" | ")[:2]) for x in rows] == [
            (f"| {a}", s) for a, s in order]
        assert all(x.count(" | ") == n_cells + 1 for x in rows
                   if "MISSING" not in x and "skip" not in x)
        assert "| hubert-xlarge | decode_32k | *skip: encoder-only" in text
        assert "| gemma2-9b | train_4k | MISSING |" in text
        assert "2 pairs" in lines[-1] and "1 documented skips" in lines[-1]
        for rec in recs:
            cells = rows[order.index((rec["arch"], rec["shape"]))].split(
                " | ")
            if n_cells == 8:
                st = rec["stored_bytes"]
                assert cells[2:7] == [tables.gib(st[k]) if k in st else "—"
                                      for k in tables.STORED]
                assert cells[8] == str(rec["collectives"]["count"])
            else:
                ro = rec["roofline"]
                assert cells[5] == f"**{ro['dominant'].replace('_s', '')}**"
                assert cells[6] == f"{ro['step_time_bound_s']:.2e} |"
    # rwkv6's caches a rank: its states cut over model, not by rows only
    whole = dryrun.count_pair(configs.smoke_config("rwkv6-1.6b"),
                              ShapeConfig("decode_32k", 64, 4, "decode"),
                              {"data": 2, "model": 1})
    assert recs[0]["stored_bytes"]["caches"] < whole["stored_bytes"][
        "caches"]
