"""The examples' twins (``examples/torch_*.py``): each ``main`` runs at
``--device cpu`` from the port's entry points and prints what its
reference prints.  Small sizes only where the reference has a flag for
them (``--steps``, ``--gen``); the quickstart runs its 1x8 mesh of gloo
CPU ranks as written."""
import importlib
import json
import pathlib
import sys

import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: at the examples' CPU sizes a
    torch op is too small to share out, and the parallel test workers
    would otherwise contend for the cores with 8 threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    # the spawned ranks import the module by name: the examples directory
    # goes on the path they inherit
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def test_quickstart_flat_equals_hierarchical(capsys):
    _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "a2a=flat          out=(4, 128, 256)" in out
    assert "a2a=hierarchical  out=(4, 128, 256)" in out
    assert "flat == hierarchical ✓" in out


def test_gating_tour_prints_every_strategy(capsys):
    mod = _example("torch_gating_tour")
    mod.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("strategy")
    rows = {ln.split()[0]: ln for ln in lines[1:]}
    assert list(rows) == [name for name, _ in mod.STRATEGIES]
    for name, row in rows.items():
        k, drop = int(row.split()[1]), row.split()[-1]
        loads = json.loads(row[row.index("["):row.index("]") + 1])
        assert k == (2 if name in ("gshard", "topk", "ktop1", "sam",
                                   "dense_to_sparse") else 1)
        assert sum(loads) == 512 * k         # every assignment counted
        assert drop.endswith("%") and 0.0 <= float(drop[:-1]) <= 100.0
    assert rows["base"].split()[-1] == "0.0%"      # balanced by construction


def test_serve_batched_decodes(capsys):
    _example("torch_serve_batched").main(["--device", "cpu", "--gen", "4",
                                          "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "arch=dbrx-132b-smoke  batch=4" in out
    assert "decode  4 steps" in out
    toks = json.loads(out.split("continuations[0]:")[1])
    assert len(toks) == 4 and all(0 <= t < 512 for t in toks)


def test_train_moe_e2e_runs_and_unregisters(capsys):
    from repro_torch import configs
    _example("torch_train_moe_e2e").main(["--device", "cpu", "--steps", "3",
                                          "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert "arch=moe-e2e" in out and "loss " in out
    assert "moe-e2e" not in configs.ARCHS


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_gating_tour",
                                  "torch_serve_batched",
                                  "torch_train_moe_e2e"])
def test_examples_take_the_device_flag(name):
    with pytest.raises(SystemExit):
        _example(name).main(["--device", "tpu"])
