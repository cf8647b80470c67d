"""Package rules of the port: no JAX in it, entry points that never fall
back to the CPU on their own, the config copies, and parameter
conversion that names what is wrong."""
import ast
import dataclasses
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs, resolve_device
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import ModelConfig
from repro_torch.launch import serve
from repro_torch.models.transformer import Transformer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "flash_ab.py", ROOT / "drhs_ab.py",
    ROOT / "gate_gather_ab.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {bad}"


def test_port_has_no_relative_imports():
    """Absolute ``repro_torch`` imports only, so the scan above sees all."""
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                assert node.level == 0, path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = configs.smoke_config("hetumoe-paper-16e")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run("hetumoe-paper-16e", smoke=True, batch=1, prompt_len=4,
                  gen=2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_raise_without_cuda(no_cuda):
    from repro_torch.core.config import TrainConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.training.train_step import init_train_state
    cfg = configs.smoke_config("hetumoe-paper-16e")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.run("hetumoe-paper-16e", steps=1, batch=1, seq=8, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLM(cfg, 1, 8)


def test_chip_smoke_fails_without_a_gpu_or_the_repo(tmp_path):
    """No result and a non-zero exit without CUDA — here, and in a
    directory that holds chip_smoke.py and nothing else."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_flash_ab_exits_without_a_gpu():
    """The A/B tool of the flash kernels builds and times nothing without
    CUDA: it exits 2 before it looks for nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would build and time")
    r = subprocess.run([sys.executable, str(ROOT / "flash_ab.py"),
                        "a.cu", "b.cu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and "no GPU" in r.stderr


def test_drhs_ab_exits_without_a_gpu():
    """The A/B tool of the grouped drhs kernel likewise exits 2 without
    CUDA, before it looks for nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would build and time")
    r = subprocess.run([sys.executable, str(ROOT / "drhs_ab.py"),
                        "a.cu", "b.cu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and "no GPU" in r.stderr


def test_gate_gather_ab_exits_without_a_gpu():
    """The A/B tool of the gate and the gather likewise exits 2 without
    CUDA, before it looks for nvcc."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would build and time")
    r = subprocess.run([sys.executable, str(ROOT / "gate_gather_ab.py"),
                        "a", "b"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and "no GPU" in r.stderr


def test_presets_copy_the_reference():
    """The port's preset and smoke reduction equal the reference's, field
    by field, except that the port turns its kernels on."""
    name = "hetumoe-paper-16e"
    for get in ("get_config", "smoke_config"):
        t = getattr(configs, get)(name)
        j = getattr(jconfigs, get)(name)
        assert t.moe.use_pallas_gate and not j.moe.use_pallas_gate
        assert dataclasses.asdict(t.moe) == dataclasses.asdict(
            dataclasses.replace(j.moe, use_pallas_gate=True))
        assert dataclasses.asdict(t.attention) == dataclasses.asdict(
            j.attention)
        for f in dataclasses.fields(t):
            if f.name not in ("moe", "attention"):
                assert getattr(t, f.name) == getattr(j, f.name), f.name
    with pytest.raises(KeyError, match="rwkv6-1.6b.*zamba2-7b"):
        configs.get_config("no-such-arch")


def test_model_config_rejects_malformed():
    with pytest.raises(ValueError, match="not divisible"):
        ModelConfig(name="x", family="moe", num_layers=3, d_model=8, d_ff=8,
                    vocab_size=8, block_pattern=("moe", "moe"))
    with pytest.raises(ValueError, match="needs MoEConfig"):
        configs.smoke_config("hetumoe-paper-16e").replace(moe=None)
    with pytest.raises(ValueError, match="needs RWKVConfig"):
        configs.smoke_config("hetumoe-paper-16e").replace(
            block_pattern=("moe", "rwkv"))
    with pytest.raises(ValueError, match="needs SSMConfig"):
        configs.smoke_config("hetumoe-paper-16e").replace(
            block_pattern=("moe", "mamba_sa"))
    with pytest.raises(ValueError, match="needs AttentionConfig"):
        configs.smoke_config("zamba2-7b").replace(attention=None)
    with pytest.raises(ValueError, match="unknown block kinds"):
        Transformer(configs.smoke_config("hetumoe-paper-16e").replace(
            block_pattern=("moe", "ssm")), device="cpu")


@pytest.fixture(scope="module")
def tree():
    cfg = jconfigs.smoke_config("hetumoe-paper-16e")
    return jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(0), cfg))


def test_params_from_numpy_splits_layers(tree):
    cfg = configs.smoke_config("hetumoe-paper-16e")
    p = params_from_numpy(tree, cfg)
    assert len(p["blocks"]) == cfg.num_layers
    for layer in range(cfg.num_layers):
        np.testing.assert_array_equal(
            p["blocks"][layer]["moe"]["w_up"].numpy(),
            tree["blocks"][0]["moe"]["w_up"][layer])


@pytest.mark.parametrize("mutate,needle", [
    (lambda t: t["blocks"][0]["attn"].pop("wq"), "missing keys ['blocks/0/attn/wq']"),
    (lambda t: t.update(extra=np.zeros(3)), "unexpected keys ['extra']"),
    (lambda t: t.update(final_norm=np.zeros(7)), "final_norm: (7,) != (128,)"),
])
def test_params_from_numpy_names_what_is_wrong(tree, mutate, needle):
    cfg = configs.smoke_config("hetumoe-paper-16e")
    t = {**tree, "blocks": ({**tree["blocks"][0],
                             "attn": dict(tree["blocks"][0]["attn"])},)}
    mutate(t)
    with pytest.raises(ValueError) as e:
        params_from_numpy(t, cfg)
    assert needle in str(e.value)
