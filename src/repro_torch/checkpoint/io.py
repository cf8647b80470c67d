"""Crash-safe checkpointing — the port of ``repro/checkpoint/io.py``, in
its format.

One ``ckpt_<step:08d>.npz`` per save with ``/``-joined keys, then a
per-step manifest ``ckpt_<step:08d>.json`` carrying per-leaf CRC32
checksums (over the raw bytes, seeded with dtype and shape;
``FORMAT_VERSION = 2``), then ``manifest.json``, the latest-pointer.  A
port ``TrainState`` is saved under the keys the reference gives its own
(``convert.state_to_numpy``: blocks stacked over super-blocks), so a
checkpoint written by the JAX trainer restores in the port and the
reverse; any other tree (nested dicts, lists, tuples of tensors or
arrays) flattens as the reference flattens it.

Crash safety (a preempted worker must NEVER leave the run unrestorable):

* every file is written **atomically** — tmp file, flush + fsync,
  ``os.replace`` — so a kill mid-write leaves at worst a stray ``.tmp``;
  the npz is written straight into its tmp file (the reference builds it
  in memory first: the same bytes, three times the state in host RAM);
* :func:`restore_checkpoint` walks per-step manifests newest-first and
  returns the newest checkpoint that is *intact* (loads cleanly, has
  exactly the manifest's keys, checksums match) — a corrupt or truncated
  latest falls back to the previous one instead of crashing the resume;
* ``keep`` retains only the last K checkpoints (never the newest), and a
  directory holding only a legacy ``manifest.json`` still restores.

Deterministic kill/crash points for the fault harness
(``core/faults.py``, indexed by step): ``ckpt.data_tmp_written``,
``ckpt.data_replaced``, ``ckpt.manifest_step_written``.
"""
from __future__ import annotations

import glob
import json
import os
import re
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import faults as faults_mod
from repro_torch.core.config import ModelConfig
from repro_torch.training.train_step import TrainState

FORMAT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is unreadable, truncated, or fails its checksum."""


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``/``-joined paths → leaves, as ``jax.tree_util`` names them: dict
    keys sorted, sequence indices, a NamedTuple's fields as ``.name``."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _flat_arrays(state, cfg: Optional[ModelConfig]) -> Dict[str, np.ndarray]:
    if isinstance(state, TrainState):
        if cfg is None:
            raise ValueError("a TrainState is saved and restored under the "
                             "reference's stacked keys: pass cfg=")
        return convert.state_to_numpy(state, cfg)
    return {k: _to_numpy(v) for k, v in _flatten(state).items()}


def _checksum(arr: np.ndarray) -> int:
    """CRC32 over raw bytes + dtype/shape (catches silent reinterpretation);
    the bytes are read in place, not copied."""
    meta = f"{arr.dtype.str}{arr.shape}".encode()
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(raw, zlib.crc32(meta))


def _atomic_write(path: str, write, *, crash_site: Optional[str] = None,
                  crash_index: int = 0) -> None:
    """``write(f)`` into ``path + ".tmp"``, flush + fsync, then (after the
    crash point) ``os.replace`` onto ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    if crash_site is not None:
        faults_mod.crash_point(crash_site, crash_index)
    os.replace(tmp, path)


def _npz_path(direc: str, step: int) -> str:
    return os.path.join(direc, f"ckpt_{step:08d}.npz")


def _manifest_path(direc: str, step: int) -> str:
    return os.path.join(direc, f"ckpt_{step:08d}.json")


def save_checkpoint(direc: str, state, step: int,
                    keep: Optional[int] = None, *,
                    cfg: Optional[ModelConfig] = None) -> str:
    """Atomically save ``state``; returns the ``.npz`` path.  A port
    ``TrainState`` needs its ``cfg`` (its keys are the reference's).

    ``keep`` prunes all but the newest K checkpoints (and stray ``.tmp``
    leftovers from killed saves)."""
    os.makedirs(direc, exist_ok=True)
    flat = _flat_arrays(state, cfg)
    path = _npz_path(direc, step)
    # data first (atomic): a kill before the manifests leaves an orphan
    # .npz that restore simply never considers.
    _atomic_write(path, lambda f: np.savez(f, **flat),
                  crash_site="ckpt.data_tmp_written", crash_index=step)
    faults_mod.crash_point("ckpt.data_replaced", step)
    manifest = {
        "format": FORMAT_VERSION,
        "step": step,
        "latest": os.path.basename(path),
        "keys": sorted(flat.keys()),
        "checksums": {k: _checksum(v) for k, v in flat.items()},
    }
    mdata = json.dumps(manifest, indent=1).encode()
    # per-step manifest (the restore candidates), then the latest-pointer
    _atomic_write(_manifest_path(direc, step), lambda f: f.write(mdata))
    faults_mod.crash_point("ckpt.manifest_step_written", step)
    _atomic_write(os.path.join(direc, "manifest.json"),
                  lambda f: f.write(mdata))
    if keep is not None:
        _prune(direc, keep)
    return path


def _prune(direc: str, keep: int) -> None:
    for tmp in glob.glob(os.path.join(direc, "*.tmp")):
        try:
            os.remove(tmp)
        except OSError:
            pass
    for step, _ in list_checkpoints(direc)[max(keep, 1):]:
        for p in (_npz_path(direc, step), _manifest_path(direc, step)):
            try:
                os.remove(p)
            except OSError:
                pass


def list_checkpoints(direc: str) -> List[Tuple[int, Dict]]:
    """(step, manifest) candidates, newest first.  Per-step manifests are
    authoritative; a legacy dir with only ``manifest.json`` still lists
    its single entry.  Unparseable manifests are skipped (a torn manifest
    must not block restore of an older checkpoint)."""
    out: List[Tuple[int, Dict]] = []
    seen = set()
    for mp in glob.glob(os.path.join(direc, "ckpt_*.json")):
        m = re.fullmatch(r"ckpt_(\d+)\.json", os.path.basename(mp))
        if not m:
            continue
        try:
            with open(mp) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue
        out.append((int(m.group(1)), manifest))
        seen.add(int(m.group(1)))
    legacy = os.path.join(direc, "manifest.json")
    if os.path.exists(legacy):
        try:
            with open(legacy) as f:
                manifest = json.load(f)
            if manifest.get("step") not in seen:
                out.append((manifest["step"], manifest))
        except (OSError, ValueError, KeyError):
            pass
    return sorted(out, key=lambda t: t[0], reverse=True)


def latest_step(direc: str) -> Optional[int]:
    """Newest candidate step, or None when the dir holds no checkpoints
    (missing dir included) — the ``--resume`` probe."""
    if not os.path.isdir(direc):
        return None
    cands = list_checkpoints(direc)
    return cands[0][0] if cands else None


def _load_verified(direc: str, manifest: Dict) -> Dict[str, np.ndarray]:
    """Load the manifest's ``.npz`` and verify keys + checksums; any
    failure mode (missing/truncated/bit-rotted file, zip errors, checksum
    mismatch) raises :class:`CheckpointCorruptError`."""
    latest = manifest["latest"]
    path = latest if os.path.isabs(latest) else os.path.join(direc, latest)
    try:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    except Exception as e:  # zipfile.BadZipFile, OSError, EOFError, ValueError…
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is unreadable ({type(e).__name__}: {e})")
    want = set(manifest.get("keys", arrays.keys()))
    if set(arrays) != want:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} keys disagree with its manifest: "
            f"missing {sorted(want - set(arrays))[:5]}, "
            f"unexpected {sorted(set(arrays) - want)[:5]}")
    sums = manifest.get("checksums")
    if sums:
        bad = [k for k, a in arrays.items()
               if k in sums and _checksum(a) != sums[k]]
        if bad:
            raise CheckpointCorruptError(
                f"checkpoint {path!r} failed checksum verification for "
                f"{len(bad)} leaves (first: {sorted(bad)[:3]})")
    return arrays


def _template_keys(template, cfg: Optional[ModelConfig]) -> Dict[str, Any]:
    if isinstance(template, TrainState):
        if cfg is None:
            raise ValueError("a TrainState is saved and restored under the "
                             "reference's stacked keys: pass cfg=")
        return convert.state_keys(cfg)
    return _flatten(template)


def _rebuild(template, arrays: Dict[str, np.ndarray], prefix: str = ""):
    """``template``'s structure with each leaf taken from ``arrays`` in the
    leaf's dtype (and on its device, for a tensor)."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], arrays,
                            f"{prefix}/{k}" if prefix else str(k))
                for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _rebuild(getattr(template, f), arrays,
                     f"{prefix}/.{f}" if prefix else "." + f)
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, arrays,
                                       f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    a = arrays[prefix]
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(dtype=template.dtype,
                                                device=template.device)
    return np.asarray(a).astype(np.asarray(template).dtype)


def restore_checkpoint(direc: str, state_template, *, fallback: bool = True,
                       cfg: Optional[ModelConfig] = None):
    """Restore into the structure of ``state_template`` → (state, step).
    A port ``TrainState`` template needs its ``cfg``; the state comes back
    on the template's device (``convert.state_from_numpy``).

    Walks candidates newest-first; a corrupt/truncated checkpoint is
    skipped (with a warning) in favour of the newest *intact* one unless
    ``fallback=False``.  Raises :class:`CheckpointCorruptError` when no
    candidate survives, FileNotFoundError when the dir has none at all,
    and ValueError when an intact checkpoint's keys don't match the
    template (wrong model — missing and unexpected keys named separately).
    """
    candidates = list_checkpoints(direc)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint manifests under {direc!r}")
    errors: List[str] = []
    for step, manifest in candidates:
        try:
            arrays = _load_verified(direc, manifest)
        except CheckpointCorruptError as e:
            errors.append(str(e))
            if not fallback:
                raise
            print(f"checkpoint: step {step} corrupt, falling back ({e})")
            continue
        flat_tpl = _template_keys(state_template, cfg)
        missing = sorted(set(flat_tpl) - set(arrays))
        unexpected = sorted(set(arrays) - set(flat_tpl))
        if missing or unexpected:
            raise ValueError(
                f"checkpoint step {step} does not match the restore "
                f"template: missing keys {missing[:10]} "
                f"(+{max(len(missing) - 10, 0)} more), unexpected keys "
                f"{unexpected[:10]} (+{max(len(unexpected) - 10, 0)} more)")
        if isinstance(state_template, TrainState):
            dev = state_template.step.device
            return convert.state_from_numpy(arrays, cfg, device=dev), step
        return _rebuild(state_template, arrays), step
    raise CheckpointCorruptError(
        f"no intact checkpoint under {direc!r}; tried {len(candidates)} "
        f"candidate(s): " + "; ".join(errors))
