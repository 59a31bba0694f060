"""Checkpoint/restart for long-lived runs (a port of
``repro/checkpoint/store.py``), in the reference's on-disk format, so
either package restores the other's checkpoints.

What must survive is small and explicit: the consensus state (z, rho,
round) plus per-worker (x, u) and the optimizer state — or, for the
data-parallel baseline, the (params, opt) pair.

Format: one directory ``step_<step:08d>`` per step holding
  * ``arrays.npz``     — the leaves under keys ``leaf_<i>``, in
                         ``jax.tree_util.tree_flatten``'s order (dict keys
                         sorted, NamedTuple fields in order; ``tree.py``);
                         bfloat16 stored as its raw ``uint16`` bits (and
                         the float8 types as ``uint8``);
  * ``manifest.json``  — the structure (the reference writes its treedef
                         string, the port a description of its own:
                         neither reads it back), shapes, dtype names,
                         per-leaf sha256 of the raw bytes (a half-written
                         or bit-rotted restore fails loudly), user metadata.
Writes go to ``.step_<step>.tmp`` then ``os.replace`` (atomic on POSIX), so
a worker dying mid-save never corrupts the latest checkpoint.
``CheckpointManager`` adds rotation (keep_last) and an optional
background-thread save (the round loop does not block on disk).  Restore
needs no ``ml_dtypes``: raw bits are viewed as torch's own types.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import describe, flatten

Tree = Any

# torch dtypes numpy cannot hold -> (manifest dtype name, raw numpy view)
_RAW = {torch.bfloat16: ("bfloat16", np.uint16),
        torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8),
        torch.float8_e5m2: ("float8_e5m2", np.uint8)}
_RAW_BY_NAME = {name: (dt, raw) for dt, (name, raw) in _RAW.items()}
_SIGNED = {np.uint16: torch.int16, np.uint8: torch.uint8}


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array as stored, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        # a copy even for a CPU tensor: the caller may mutate it later
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype in _RAW:
            name, raw = _RAW[t.dtype]
            return t.view(_SIGNED[raw]).numpy().view(raw), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _sha(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _snapshot(tree: Tree):
    leaves, build = flatten(tree)
    host = [_to_host(leaf) for leaf in leaves]
    return host, describe(tree)


def _write(host, structure: str, directory: Path, step: int,
           metadata: Optional[Dict]) -> Path:
    final = directory / f"step_{step:08d}"
    tmp = directory / f".step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz",
             **{f"leaf_{i}": arr for i, (arr, _) in enumerate(host)})
    manifest = {
        "step": step,
        "treedef": structure,
        "n_leaves": len(host),
        "shapes": [list(arr.shape) for arr, _ in host],
        "dtypes": [name for _, name in host],
        "sha256": [_sha(arr) for arr, _ in host],
        "metadata": metadata or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(tree: Tree, directory: str | Path, step: int,
         metadata: Optional[Dict] = None) -> Path:
    host, structure = _snapshot(tree)
    return _write(host, structure, Path(directory), step, metadata)


def _steps(directory: Path) -> List[int]:
    return sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_"))


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def _from_stored(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _RAW_BY_NAME:
        dt, raw = _RAW_BY_NAME[name]
        signed = np.int16 if raw is np.uint16 else np.uint8
        return torch.from_numpy(arr.view(signed).copy()).view(dt)
    return torch.from_numpy(arr.copy())


def restore(tree_like: Tree, directory: str | Path,
            step: Optional[int] = None) -> Tuple[Tree, Dict]:
    """Restore into the structure of ``tree_like``, each leaf a tensor of
    its dtype on its device (non-tensor leaves come back as tensors on the
    CPU); shapes and hashes are verified against the manifest."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz") as npz:
        stored = [npz[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    for i, (arr, h) in enumerate(zip(stored, manifest["sha256"])):
        if _sha(arr) != h:
            raise IOError(f"checkpoint corruption: leaf {i} hash mismatch")
    ref_leaves, build = flatten(tree_like)
    if len(ref_leaves) != len(stored):
        raise ValueError(f"checkpoint has {len(stored)} leaves, expected "
                         f"{len(ref_leaves)}")
    out = []
    for i, (arr, ref) in enumerate(zip(stored, ref_leaves)):
        t = _from_stored(arr, manifest["dtypes"][i])
        if tuple(t.shape) != tuple(np.shape(ref)):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)}, "
                             f"expected {tuple(np.shape(ref))}")
        if isinstance(ref, torch.Tensor):
            t = t.to(device=ref.device, dtype=ref.dtype)
        out.append(t)
    return build(out), manifest["metadata"]


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep_last: int = 3,
                 async_save: bool = False):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree: Tree, step: int, metadata: Optional[Dict] = None):
        # snapshot to host memory NOW (the caller may mutate afterwards)
        host, structure = _snapshot(tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_in_background,
                args=(host, structure, step, metadata), daemon=True)
            self._thread.start()
        else:
            self._save_rotate(host, structure, step, metadata)

    def _save_rotate(self, host, structure, step, metadata):
        _write(host, structure, self.directory, step, metadata)
        for s in _steps(self.directory)[:-self.keep_last]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def _save_in_background(self, *args):
        try:
            self._save_rotate(*args)
        except Exception as e:            # re-raised by wait()
            self._error = e

    def wait(self):
        """Wait for a background save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, tree_like: Tree):
        self.wait()
        return restore(tree_like, self.directory)
