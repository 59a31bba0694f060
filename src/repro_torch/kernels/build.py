"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and becomes its own
shared library, compiled for ``sm_90a`` at first use into
``<checkout>/build/torch_kernels/`` (or ``$REPRO_TORCH_BUILD_DIR``).  The
file name carries a hash of the source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header rebuilds and
an unchanged one loads at once.  ``build()`` starts one nvcc
per missing library, all together, and waits for them.  Nothing here runs
at import: the CPU tests import every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

SOURCES = ("logistic_vjp", "soft_threshold", "flash_attention",
           "decode_attention")
CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# nvcc's output (ptxas registers / shared memory / spills) per library,
# also kept beside each library as lib<name>-<hash>.log
LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "torch_kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet, one nvcc
    each, all started together.  Returns the wall seconds spent; raises
    with nvcc's output if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        LOGS[name] = proc.communicate()[0]
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(LOGS[name])
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{LOGS[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.time() - t0


def log(name: str) -> str:
    """nvcc's output from building ``csrc/<name>.cu`` (ptxas registers,
    shared memory and spills per kernel), built if needed."""
    if name not in LOGS:
        build([name])
        path = library_path(name).with_suffix(".log")
        LOGS[name] = path.read_text() if path.exists() else ""
    return LOGS[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
