"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source becomes its own library, compiled by nvcc for Hopper
(``sm_90a``) with a plain C interface and loaded with ctypes.  Nothing is
built when a module is imported: a library is built at its first use, or
all of them at once, in parallel, by ``build()``.  Libraries go into
``tmac_tpu_torch/_build/`` under a name that carries a hash of the source
and the flags, so an edited source is rebuilt.  A failed build raises with
nvcc's output.

No ``--use_fast_math``: the activation quantization in qgemm_fused.cu
depends on IEEE division and ``rintf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("qgemm_fused", "flash_decode")
# -Xptxas -v only reports each kernel's registers, shared memory and spills
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in `names` that is not built yet, all nvcc
    processes at once; returns nvcc's output (ptxas's register, shared
    memory and spill report) by name for each one compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building it if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build((name,))
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
