"""Builds the port's CUDA sources (``csrc/*.cu``) into shared libraries.

Each source becomes its own library, compiled by nvcc for Hopper
(``sm_90a``) with a plain C interface and loaded with ctypes.  Nothing is
built when a module is imported: a library is built at its first use, or
all of them at once, in parallel, by ``build()``.  Libraries go into
``tmac_tpu_torch/_build/`` under a name that carries a hash of the source
and the flags (and of the shared headers, ``csrc/*.cuh``), so an edited
source is rebuilt.  A failed build raises with
nvcc's output.

No ``--use_fast_math``: the activation prologues (qgemm_fused.cu,
qgemm_grouped.cu, qgemm_expert.cu, qgemm_large.cu, block_kernel.cu) depend
on IEEE division, square root, ``expf`` and ``rintf``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("qgemm_fused", "qgemm_grouped", "qgemm_grouped_large", "qgemm_grouped_large_f32",
           "qgemm_grouped_large_native", "qgemm_expert", "flash_decode", "qgemm_large",
           "block_kernel")
# -Xptxas -v only reports each kernel's registers, shared memory and spills
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
# each source's nvcc seconds in the last build() that compiled it
build_seconds: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # a source that includes another (qgemm_grouped_large_f32.cu, _native.cu) and the headers
    src += b"".join((CSRC / f.decode()).read_bytes()
                    for f in re.findall(rb'#include "(\w+\.cu)"', src))
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict:
    """Compile every source in `names` that is not built yet, all nvcc
    processes at once; returns nvcc's output (ptxas's register, shared
    memory and spill report) by name for each one compiled, and records
    each one's seconds in build_seconds."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        log = tempfile.TemporaryFile(mode="w+", dir=BUILD_DIR)  # no pipe to fill
        cmd = [nvcc(), *FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      log, tmp, out)
    logs, failed = {}, []
    while len(logs) < len(jobs):
        for name, (proc, log, tmp, out) in jobs.items():
            if name in logs or proc.poll() is None:
                continue
            build_seconds[name] = time.perf_counter() - t0
            log.seek(0)
            logs[name] = log.read()
            log.close()
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"nvcc failed on {name}.cu:\n{logs[name]}")
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
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
