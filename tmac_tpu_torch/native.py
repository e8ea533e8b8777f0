"""ctypes bindings for the native (C++) weight pipeline (the port of
``tmac_tpu/native.py``).

The repository's ``csrc/tmac_native.cc`` holds multithreaded C++ versions
of the offline packing and quantization steps (strided packing, grouped
and BitNet quantization, GPTQ field unpacking), bit-compatible with the
numpy code in ops/packing.py and convert/*.py.  This module builds that
source with g++ at first use into ``tmac_tpu_torch/_lib/``, under a name
that carries a hash of the source and the flags.  The build writes a
temporary file in that directory and renames it into place while holding
a file lock, so that processes building at once (pytest-xdist workers)
never load a half-written library; each waits for the lock and then
finds the library built.  ``available()`` is False when there is neither
a built library nor a compiler; callers then take the numpy path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tmac_native.cc"
LIB_DIR = Path(__file__).resolve().parent / "_lib"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(lib_dir: Path = LIB_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()
                            ).hexdigest()[:16]
    return Path(lib_dir) / f"libtmac_native-{digest}.so"


def build(lib_dir: Path = LIB_DIR) -> Optional[Path]:
    """The library in lib_dir, compiled first if it is not there (under
    lib_dir/.lock, to a temporary file renamed into place); None when it
    cannot be built (no source, no g++, or g++ failed)."""
    if not SOURCE.exists():
        return None
    out = library_path(lib_dir)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    lib_dir = Path(lib_dir)
    lib_dir.mkdir(parents=True, exist_ok=True)
    with open(lib_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():          # built by another process meanwhile
            return out
        fd, tmp = tempfile.mkstemp(dir=lib_dir, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run([cxx, *FLAGS, "-o", tmp, str(SOURCE)], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, out)
        except (OSError, subprocess.SubprocessError):
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The argument and result types of every function of the library."""
    i64, i32 = ctypes.c_int64, ctypes.c_int
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for name, args in (
            ("tmac_pack_strided", [u8p, u8p, i64, i64, i32, i32]),
            ("tmac_unpack_strided", [u8p, u8p, i64, i64, i32, i32]),
            ("tmac_quantize_weights_b", [f32p, u8p, f32p, f32p, i64, i64, i32, i64, i32]),
            ("tmac_unpack_gptq_qweight", [i32p, u8p, i64, i64, i32]),
            ("tmac_unpack_gptq_qzeros", [i32p, u8p, i64, i64, i32, i32]),
            ("tmac_quantize_bitnet", [f32p, u8p, f32p, f32p, i64, i64, i32]),
            ("tmac_native_version", [])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            _lib = declare(ctypes.CDLL(str(path)))
        except OSError:
            return None
        return _lib


def available() -> bool:
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library is not available (no g++ to "
                           "build csrc/tmac_native.cc)")
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"tmac_native.{what} failed with code {rc}")


def pack_strided(wq: np.ndarray, bits: int, k_shards: int = 1) -> np.ndarray:
    """packing.pack_strided's layout: (K, M) codes -> (K // p, M) uint8."""
    lib = _need()
    wq = np.ascontiguousarray(wq, dtype=np.uint8)
    K, M = wq.shape
    out = np.empty((K // (8 // bits), M), np.uint8)
    _check(lib.tmac_pack_strided(wq, out, K, M, bits, k_shards), "pack_strided")
    return out


def unpack_strided(packed: np.ndarray, bits: int, k_shards: int = 1) -> np.ndarray:
    """Inverse of pack_strided: (K // p, M) uint8 -> (K, M) codes."""
    lib = _need()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    KP, M = packed.shape
    K = KP * (8 // bits)
    out = np.empty((K, M), np.uint8)
    _check(lib.tmac_unpack_strided(packed, out, K, M, bits, k_shards),
           "unpack_strided")
    return out


def quantize_weights(w: np.ndarray, bits: int, group_size: int,
                     zero_point: bool = False):
    """packing.quantize_weights: (K, M) f32 -> (codes (K, M) uint8, scales
    (K // gs, M) f32, sub (K // gs, M) f32)."""
    lib = _need()
    w = np.ascontiguousarray(w, dtype=np.float32)
    K, M = w.shape
    G = K // group_size
    wq = np.empty((K, M), np.uint8)
    scales = np.empty((G, M), np.float32)
    sub = np.empty((G, M), np.float32)
    _check(lib.tmac_quantize_weights_b(w, wq, scales, sub, K, M, bits,
                                       group_size, int(zero_point)),
           "quantize_weights")
    return wq, scales, sub


def unpack_gptq_qweight(qweight: np.ndarray, bits: int) -> np.ndarray:
    """(R, M) int32, bits-wide fields along K -> (R * 32 / bits, M) uint8."""
    lib = _need()
    qweight = np.ascontiguousarray(qweight, dtype=np.int32)
    R, M = qweight.shape
    out = np.empty((R * (32 // bits), M), np.uint8)
    _check(lib.tmac_unpack_gptq_qweight(qweight, out, R, M, bits),
           "unpack_gptq_qweight")
    return out


def unpack_gptq_qzeros(qzeros: np.ndarray, bits: int, add_one: bool) -> np.ndarray:
    """(G, M * bits / 32) int32, fields along M -> (G, M) uint8 (+1 for
    GPTQ v1's stored z - 1)."""
    lib = _need()
    qzeros = np.ascontiguousarray(qzeros, dtype=np.int32)
    G, Mf = qzeros.shape
    out = np.empty((G, Mf * (32 // bits)), np.uint8)
    _check(lib.tmac_unpack_gptq_qzeros(qzeros, out, G, Mf, bits, int(add_one)),
           "unpack_gptq_qzeros")
    return out


def quantize_bitnet(w: np.ndarray, k_shards: int = 1):
    """convert.bitnet.quantize_bitnet: (K, M) f32 -> (codes {1, 2, 3},
    scales (k_shards, M), sub (k_shards, M))."""
    lib = _need()
    w = np.ascontiguousarray(w, dtype=np.float32)
    K, M = w.shape
    wq = np.empty((K, M), np.uint8)
    scales = np.empty((k_shards, M), np.float32)
    sub = np.empty((k_shards, M), np.float32)
    _check(lib.tmac_quantize_bitnet(w, wq, scales, sub, K, M, k_shards),
           "quantize_bitnet")
    return wq, scales, sub
