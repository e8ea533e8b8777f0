"""Low-bit weight packing, in numpy (the port's copy of
``tmac_tpu/ops/packing.py``).

Layout ("strided field packing"): with p = 8 // bits fields per byte, the
packed array is uint8 of shape (K // p, M) and

    packed[r, m] = sum_j Wq[r + j * (K // p), m] << (bits * j)

so field j of packed row r holds the weight for k = r + j*K/p.  Packing is
applied per contiguous K-shard (`k_shards`).  bits=3 is two arrays: a
2-bit low plane and a 1-bit high plane.  bits=8 is the degenerate p=1 case.

The bytes equal the JAX package's numpy branch bit for bit; the port never
loads the JAX package's native library.
"""

from __future__ import annotations

import numpy as np


def _fields_per_byte(bits: int) -> int:
    assert bits in (1, 2, 4, 8), f"packing supports bits in (1,2,4,8), got {bits}"
    return 8 // bits


def pack_strided(wq: np.ndarray, bits: int, k_shards: int = 1) -> np.ndarray:
    """Pack (K, M) biased-unsigned weights into (K//p, M) uint8."""
    p = _fields_per_byte(bits)
    K, M = wq.shape
    assert K % (p * k_shards) == 0, (K, p, k_shards)
    wq = np.asarray(wq, dtype=np.uint8)
    if bits == 8:
        return wq.copy()
    assert wq.max(initial=0) < (1 << bits), "weight values exceed bit width"
    ks = K // k_shards
    w = wq.reshape(k_shards, p, ks // p, M)
    packed = np.zeros((k_shards, ks // p, M), dtype=np.uint8)
    for j in range(p):
        packed |= w[:, j] << (bits * j)
    return packed.reshape(K // p, M)


def unpack_strided(packed: np.ndarray, bits: int, k_shards: int = 1) -> np.ndarray:
    """Inverse of pack_strided: (K//p, M) uint8 -> (K, M) uint8 values."""
    p = _fields_per_byte(bits)
    KP, M = packed.shape
    assert KP % k_shards == 0
    packed = np.asarray(packed, dtype=np.uint8)
    if bits == 8:
        return packed.copy()
    pk = packed.reshape(k_shards, KP // k_shards, M)
    mask = (1 << bits) - 1
    blocks = [(pk >> (bits * j)) & mask for j in range(p)]
    return np.concatenate(blocks, axis=1).reshape(KP * p, M)


def pack_b3(wq: np.ndarray, k_shards: int = 1):
    """Pack 3-bit weights as (2-bit low planes, 1-bit high plane)."""
    assert wq.max(initial=0) < 8
    lo = (wq & 0b11).astype(np.uint8)
    hi = ((wq >> 2) & 0b1).astype(np.uint8)
    return pack_strided(lo, 2, k_shards), pack_strided(hi, 1, k_shards)


def unpack_b3(packed_lo: np.ndarray, packed_hi: np.ndarray, k_shards: int = 1) -> np.ndarray:
    lo = unpack_strided(packed_lo, 2, k_shards)
    hi = unpack_strided(packed_hi, 1, k_shards)
    return (lo + (hi << 2)).astype(np.uint8)


def quantize_weights(w: np.ndarray, bits: int, group_size: int,
                     zero_point: bool = False):
    """Quantize float weights (K, M) to biased-unsigned with per-group scales.

    Returns (wq uint8 (K, M), scales (K//gs, M) f32, sub (K//gs, M) f32)
    under Wdq[k, m] = scales[k//gs, m] * wq[k, m] - sub[k//gs, m].
    Symmetric: sub = mid * scales (mid = 2^(bits-1)).  Asymmetric: min/max
    affine quantization, sub = -wmin.
    """
    K, M = w.shape
    assert K % group_size == 0
    G = K // group_size
    wg = w.reshape(G, group_size, M)
    qmax = (1 << bits) - 1
    mid = 1 << (bits - 1)
    if zero_point:
        wmin = wg.min(axis=1)
        wmax = wg.max(axis=1)
        scales = np.maximum(wmax - wmin, 1e-8) / qmax
        wq = np.clip(np.rint((wg - wmin[:, None, :]) / scales[:, None, :]), 0, qmax)
        sub = -wmin
    else:
        amax = np.abs(wg).max(axis=1)
        scales = np.maximum(amax, 1e-8) / mid
        wq = np.clip(np.rint(wg / scales[:, None, :]) + mid, 0, qmax)
        sub = mid * scales
    return (wq.reshape(K, M).astype(np.uint8), scales.astype(np.float32),
            sub.astype(np.float32))


def dequantize(wq: np.ndarray, scales: np.ndarray, sub: np.ndarray,
               group_size: int) -> np.ndarray:
    """Dequant oracle: Wdq = scales * wq - sub (per k-group)."""
    K, M = wq.shape
    wq = wq.reshape(K // group_size, group_size, M).astype(np.float32)
    return (scales[:, None, :] * wq - sub[:, None, :]).reshape(K, M)
