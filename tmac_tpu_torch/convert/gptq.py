"""GPTQ / AutoGPTQ / GPTQModel / EfficientQAT checkpoint unpacking, and
AutoAWQ's (the port of ``tmac_tpu/convert/gptq.py``, numpy and the native
library only).

Same semantics as reference python/t_mac/model_utils.py:95-129
(parse_gptqv2 / unpack_gptqv2), including the AutoGPTQ-v1 `zeros + 1` quirk
(model_utils.py:123-127), re-derived for this framework's kernel-layout
convention:

  HF GPTQ stores, per linear layer with in_features=K, out_features=M:
    qweight: int32 (K*bits/32, M)   -- bits-wide fields packed along K
    scales:  fp16  (K/gs, M)
    qzeros:  int32 (K/gs, M*bits/32) -- zero points packed along M
    (g_idx:  must be trivial -- desc_act/act-order unsupported, matching
     the reference's assert at model_utils.py:224)

  Dequant:  W[k, m] = scales[k//gs, m] * (wq[k, m] - zq[k//gs, m])

which maps onto this framework's  Wdq = scales * wq - sub  with
sub = scales * zq.  No transpose needed: GPTQ's (K, M) orientation IS the
kernel layout used by ops/qgemm.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def parse_gptq(qweight: np.ndarray, scales: np.ndarray, qzeros: np.ndarray) -> Tuple[int, int, int, int]:
    """Infer (K, M, bits, group_size) from packed tensor shapes
    (cf. reference model_utils.py:95-101).

    bits=3 included: zeros pack 10 codes/word (32//10 = 3) and qweight rows
    come in threes (32 codes per 3 words), so K = rows * 32 // bits covers
    every supported width."""
    bits = 32 // (scales.shape[1] // qzeros.shape[1])
    K = qweight.shape[0] * 32 // bits
    M = qweight.shape[1]
    group_size = K // scales.shape[0]
    return K, M, bits, group_size


def _unpack_int32_fields(a: np.ndarray, bits: int, axis: int) -> np.ndarray:
    """Unpack bits-wide fields from int32 along `axis` (field j = bits j*bits..).

    bits=3 uses the AutoGPTQ straddle layout (32 codes per 3 words):
      word0: codes 0..9 at bits 0,3,..,27; code 10 bits[1:0] at 31:30
      word1: code 10 bit[2] at 0; codes 11..20 at bits 1,4,..,28;
             code 21 bit[0] at 31
      word2: code 21 bits[2:1] at 1:0; codes 22..31 at bits 2,5,..,29
    (AutoGPTQ qlinear pack(), mirrored by quantize_gptq_like below).
    """
    if bits == 3:
        a = np.moveaxis(a, axis, 0)
        if a.shape[0] % 3:
            raise ValueError(f"3-bit words come in threes, not {a.shape}")
        w3 = a.reshape(a.shape[0] // 3, 3, -1)
        w0, w1, w2 = w3[:, 0], w3[:, 1], w3[:, 2]
        out = np.empty((w3.shape[0], 32, w3.shape[2]), np.int64)
        for j in range(10):
            out[:, j] = (w0 >> (3 * j)) & 7
        out[:, 10] = ((w0 >> 30) & 3) | ((w1 & 1) << 2)
        for j in range(10):
            out[:, 11 + j] = (w1 >> (3 * j + 1)) & 7
        out[:, 21] = ((w1 >> 31) & 1) | ((w2 & 3) << 1)
        for j in range(10):
            out[:, 22 + j] = (w2 >> (3 * j + 2)) & 7
        out = out.reshape((out.shape[0] * 32,) + a.shape[1:])
        return np.moveaxis(out, 0, axis)
    n = 32 // bits
    mask = (1 << bits) - 1
    fields = [((a >> (bits * j)) & mask) for j in range(n)]
    # interleave: packed element i expands to positions i*n + j
    stacked = np.stack(fields, axis=axis + 1)
    shape = list(a.shape)
    shape[axis] = shape[axis] * n
    return stacked.reshape(shape)


def unpack_gptq(
    qweight: np.ndarray,
    scales: np.ndarray,
    qzeros: np.ndarray,
    gptq_v2: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """Returns (wq uint8 (K, M), scales f32 (G, M), sub f32 (G, M), bits, gs).

    gptq_v2=False applies the AutoGPTQ v1 convention where stored zeros are
    `z - 1` (reference model_utils.py:123-127; GPTQModel/v2 stores z as-is).
    """
    if qweight.dtype != np.int32 or qzeros.dtype != np.int32:
        raise TypeError(f"qweight and qzeros are int32, not {qweight.dtype} "
                        f"and {qzeros.dtype}")
    K, M, bits, group_size = parse_gptq(qweight, scales, qzeros)

    from tmac_tpu_torch import native
    if bits != 3 and native.available() and qweight.size >= (1 << 18):
        # (b3's straddle layout stays on the numpy path; the C++ fast path
        # handles the bits | 32 cases)
        wq = native.unpack_gptq_qweight(qweight, bits)[:K]
        zq = native.unpack_gptq_qzeros(qzeros, bits, add_one=not gptq_v2)
        zq = zq[:, :M].astype(np.float32)
    else:
        wq = _unpack_int32_fields(qweight.view(np.uint32).astype(np.int64),
                                  bits, axis=0)
        wq = wq[:K].astype(np.uint8)  # (K, M)
        zq = _unpack_int32_fields(qzeros.view(np.uint32).astype(np.int64),
                                  bits, axis=1)
        zq = zq[:, :M].astype(np.float32)  # (G, M)
        if not gptq_v2:
            zq += 1.0

    scales = scales.astype(np.float32)
    sub = scales * zq
    return wq, scales, sub, bits, group_size


def quantize_gptq_like(w_km: np.ndarray, bits: int, group_size: int):
    """Pack float weights into synthetic GPTQ-format tensors (tests only).

    w_km: (K, M) float. Returns (qweight int32, scales fp16, qzeros int32)
    in the HF GPTQ layout above, using simple asymmetric min/max quant.
    """
    K, M = w_km.shape
    G = K // group_size
    qmax = (1 << bits) - 1
    wg = w_km.reshape(G, group_size, M)
    wmin, wmax = wg.min(1), wg.max(1)
    scales = np.maximum(wmax - wmin, 1e-6) / qmax
    zq = np.clip(np.rint(-wmin / scales), 0, qmax).astype(np.int64)
    q = np.clip(np.rint(wg / scales[:, None, :]) + zq[:, None, :], 0, qmax)
    q = q.reshape(K, M).astype(np.int64)

    def pack_axis0(codes):  # (32n, X) -> (bits*n, X) int64 words
        if bits == 3:
            c = codes.reshape(codes.shape[0] // 32, 32, -1)
            w = np.zeros((c.shape[0], 3, c.shape[2]), np.int64)
            for j in range(10):
                w[:, 0] |= c[:, j] << (3 * j)
            w[:, 0] |= (c[:, 10] & 3) << 30
            w[:, 1] |= c[:, 10] >> 2
            for j in range(10):
                w[:, 1] |= c[:, 11 + j] << (3 * j + 1)
            w[:, 1] |= (c[:, 21] & 1) << 31
            w[:, 2] |= c[:, 21] >> 1
            for j in range(10):
                w[:, 2] |= c[:, 22 + j] << (3 * j + 2)
            return w.reshape((w.shape[0] * 3,) + codes.shape[1:])
        n = 32 // bits
        cr = codes.reshape(codes.shape[0] // n, n, -1)
        w = np.zeros((cr.shape[0], cr.shape[2]), np.int64)
        for j in range(n):
            w |= cr[:, j] << (bits * j)
        return w.reshape((w.shape[0],) + codes.shape[1:])

    qweight = pack_axis0(q)                      # (K*bits/32, M)
    # ascontiguousarray: astype(order='K') would keep the moveaxis
    # F-order, and safetensors serializes the raw buffer ignoring strides
    qzeros = np.ascontiguousarray(
        np.moveaxis(pack_axis0(np.moveaxis(zq, 1, 0)), 0, 1))

    return (
        qweight.astype(np.uint32).view(np.int32),
        scales.astype(np.float16),
        qzeros.astype(np.uint32).view(np.int32),
    )


# ---------------------------------------------------------------------------
# AWQ (AutoAWQ "gemm" checkpoints) -- net-new vs the reference, which
# covers GPTQ/EfficientQAT only (model_utils.py:104-129); AWQ is the other
# dominant HF 4-bit format, so "convert your existing checkpoint" parity
# needs it.
# ---------------------------------------------------------------------------

# AutoAWQ packs 8 nibbles per int32 along the OUT-FEATURE axis in the
# interleave [0, 2, 4, 6, 1, 3, 5, 7]; unpacking LSB-first then taking
# columns [0, 4, 1, 5, 2, 6, 3, 7] per 8-group restores logical order
# (AutoAWQ awq/utils/packing_utils.py reverse_awq_order).
_AWQ_REVERSE_ORDER = (0, 4, 1, 5, 2, 6, 3, 7)
_AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _unpack_awq_words(a: np.ndarray) -> np.ndarray:
    vals = np.stack([(a >> (4 * j)) & 0xF for j in range(8)], axis=-1)
    vals = vals[..., list(_AWQ_REVERSE_ORDER)]
    return vals.reshape(*a.shape[:-1], a.shape[-1] * 8)


def unpack_awq(qweight: np.ndarray, scales: np.ndarray,
               qzeros: np.ndarray):
    """AWQ 'gemm' linear -> (wq (K, M) uint8, scales (K/gs, M) f32,
    sub (K/gs, M) f32, bits=4, group_size).

    Layout: qweight int32 (K, M//8) -- 4-bit fields packed along M (the
    opposite axis from GPTQ) in the AWQ interleave; qzeros int32
    (K/gs, M//8) likewise; scales fp16 (K/gs, M).  Dequant
    W = scales * (wq - zq) maps to Wdq = scales*wq - sub with
    sub = scales * zq; AWQ's (K, M) orientation is already the kernel
    layout (no transpose, like GPTQ)."""
    K = qweight.shape[0]
    gs = K // scales.shape[0]
    wq = _unpack_awq_words(qweight.view(np.int32) if qweight.dtype != np.int32
                           else qweight).astype(np.uint8)
    zq = _unpack_awq_words(qzeros.view(np.int32) if qzeros.dtype != np.int32
                           else qzeros).astype(np.float32)
    scales = np.asarray(scales, np.float32)
    return wq, scales, scales * zq, 4, gs


def quantize_awq_like(w_km: np.ndarray, group_size: int = 128):
    """float (K, M) -> AWQ-format (qweight, scales fp16, qzeros) -- the
    synthetic-fixture packer mirroring AutoAWQ's layout (tests +
    interchange)."""
    K, M = w_km.shape
    if K % group_size or M % 8:
        raise ValueError(f"({K}, {M}) at group size {group_size}: K a multiple "
                         "of it and M of 8")
    g = w_km.reshape(K // group_size, group_size, M)
    mn = g.min(axis=1)
    mx = g.max(axis=1)
    scales = np.maximum((mx - mn) / 15.0, 1e-8).astype(np.float32)
    zq = np.clip(np.rint(-mn / scales), 0, 15).astype(np.int64)
    codes = np.clip(np.rint(w_km / np.repeat(scales, group_size, 0))
                    + np.repeat(zq, group_size, 0), 0, 15).astype(np.int64)

    def pack(vals):  # (..., M) -> (..., M//8) int32, AWQ interleave
        v = vals.reshape(*vals.shape[:-1], -1, 8)[..., list(_AWQ_ORDER)]
        out = np.zeros(v.shape[:-1], np.int64)
        for j in range(8):
            out |= v[..., j] << (4 * j)
        return out.astype(np.uint32).view(np.int32)

    return pack(codes), scales.astype(np.float16), pack(zq)
