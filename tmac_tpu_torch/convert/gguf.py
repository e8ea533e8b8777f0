"""GGUF checkpoint reader and writer -> the PyTorch package's packed params
(its copy of ``tmac_tpu/convert/gguf.py``, byte for byte the JAX
package's conversion).

GGUF is llama.cpp's file format: a header, metadata, a tensor directory
and block-quantized tensor data.  The reader parses gguf v2/v3 files
(spec: github.com/ggerganov/ggml/blob/master/docs/gguf.md) in numpy (the
K-quants' affine fields in torch, so that Q4_K, Q2_K and Q8_0 decode on
the card) and
maps each block type onto the QuantizedTensor contract
(Wdq = scales * wq - sub):

  Q4_0 block = [fp16 d][16 B nibbles], 32 weights; w = (q - 8) * d
  Q4_1, Q4_K  -> bits 4, group size 32, f32 scales and sub, exactly
  Q8_0        -> bits 8, group size 32, f32
  Q2_K, Q3_K  -> bits 2 and 3, group size 16, f32
  TQ1_0, TQ2_0, I2_S (ternary) -> bits 2, per tensor (w_a8) or at group
                 size 256 with f32 scales
  the rest, and fusions of mixed types -> dequantized, then requantized
                 to bits 4 at group size 32 with bf16 scales

f32, because GGUF's fp16 block scales (10 mantissa bits) would not
survive bf16 (7 bits).  The kernels read either (ops/cuda/
qgemm_grouped_kernel.py: K4, K4L and K5; expert_kernel.py: K7), group
size 16 and grouped bits 8 too.

write_gguf writes a gguf v3 file whose bytes are those of the JAX
package's writer for the same tensors; it writes the header first (every
block type's size follows from the shape) and then packs and writes one
tensor at a time, on a few threads, so a model need not be held as float
in host memory.
"""

from __future__ import annotations

import mmap
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

GGUF_MAGIC = b"GGUF"

# metadata value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32, _T_F32, _T_BOOL, _T_STR, \
    _T_ARR, _T_U64, _T_I64, _T_F64 = range(13)

_SCALAR_FMT = {
    _T_U8: "<B", _T_I8: "<b", _T_U16: "<H", _T_I16: "<h",
    _T_U32: "<I", _T_I32: "<i", _T_F32: "<f", _T_BOOL: "<?",
    _T_U64: "<Q", _T_I64: "<q", _T_F64: "<d",
}

# ggml tensor types (subset)
GGML_F32, GGML_F16, GGML_Q4_0, GGML_Q4_1 = 0, 1, 2, 3
GGML_Q5_0, GGML_Q5_1, GGML_Q8_0 = 6, 7, 8
# K-quants (QK_K = 256 super-blocks): llama.cpp's default mixes store
# output.weight / token_embd as Q6_K and attn_v/ffn_down as Q6_K/Q4_K even
# in "Q4_0" conversions (reference run_pipeline.py:164-175 relies on
# llama-quantize whose Q4_K_M preset does exactly this), so real artifacts
# need these readers
GGML_Q2_K, GGML_Q3_K = 10, 11
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
# ternary types: TQ1_0/TQ2_0 are upstream llama.cpp (ggml.h enum 34/35);
# I2_S is the BitNet-fork per-tensor-scale 2-bit type (the "i2" of
# reference tools/run_pipeline.py:375; fork absent from the snapshot --
# layout reconstructed below)
GGML_TQ1_0, GGML_TQ2_0, GGML_I2_S = 34, 35, 36

_TYPE_NAMES = {GGML_F32: "F32", GGML_F16: "F16", GGML_Q4_0: "Q4_0",
               GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0", GGML_Q5_1: "Q5_1",
               GGML_Q8_0: "Q8_0", GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K",
               GGML_Q4_K: "Q4_K",
               GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K", GGML_TQ1_0: "TQ1_0",
               GGML_TQ2_0: "TQ2_0", GGML_I2_S: "I2_S"}

TERNARY_TYPES = (GGML_TQ1_0, GGML_TQ2_0, GGML_I2_S)


def _block_layout(ggml_type: int) -> Tuple[int, int]:
    """(elements per block, bytes per block)."""
    if ggml_type == GGML_F32:
        return 1, 4
    if ggml_type == GGML_F16:
        return 1, 2
    if ggml_type == GGML_Q4_0:
        return 32, 18
    if ggml_type == GGML_Q4_1:
        return 32, 20  # d + m + qs[16]
    if ggml_type == GGML_Q5_0:
        return 32, 22  # d + qh[4] + qs[16]
    if ggml_type == GGML_Q5_1:
        return 32, 24  # d + m + qh[4] + qs[16]
    if ggml_type == GGML_Q8_0:
        return 32, 34
    if ggml_type == GGML_Q2_K:
        return 256, 84   # scales[16] + qs[64] + d + dmin
    if ggml_type == GGML_Q3_K:
        return 256, 110  # hmask[32] + qs[64] + scales[12] + d
    if ggml_type == GGML_Q4_K:
        return 256, 144  # d + dmin + scales[12] + qs[128]
    if ggml_type == GGML_Q5_K:
        return 256, 176  # d + dmin + scales[12] + qh[32] + qs[128]
    if ggml_type == GGML_Q6_K:
        return 256, 210  # ql[128] + qh[64] + scales[16] + d
    if ggml_type == GGML_TQ1_0:
        return 256, 54   # qs[48] + qh[4] + fp16 d
    if ggml_type == GGML_TQ2_0:
        return 256, 66   # qs[64] + fp16 d
    raise NotImplementedError(
        f"ggml tensor type {ggml_type} ({_TYPE_NAMES.get(ggml_type, '?')}) "
        "unsupported -- requantize with llama-quantize to Q4_0/Q8_0")


class GGUFReader:
    """Parses header + metadata + tensor directory; tensor data is sliced
    lazily out of an mmap."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._off = 0
        magic = self._read_bytes(4)
        assert magic == GGUF_MAGIC, f"not a gguf file: {magic!r}"
        self.version = self._scalar(_T_U32)
        assert self.version in (2, 3), f"gguf version {self.version} unsupported"
        n_tensors = self._scalar(_T_U64)
        n_kv = self._scalar(_T_U64)
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._string()
            self.metadata[key] = self._value(self._scalar(_T_U32))
        self.tensors: Dict[str, dict] = {}
        for _ in range(n_tensors):
            name = self._string()
            nd = self._scalar(_T_U32)
            dims = [self._scalar(_T_U64) for _ in range(nd)]  # ne0 fastest
            ttype = self._scalar(_T_U32)
            offset = self._scalar(_T_U64)
            self.tensors[name] = {"dims": dims, "type": ttype, "offset": offset}
        align = self.metadata.get("general.alignment", 32)
        self._data_start = (self._off + align - 1) // align * align

    # -- low-level readers ---------------------------------------------------
    def _read_bytes(self, n: int) -> bytes:
        b = self._mm[self._off:self._off + n]
        self._off += n
        return b

    def _scalar(self, t: int):
        fmt = _SCALAR_FMT[t]
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, self._read_bytes(n))[0]

    def _string(self) -> str:
        n = self._scalar(_T_U64)
        return self._read_bytes(n).decode("utf-8", errors="replace")

    def _value(self, t: int):
        if t == _T_STR:
            return self._string()
        if t == _T_ARR:
            et = self._scalar(_T_U32)
            n = self._scalar(_T_U64)
            return [self._value(et) for _ in range(n)]
        return self._scalar(t)

    # -- tensor access -------------------------------------------------------
    def tensor_bytes(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        elems = int(np.prod(info["dims"]))
        if info["type"] == GGML_I2_S:
            nbytes = elems // 4 + 4  # packed 2-bit codes + trailing f32 scale
        else:
            bele, bbytes = _block_layout(info["type"])
            nbytes = elems // bele * bbytes
        start = self._data_start + info["offset"]
        return np.frombuffer(self._mm, np.uint8, nbytes, start)

    def tensor_on(self, name: str, device) -> torch.Tensor:
        """tensor_bytes as a torch uint8 tensor on `device` (copied from the
        map)."""
        import warnings
        with warnings.catch_warnings():  # the map is read-only; .to copies it
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(self.tensor_bytes(name))
        return t.to(device) if torch.device(device).type != "cpu" else t.clone()

    def expert_views(self, name: str) -> list:
        """Per-expert 2-D views of a 3-D stacked expert tensor (llama.cpp
        MoE `*_exps` layout, ne = [ne0, ne1, n_expert], block-quantized
        along ne0: each expert is a contiguous run of block rows).
        Registers synthetic `name[e]` tensor entries and returns their
        names; every reader path (tensor_bytes/dequantized/
        *_to_quantized) then works on an expert unchanged."""
        info = self.tensors[name]
        dims = info["dims"]
        assert len(dims) == 3, (name, dims)
        # I2_S carries one trailing per-TENSOR f32 scale -- per-expert
        # byte slices would each need it; no MoE I2_S artifacts exist
        assert info["type"] != GGML_I2_S, "I2_S expert tensors unsupported"
        ne0, ne1, n_expert = dims
        bele, bbytes = _block_layout(info["type"])
        per = (ne0 * ne1) // bele * bbytes
        out = []
        for e in range(n_expert):
            vn = f"{name}[{e}]"
            self.tensors[vn] = {"dims": [ne0, ne1], "type": info["type"],
                                "offset": info["offset"] + e * per}
            out.append(vn)
        return out

    def dequantized(self, name: str) -> np.ndarray:
        """Any supported tensor -> float32, gguf row-major shape
        (dims reversed: (ne1, ne0) = (rows, cols))."""
        info = self.tensors[name]
        dims = info["dims"]
        shape = tuple(reversed(dims))
        t = info["type"]
        raw = self.tensor_bytes(name)
        if t == GGML_F32:
            return raw.view(np.float32).reshape(shape).astype(np.float32)
        if t == GGML_F16:
            return raw.view(np.float16).reshape(shape).astype(np.float32)
        if t == GGML_Q4_0:
            wq, d = self._q4_0_fields(raw)
            return ((wq.astype(np.float32) - 8.0)
                    * d.astype(np.float32)[:, None]).reshape(shape)
        if t == GGML_Q4_1:
            codes, d, m = self._q4_1_fields(raw)
            return (codes.astype(np.float32) * d.astype(np.float32)[:, None]
                    + m.astype(np.float32)[:, None]).reshape(shape)
        if t == GGML_Q5_0:
            codes, d = self._q5_0_fields(raw)
            return ((codes.astype(np.float32) - 16.0)
                    * d.astype(np.float32)[:, None]).reshape(shape)
        if t == GGML_Q5_1:
            codes, d, m = self._q5_1_fields(raw)
            return (codes.astype(np.float32) * d.astype(np.float32)[:, None]
                    + m.astype(np.float32)[:, None]).reshape(shape)
        if t == GGML_Q8_0:
            blk = raw.reshape(-1, 34)
            d = blk[:, :2].copy().view(np.float16).reshape(-1)
            q = blk[:, 2:].view(np.int8)
            return (q.astype(np.float32) * d.astype(np.float32)[:, None]).reshape(shape)
        if t == GGML_Q2_K:
            codes, scales, mins = (f.numpy() for f in self._q2_k_fields(
                self.tensor_on(name, "cpu")))
            w = (codes.reshape(-1, 16, 16).astype(np.float32)
                 * scales[:, :, None] - mins[:, :, None])
            return w.reshape(shape)
        if t == GGML_Q3_K:
            codes, scales = self._q3_k_fields(raw)
            w = ((codes.reshape(-1, 16, 16).astype(np.float32) - 4.0)
                 * scales[:, :, None])
            return w.reshape(shape)
        if t == GGML_Q4_K or t == GGML_Q5_K:
            fields = self._q4_k_fields if t == GGML_Q4_K else self._q5_k_fields
            codes, scales, mins = (f.numpy() for f in fields(self.tensor_on(name, "cpu")))
            # affine per 32-element group: w = sc_g * q - m_g (this IS the
            # framework's dequant model; see q4_k_to_quantized)
            w = (codes.reshape(-1, 8, 32).astype(np.float32)
                 * scales[:, :, None] - mins[:, :, None])
            return w.reshape(shape)
        if t == GGML_Q6_K:
            codes, scales = self._q6_k_fields(raw)
            w = ((codes.reshape(-1, 16, 16).astype(np.float32) - 32.0)
                 * scales[:, :, None])
            return w.reshape(shape)
        if t == GGML_TQ1_0 or t == GGML_TQ2_0:
            fields = self._tq1_0_fields if t == GGML_TQ1_0 else self._tq2_0_fields
            trits, d = fields(raw)
            return ((trits.astype(np.float32) - 1.0)
                    * d.astype(np.float32)[:, None]).reshape(shape)
        if t == GGML_I2_S:
            trits, scale = self._i2_s_fields(raw, int(np.prod(dims)))
            return (trits.astype(np.float32) - 1.0).reshape(shape) * scale
        raise NotImplementedError(_TYPE_NAMES.get(t, str(t)))

    @staticmethod
    def _tq1_0_fields(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(trits uint8 (nblocks, 256) codes {0,1,2}, d fp16 (nblocks,)).

        llama.cpp block_tq1_0 (ggml quantize_row_tq1_0_ref): qs[48] packs 5
        trits per byte in fixed-point base-3 -- byte = ceil((t0*81 + t1*27
        + ... + t4) * 256 / 243); digit n extracted as
        ((byte * 3^n mod 256) * 3) >> 8.  The first 32 qs bytes cover
        elements 0..159 with element index m + 32n, the next 16 bytes cover
        160..239 at stride 16; qh[4] packs 4 trits per byte (x256/81) for
        elements 240..255 at stride 4; fp16 d last.
        """
        blk = raw.reshape(-1, 54)
        nb = blk.shape[0]
        qs = blk[:, :48].astype(np.uint16)
        qh = blk[:, 48:52].astype(np.uint16)
        d = blk[:, 52:54].copy().view(np.float16).reshape(-1)
        trits = np.empty((nb, 256), np.uint8)
        pow3 = (1, 3, 9, 27, 81)
        for n in range(5):
            q = (qs[:, :32] * pow3[n]) & 0xFF
            trits[:, 32 * n:32 * (n + 1)] = (q * 3) >> 8
        for n in range(5):
            q = (qs[:, 32:48] * pow3[n]) & 0xFF
            trits[:, 160 + 16 * n:160 + 16 * (n + 1)] = (q * 3) >> 8
        for n in range(4):
            q = (qh * pow3[n]) & 0xFF
            trits[:, 240 + 4 * n:240 + 4 * (n + 1)] = (q * 3) >> 8
        return trits, d

    @staticmethod
    def _tq2_0_fields(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(trits uint8 (nblocks, 256) codes {0,1,2}, d fp16 (nblocks,)).

        llama.cpp block_tq2_0: qs[64], 4 elements per byte at 2 bits each,
        element index j*4 + m + 32n for byte j+m (j in {0,32}), code =
        (byte >> 2n) & 3; fp16 d last."""
        blk = raw.reshape(-1, 66)
        qs = blk[:, :64]
        d = blk[:, 64:66].copy().view(np.float16).reshape(-1)
        trits = np.empty((blk.shape[0], 256), np.uint8)
        for j in (0, 32):
            for n in range(4):
                trits[:, j * 4 + 32 * n:j * 4 + 32 * (n + 1)] = \
                    (qs[:, j:j + 32] >> (2 * n)) & 3
        return trits, d

    @staticmethod
    def _i2_s_fields(raw: np.ndarray, elems: int) -> Tuple[np.ndarray, float]:
        """(trits uint8 (elems,) codes {0,1,2}, per-tensor f32 scale).

        The BitNet-fork "i2" per-tensor-scale 2-bit type (reference
        tools/run_pipeline.py:375; the fork submodule is absent from the
        snapshot, so this layout is this framework's own contract, written
        by write_gguf below): element e lives in byte e//4 at bit offset
        2*(e%4), codes {0,1,2} = trit + 1; one f32 scale trails the packed
        bytes.  Dequant: w = (code - 1) * scale.
        """
        qs = raw[:elems // 4]
        scale = float(raw[elems // 4:elems // 4 + 4].copy().view(np.float32)[0])
        trits = np.empty((elems,), np.uint8)
        for n in range(4):
            trits[n::4] = (qs >> (2 * n)) & 3
        return trits, scale

    @staticmethod
    def _kq_scale_min(sc_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Unpack the 12-byte 6-bit scale/min fields of Q4_K/Q5_K blocks
        (llama.cpp get_scale_min_k4), on sc_raw's device: -> (sc6, m6)
        each (nb, 8) uint8."""
        lo, mid, hi = sc_raw[:, 0:4], sc_raw[:, 4:8], sc_raw[:, 8:12]
        sc6 = torch.cat([lo & 63, (hi & 0x0F) | ((lo >> 6) << 4)], 1)
        m6 = torch.cat([mid & 63, (hi >> 4) | ((mid >> 6) << 4)], 1)
        return sc6, m6

    @staticmethod
    def _q2_k_fields(raw: torch.Tensor):
        """Q2_K super-blocks -> (codes (nb, 256) uint8 0..3, scales
        (nb, 16) f32, mins (nb, 16) f32) with w = sc_g*q - m_g over
        contiguous 16-element groups (llama.cpp dequantize_row_q2_K:
        scales[16] hold scale in the low nibble, min in the high, both
        rescaled by fp16 super-scales d/dmin); on raw's device."""
        blk = raw.reshape(-1, 84)
        sc_raw = blk[:, :16]
        qs = blk[:, 16:80]
        d = blk[:, 80:82].contiguous().view(torch.float16).reshape(-1).float()
        dmin = blk[:, 82:84].contiguous().view(torch.float16).reshape(-1).float()
        # 128-element halves share a 32-byte chunk, bit positions 0/2/4/6
        codes = torch.cat([(qs[:, 32 * n:32 * (n + 1)] >> (2 * j)) & 3
                           for n in (0, 1) for j in range(4)], 1)
        return codes, d[:, None] * (sc_raw & 0x0F), dmin[:, None] * (sc_raw >> 4)

    @staticmethod
    def _q3_k_fields(raw: np.ndarray):
        """Q3_K super-blocks -> (codes (nb, 256) uint8 0..7 biased +4,
        scales (nb, 16) f32) with w = sc_g * (q - 4) over contiguous
        16-element groups (llama.cpp dequantize_row_q3_K: 2-bit qs + the
        hmask high bit; 16 6-bit scales biased +32 packed in 12 bytes via
        the kmask aux trick)."""
        blk = raw.reshape(-1, 110)
        hmask = blk[:, :32]
        qs = blk[:, 32:96]
        sr = blk[:, 96:108]
        d = blk[:, 108:110].copy().view(np.float16).reshape(-1).astype(np.float32)
        nb = blk.shape[0]
        # 12 bytes -> 16 6-bit scales: low nibbles of bytes 0-7 + the
        # 2-bit fields of bytes 8-11 (llama.cpp kmask1/kmask2 unpack)
        s = np.empty((nb, 16), np.uint8)
        b0, b1, b2 = sr[:, 0:4], sr[:, 4:8], sr[:, 8:12]
        s[:, 0:4] = (b0 & 0x0F) | (((b2 >> 0) & 3) << 4)
        s[:, 4:8] = (b1 & 0x0F) | (((b2 >> 2) & 3) << 4)
        s[:, 8:12] = (b0 >> 4) | (((b2 >> 4) & 3) << 4)
        s[:, 12:16] = (b1 >> 4) | (((b2 >> 6) & 3) << 4)
        scales = d[:, None] * (s.astype(np.float32) - 32.0)
        codes = np.empty((nb, 256), np.uint8)
        for n in (0, 1):
            chunk = qs[:, 32 * n:32 * (n + 1)]
            for j in range(4):
                hbit = (hmask >> (4 * n + j)) & 1
                codes[:, 128 * n + 32 * j:128 * n + 32 * (j + 1)] = \
                    (((chunk >> (2 * j)) & 3) + (hbit << 2))
        return codes, scales

    # The K-quants' affine fields are decoded in torch, on the raw bytes'
    # device: a model's Q4_K matmuls decode on the card (_q4_k_quantized),
    # and dequantized() runs the same code on the CPU.
    @staticmethod
    def _kq_affine_fields(blk: torch.Tensor, codes: torch.Tensor):
        """(codes, scales (nb, 8) f32, mins (nb, 8) f32) of Q4_K/Q5_K
        super-blocks blk, their fp16 d and dmin in bytes 0-3 and the 6-bit
        scales and mins in bytes 4-15."""
        d = blk[:, 0:2].contiguous().view(torch.float16).reshape(-1).float()
        dmin = blk[:, 2:4].contiguous().view(torch.float16).reshape(-1).float()
        sc6, m6 = GGUFReader._kq_scale_min(blk[:, 4:16])
        return codes, d[:, None] * sc6, dmin[:, None] * m6

    @staticmethod
    def _q4_k_fields(raw: torch.Tensor):
        """Q4_K super-blocks -> (codes (nb, 256) uint8 0..15,
        scales (nb, 8) f32, mins (nb, 8) f32) with w = sc_g*q - m_g over
        contiguous 32-element groups (llama.cpp dequantize_row_q4_K)."""
        blk = raw.reshape(-1, 144)
        qs = blk[:, 16:144]
        # 64-element chunks: 32 low nibbles, 32 high
        codes = torch.cat([x for c in range(4) for x in (qs[:, 32 * c:32 * (c + 1)] & 0x0F,
                                                         qs[:, 32 * c:32 * (c + 1)] >> 4)], 1)
        return GGUFReader._kq_affine_fields(blk, codes)

    @staticmethod
    def _q5_k_fields(raw: torch.Tensor):
        """Q5_K super-blocks -> (codes (nb, 256) uint8 0..31, scales,
        mins) -- Q4_K's affine model with a 5th bit from qh."""
        blk = raw.reshape(-1, 176)
        qh = blk[:, 16:48]
        qs = blk[:, 48:176]
        codes = torch.cat([x for c in range(4) for x in (
            (qs[:, 32 * c:32 * (c + 1)] & 0x0F) | (((qh >> (2 * c)) & 1) << 4),
            (qs[:, 32 * c:32 * (c + 1)] >> 4) | (((qh >> (2 * c + 1)) & 1) << 4))], 1)
        return GGUFReader._kq_affine_fields(blk, codes)

    @staticmethod
    def _q6_k_fields(raw: np.ndarray):
        """Q6_K super-blocks -> (codes (nb, 256) uint8 0..63 biased +32,
        scales (nb, 16) f32) with w = sc_g * (q - 32) over contiguous
        16-element groups (llama.cpp dequantize_row_q6_K)."""
        blk = raw.reshape(-1, 210)
        ql = blk[:, :128]
        qh = blk[:, 128:192]
        sc = blk[:, 192:208].view(np.int8)
        d = blk[:, 208:210].copy().view(np.float16).reshape(-1).astype(np.float32)
        codes = np.empty((blk.shape[0], 256), np.uint8)
        for n in (0, 1):  # 128-element halves
            qln = ql[:, 64 * n:64 * (n + 1)]
            qhn = qh[:, 32 * n:32 * (n + 1)]
            b = 128 * n
            codes[:, b + 0:b + 32] = (qln[:, :32] & 0x0F) | ((qhn & 3) << 4)
            codes[:, b + 32:b + 64] = (qln[:, 32:] & 0x0F) | (((qhn >> 2) & 3) << 4)
            codes[:, b + 64:b + 96] = (qln[:, :32] >> 4) | (((qhn >> 4) & 3) << 4)
            codes[:, b + 96:b + 128] = (qln[:, 32:] >> 4) | (((qhn >> 6) & 3) << 4)
        return codes, d[:, None] * sc.astype(np.float32)

    def q4_k_to_quantized(self, name: str):
        """Q4_K matmul weight -> (wq (K, M) uint8, scales (K/32, M) f32,
        sub (K/32, M) f32) EXACTLY -- the Q4_K affine block model
        w = d*sc6*q - dmin*m6 is literally this framework's dequant
        contract (Wdq = scales*wq - sub) at group_size 32, so real
        llama.cpp K-quant artifacts convert losslessly (no requantization),
        like the Q4_0 path."""
        return tuple(t.numpy() for t in self._q4_k_quantized(name, "cpu"))

    def _q4_k_quantized(self, name: str, device):
        """q4_k_to_quantized's arrays as torch tensors, decoded and
        transposed on `device`."""
        info = self.tensors[name]
        assert info["type"] == GGML_Q4_K, _TYPE_NAMES.get(info["type"])
        K, M = info["dims"][0], info["dims"][1]
        codes, scales, mins = self._q4_k_fields(self.tensor_on(name, device))
        return (codes.reshape(M, K).t().contiguous(),
                scales.reshape(M, K // 32).t().contiguous(),
                mins.reshape(M, K // 32).t().contiguous())

    def q2_k_to_quantized(self, name: str):
        """Q2_K matmul weight -> (wq (K, M) uint8 0..3, scales (K/16, M)
        f32, sub (K/16, M) f32) EXACTLY -- Q2_K's per-16 affine model
        w = d*sc4*q - dmin*m4 is this framework's dequant contract at
        group_size 16, so llama.cpp 2-bit artifacts run natively on the
        2-bit LUT kernels with no requantization."""
        return tuple(t.numpy() for t in self._q2_k_quantized(name, "cpu"))

    def _q2_k_quantized(self, name: str, device):
        """q2_k_to_quantized's arrays as torch tensors, decoded and
        transposed on `device`."""
        info = self.tensors[name]
        assert info["type"] == GGML_Q2_K, _TYPE_NAMES.get(info["type"])
        K, M = info["dims"][0], info["dims"][1]
        codes, scales, mins = self._q2_k_fields(self.tensor_on(name, device))
        return (codes.reshape(M, K).t().contiguous(),
                scales.reshape(M, K // 16).t().contiguous(),
                mins.reshape(M, K // 16).t().contiguous())

    def q3_k_to_quantized(self, name: str):
        """Q3_K matmul weight -> (wq (K, M) uint8 0..7, scales (K/16, M)
        f32, sub (K/16, M) f32) EXACTLY: w = sc*(q-4) == scales*wq - sub
        with sub = 4*sc (signed per-16 scales are plain floats to the
        kernel's epilogue algebra), so llama.cpp 3-bit artifacts run
        natively on the b3 bit-plane kernels."""
        info = self.tensors[name]
        assert info["type"] == GGML_Q3_K, _TYPE_NAMES.get(info["type"])
        K, M = info["dims"][0], info["dims"][1]
        codes, scales = self._q3_k_fields(self.tensor_bytes(name))
        wq = codes.reshape(M, K).T.copy()
        sc = scales.reshape(M, K // 16).T.copy()
        return wq, sc, 4.0 * sc

    def ternary_block_scales(self, name: str) -> Optional[np.ndarray]:
        """Per-256-block fp16 scales of a TQ tensor (None for I2_S, which
        is per-tensor by construction).  Cheap: reads only the d fields."""
        info = self.tensors[name]
        t = info["type"]
        if t == GGML_I2_S:
            return None
        step = 54 if t == GGML_TQ1_0 else 66
        blk = self.tensor_bytes(name).reshape(-1, step)
        return blk[:, step - 2:step].copy().view(np.float16).reshape(-1)

    def ternary_to_quantized(self, name: str):
        """Ternary tensor -> (wq (K, M) uint8 codes {1,2,3}, scales, sub,
        group_size, per_tensor) in this framework's kernel layout
        (Wdq = scales*wq - sub, mid = 2 -- the convert/bitnet.py encoding).

        TQ1_0/TQ2_0 carry per-256-block fp16 scales; when all blocks agree
        (the BitNet case: ternary * per-tensor scale survives block
        quantization with every d equal) the tensor maps onto per-tensor
        scales and the exact-int32 w_a8 path.  Otherwise it maps onto
        grouped scales with group_size=256.
        """
        info = self.tensors[name]
        t = info["type"]
        K, M = info["dims"][0], info["dims"][1]  # ne0 = in, ne1 = out
        raw = self.tensor_bytes(name)
        if t == GGML_I2_S:
            trits, scale = self._i2_s_fields(raw, K * M)
            wq = (trits.reshape(M, K).T + 1).astype(np.uint8)
            scales = np.full((1, M), scale, np.float32)
            return wq, scales, 2.0 * scales, K, True
        if t == GGML_TQ1_0:
            trits, d = self._tq1_0_fields(raw)
        elif t == GGML_TQ2_0:
            trits, d = self._tq2_0_fields(raw)
        else:
            raise NotImplementedError(_TYPE_NAMES.get(t, str(t)))
        wq = (trits.reshape(M, K).T + 1).astype(np.uint8)
        db = d.astype(np.float32).reshape(M, K // 256)
        if np.all(db == db[:, :1]):  # uniform block scales -> per-tensor
            scales = db[:, 0][None, :].copy()  # (1, M)
            return wq, scales, 2.0 * scales, K, True
        scales = db.T.copy()  # (K//256, M)
        return wq, scales, 2.0 * scales, 256, False

    @staticmethod
    def _q4_0_fields(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(per-block uint8 codes (nblocks, 32) in element order, d fp16)."""
        blk = raw.reshape(-1, 18)
        d = blk[:, :2].copy().view(np.float16).reshape(-1)
        qs = blk[:, 2:]
        lo = qs & 0x0F          # elements 0..15
        hi = qs >> 4            # elements 16..31
        return np.concatenate([lo, hi], axis=1), d

    @staticmethod
    def _q4_1_fields(raw: np.ndarray):
        """Q4_1 blocks -> (codes (nblocks, 32) uint8 0..15, d fp16, m fp16);
        w = q * d + m."""
        blk = raw.reshape(-1, 20)
        d = blk[:, :2].copy().view(np.float16).reshape(-1)
        m = blk[:, 2:4].copy().view(np.float16).reshape(-1)
        qs = blk[:, 4:]
        return np.concatenate([qs & 0x0F, qs >> 4], axis=1), d, m

    @staticmethod
    def _q5_0_fields(raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Q5_0 blocks -> (codes (nblocks, 32) uint8 0..31, d fp16).
        Element i's 5th bit is bit i of the little-endian qh word
        (dequantize_row_q5_0: xh_0 = (qh >> j) & 1, xh_1 = bit j+16)."""
        blk = raw.reshape(-1, 22)
        d = blk[:, :2].copy().view(np.float16).reshape(-1)
        qh = blk[:, 2:6].copy().view(np.uint32).reshape(-1)
        qs = blk[:, 6:]
        lo = np.concatenate([qs & 0x0F, qs >> 4], axis=1)  # element order
        hi = ((qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1)
        return (lo | (hi.astype(np.uint8) << 4)), d

    @staticmethod
    def _q5_1_fields(raw: np.ndarray):
        """Q5_1 blocks -> (codes (nblocks, 32) uint8 0..31, d fp16, m fp16);
        w = q * d + m (affine, min offset stored directly)."""
        blk = raw.reshape(-1, 24)
        d = blk[:, :2].copy().view(np.float16).reshape(-1)
        m = blk[:, 2:4].copy().view(np.float16).reshape(-1)
        qh = blk[:, 4:8].copy().view(np.uint32).reshape(-1)
        qs = blk[:, 8:]
        lo = np.concatenate([qs & 0x0F, qs >> 4], axis=1)
        hi = ((qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1)
        return (lo | (hi.astype(np.uint8) << 4)), d, m

    def q8_0_to_quantized(self, name: str):
        """Q8_0 matmul weight -> (wq, scales, sub) EXACTLY onto the bits=8
        path (w = d*q; biased codes wq = q + 128, sub = 128*d).  8-bit
        artifacts then run the int8 MXU kernel losslessly instead of the
        4-bit requantize fallback."""
        return tuple(t.numpy() for t in self._q8_0_quantized(name, "cpu"))

    def _q8_0_quantized(self, name: str, device):
        """q8_0_to_quantized's arrays as torch tensors, decoded and
        transposed on `device`."""
        info = self.tensors[name]
        assert info["type"] == GGML_Q8_0, _TYPE_NAMES.get(info["type"])
        K, M = info["dims"][0], info["dims"][1]
        blk = self.tensor_on(name, device).reshape(-1, 34)
        d = blk[:, :2].contiguous().view(torch.float16).reshape(-1).float()
        wq = (blk[:, 2:].contiguous().view(torch.int8).to(torch.int16) + 128).to(torch.uint8)
        scales = d.reshape(M, K // 32).t().contiguous()
        return wq.reshape(M, K).t().contiguous(), scales, 128.0 * scales

    def q4_1_to_quantized(self, name: str):
        """Q4_1 matmul weight -> (wq, scales, sub) EXACTLY: the affine
        block model w = d*q + m IS the framework contract scale*wq - sub
        with scales = d, sub = -m (cf. q4_0_to_quantized)."""
        info = self.tensors[name]
        assert info["type"] == GGML_Q4_1, _TYPE_NAMES.get(info["type"])
        K, M = info["dims"][0], info["dims"][1]
        codes, d, m = self._q4_1_fields(self.tensor_bytes(name))
        wq = codes.reshape(M, K).T.copy()
        scales = d.astype(np.float32).reshape(M, K // 32).T.copy()
        sub = -m.astype(np.float32).reshape(M, K // 32).T.copy()
        return wq.astype(np.uint8), scales, sub

    def q4_0_to_quantized(self, name: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Q4_0 matmul weight -> (wq (K, M) uint8, scales (K/32, M) f32,
        sub (K/32, M) f32) in this framework's kernel layout, exactly
        (no dequant round-trip).

        gguf stores weight rows (out-feature m) contiguous over in-feature
        k with quant blocks along k -- transpose to (K, M).
        """
        info = self.tensors[name]
        assert info["type"] == GGML_Q4_0, _TYPE_NAMES.get(info["type"])
        K, M = info["dims"][0], info["dims"][1]  # ne0 = in, ne1 = out
        wq_codes, d = self._q4_0_fields(self.tensor_bytes(name))
        wq = wq_codes.reshape(M, K).T.copy()  # (K, M) uint8 codes 0..15
        scales = d.astype(np.float32).reshape(M, K // 32).T.copy()
        sub = 8.0 * scales
        return wq.astype(np.uint8), scales, sub

    def close(self):
        self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------------
# Model conversion
# ---------------------------------------------------------------------------

def model_config_from_gguf(r: GGUFReader, name: str = "gguf-model"):
    """The ModelConfig a gguf file describes: shapes and rope from the
    metadata, the quant form from the first layer's matmul type."""
    from tmac_tpu_torch.models.config import ModelConfig, QuantConfig
    md = r.metadata
    arch = md.get("general.architecture", "llama")
    def g(key, default=None):
        v = md.get(f"{arch}.{key}", default)
        assert v is not None, f"gguf metadata missing {arch}.{key}"
        return v
    heads = g("attention.head_count")
    emb = g("embedding_length")
    vocab = md.get(f"{arch}.vocab_size")
    if vocab is None:
        vocab = r.tensors["token_embd.weight"]["dims"][1]
    # quant mode from the matmul tensor types: ternary (BitNet i2/tq1_0/
    # tq2_0 artifacts, reference run_pipeline.py:375) -> the w_a8
    # per-tensor exact-int path; Q4_0 et al. -> the grouped w_fp path
    n_expert = int(md.get(f"{arch}.expert_count", 0) or 0)
    for t0name in ("blk.0.ffn_gate.weight", "blk.0.ffn_gate_exps.weight",
                   "blk.0.attn_q.weight"):
        if t0name in r.tensors:
            break
    t0 = r.tensors.get(t0name, {})
    if t0.get("type") in TERNARY_TYPES:
        d = r.ternary_block_scales(t0name)
        if d is None or np.all(d == d[0]):
            # true BitNet artifact: ternary * per-tensor scale -> the
            # exact-int32 w_a8 path
            quant = QuantConfig(bits=2, group_size=-1, zero_point=False,
                                mode="w_a8")
        else:
            # per-block scales genuinely differ -> grouped dequant model
            quant = QuantConfig(bits=2, group_size=256, zero_point=False,
                                mode="w_fp")
    elif t0.get("type") == GGML_Q2_K:
        quant = QuantConfig(bits=2, group_size=16, zero_point=True,
                            mode="w_fp")
    elif t0.get("type") == GGML_Q3_K:
        quant = QuantConfig(bits=3, group_size=16, zero_point=True,
                            mode="w_fp")
    else:
        quant = QuantConfig(bits=4, group_size=32, zero_point=True,
                            mode="w_fp")
    return ModelConfig(
        name=name,
        vocab_size=int(vocab),
        hidden_size=int(emb),
        intermediate_size=int(g("feed_forward_length")),
        num_layers=int(g("block_count")),
        num_heads=int(heads),
        num_kv_heads=int(md.get(f"{arch}.attention.head_count_kv", heads)),
        head_dim=int(md.get(f"{arch}.attention.key_length", emb // heads)),
        rope_theta=float(md.get(f"{arch}.rope.freq_base", 10000.0)),
        max_position_embeddings=int(
            md.get(f"{arch}.context_length", 4096)),
        rope_scaling=_rope_scaling_from_gguf(r, arch),
        sliding_window=int(
            md.get(f"{arch}.attention.sliding_window", 0) or 0),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        tie_word_embeddings="output.weight" not in r.tensors,
        # qwen-family artifacts carry QKV biases as separate tensors
        attention_bias="blk.0.attn_q.bias" in r.tensors,
        num_experts=n_expert,
        num_experts_per_tok=int(md.get(f"{arch}.expert_used_count", 2)),
        moe_intermediate_size=int(
            md.get(f"{arch}.expert_feed_forward_length",
                   g("feed_forward_length"))) if n_expert else 0,
        # qwen2moe: all-expert-softmax routing (norm_topk_prob=False) + a
        # gated shared expert (ffn_*_shexp tensors)
        moe_norm_topk=arch != "qwen2moe",
        moe_shared_intermediate_size=int(
            md.get(f"{arch}.expert_shared_feed_forward_length", 0) or 0)
        if n_expert else 0,
        moe_shared_gate=arch == "qwen2moe" and bool(
            md.get(f"{arch}.expert_shared_feed_forward_length", 0)),
        quant=quant,
    )


def _rope_scaling_from_gguf(r: GGUFReader, arch: str):
    """gguf rope scaling -> ModelConfig.rope_scaling tuple.  Precedence:
    a rope_freqs.weight tensor (per-dim frequency divisors -- how
    llama.cpp stores llama-3.1's piecewise scaling) over the
    rope.scaling.* metadata keys (linear/yarn)."""
    if "rope_freqs.weight" in r.tensors:
        f = r.dequantized("rope_freqs.weight").reshape(-1)
        return ("factors", tuple(float(v) for v in f))
    md = r.metadata
    st = md.get(f"{arch}.rope.scaling.type")
    fac = md.get(f"{arch}.rope.scaling.factor")
    if not st or st == "none" or not fac:
        return None
    if st == "linear":
        return ("linear", float(fac))
    if st == "yarn":
        return ("yarn", float(fac), int(md.get(
            f"{arch}.rope.scaling.original_context_length", 4096)))
    raise NotImplementedError(f"rope scaling type {st!r}")


def _qt_from_gguf(r: GGUFReader, name: str, tp_m: int, tp_k: int,
                  force_requant: bool = False, device="cuda"):
    """One gguf matmul tensor -> a QuantizedTensor on `device`, the JAX
    package's form for its type (module docstring)."""
    from tmac_tpu_torch.ops.packing import quantize_weights
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor

    def qt(wq, scales, sub, bits, gs, scale_dtype=torch.float32):
        return QuantizedTensor.from_quantized(
            wq, scales, sub, bits=bits, group_size=gs, k_shards=tp_k,
            m_shards=tp_m, scale_dtype=scale_dtype, device=device)

    def _requant():
        # dequantize then requantize at 4 bits (zero_point affine): the
        # types whose codes and scales the kernels' layouts do not take
        w = r.dequantized(name).T  # (K, M)
        wq, scales, sub = quantize_weights(w, 4, 32, True)
        return qt(wq, scales, sub, 4, 32, torch.bfloat16)

    if force_requant:
        return _requant()
    t = r.tensors[name]["type"]
    if t in TERNARY_TYPES:
        wq, scales, sub, gs, per_tensor = r.ternary_to_quantized(name)
        if per_tensor and tp_k > 1:
            # one scale row per K-shard (see convert/bitnet.py)
            scales = np.repeat(scales, tp_k, 0)
            sub = np.repeat(sub, tp_k, 0)
            gs = wq.shape[0] // tp_k
        # f32 in both branches: the grouped block scales are fp16
        return qt(wq, scales, sub, 2, gs)
    on_device = {GGML_Q4_K: (r._q4_k_quantized, 4, 32),
                 GGML_Q2_K: (r._q2_k_quantized, 2, 16),
                 GGML_Q8_0: (r._q8_0_quantized, 8, 32)}
    if t in on_device:
        # decoded and transposed on the device, not on the host (f32
        # scales, as below)
        fields, bits, gs = on_device[t]
        return qt(*fields(name, device), bits, gs)
    exact = {GGML_Q4_0: (r.q4_0_to_quantized, 4, 32),
             GGML_Q4_1: (r.q4_1_to_quantized, 4, 32),
             GGML_Q3_K: (r.q3_k_to_quantized, 3, 16)}
    if t in exact:
        # f32 scales: fp16 block scales (10 mantissa bits) would not
        # round-trip through bf16 (7 bits)
        fields, bits, gs = exact[t]
        return qt(*fields(name), bits, gs)
    # Q5_0/Q5_1/Q5_K/Q6_K matmul tensors (llama.cpp's Q4_K_M and Q3_K_M
    # mixes store ffn_down/attn_v this way) re-quantize to the 4-bit class
    return _requant()


def _fuse_qts_from_gguf(r: GGUFReader, names, tp_m: int, tp_k: int,
                        device="cuda"):
    """fuse_m requires one bit-width across the fused components; a
    mixed-type artifact (e.g. Q8_0 attn_v beside Q4_K attn_q) re-quantizes
    every component to the uniform 4-bit class instead."""
    from tmac_tpu_torch.ops.qgemm import fuse_m
    qts = [_qt_from_gguf(r, n, tp_m, tp_k, device=device) for n in names]
    if len({(q.bits, q.group_size) for q in qts}) > 1:
        qts = [_qt_from_gguf(r, n, tp_m, tp_k, force_requant=True, device=device)
               for n in names]
    return fuse_m(qts)


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def convert_gguf_model(path: str, tp: int = 1, name: str = "gguf-model",
                       device="cuda"):
    """gguf file (a llama-family model: dense, Mixtral-style MoE, qwen2moe's
    shared expert) -> (ModelConfig, params) on `device`, byte for byte the
    JAX package's.  tp > 1 packs the shards as the JAX package does (q/k/v
    and gate/up m-sharded, wo and down k-sharded); running such params
    needs tensor parallelism, which the PyTorch package has not yet.  The
    layers are converted on a few threads (numpy and the packer release
    the interpreter lock), each one's tensors moved to `device` as made."""
    from tmac_tpu_torch.models.llama import make_head
    from tmac_tpu_torch.models.moe import stack_experts
    r = GGUFReader(path)
    cfg = model_config_from_gguf(r, name=name)

    def bf16(n):
        return torch.from_numpy(np.ascontiguousarray(r.dequantized(n))) \
            .to(torch.bfloat16).to(device)

    def lin(n, tp_m, tp_k):
        return _qt_from_gguf(r, n, tp_m, tp_k, device=device)

    def fused(names):
        return _fuse_qts_from_gguf(r, names, tp, 1, device=device)

    def build_layer(i):
        p = f"blk.{i}"
        layer = {
            "attn_norm": bf16(f"{p}.attn_norm.weight"),
            "mlp_norm": bf16(f"{p}.ffn_norm.weight"),
            "wqkv": fused([f"{p}.attn_q.weight", f"{p}.attn_k.weight",
                           f"{p}.attn_v.weight"]),
            "wo": lin(f"{p}.attn_output.weight", 1, tp),
        }
        if cfg.attention_bias:
            for gg, ours in (("attn_q", "bq"), ("attn_k", "bk"),
                             ("attn_v", "bv")):
                bn = f"{p}.{gg}.bias"
                if bn in r.tensors:
                    layer[ours] = bf16(bn).reshape(-1)
        if cfg.num_experts > 0:
            # llama.cpp MoE: router ffn_gate_inp (E, H) + 3-D stacked
            # expert tensors ffn_{gate,up,down}_exps (models/moe.py)
            layer["moe_router"] = torch.from_numpy(np.ascontiguousarray(
                r.dequantized(f"{p}.ffn_gate_inp.weight").T)).to(torch.bfloat16).to(device)
            gv = r.expert_views(f"{p}.ffn_gate_exps.weight")
            uv = r.expert_views(f"{p}.ffn_up_exps.weight")
            dv = r.expert_views(f"{p}.ffn_down_exps.weight")
            layer["experts_gate_up"] = stack_experts([
                fused([gv[e], uv[e]]) for e in range(cfg.num_experts)])
            layer["experts_down"] = stack_experts([
                lin(dv[e], 1, tp) for e in range(cfg.num_experts)])
            if f"{p}.ffn_gate_shexp.weight" in r.tensors:
                # qwen2moe shared expert (+ its sigmoid gate vector)
                layer["shared_gate_up"] = fused([f"{p}.ffn_gate_shexp.weight",
                                                 f"{p}.ffn_up_shexp.weight"])
                layer["shared_down"] = lin(f"{p}.ffn_down_shexp.weight", 1, tp)
                sg = f"{p}.ffn_gate_inp_shexp.weight"
                if sg in r.tensors:
                    layer["shared_gate"] = bf16(sg).reshape(-1)
        else:
            layer["gate_up"] = fused([f"{p}.ffn_gate.weight", f"{p}.ffn_up.weight"])
            layer["down"] = lin(f"{p}.ffn_down.weight", 1, tp)
        return layer

    with ThreadPoolExecutor(_workers()) as ex:
        layers = list(ex.map(build_layer, range(cfg.num_layers)))
    params: Dict[str, Any] = {
        "embed": bf16("token_embd.weight"),
        "layers": layers,
        "final_norm": bf16("output_norm.weight"),
    }
    if "output.weight" in r.tensors:
        params["lm_head"] = make_head(r.dequantized("output.weight").T, cfg,
                                      device=device)
    r.close()
    return cfg, params


# ---------------------------------------------------------------------------
# Minimal writer (tests + interchange)
# ---------------------------------------------------------------------------

def _pack_q4_0(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> Q4_0 blocks (llama.cpp quantize_row_q4_0 semantics:
    d = absmax/-8 signed, q = clip(round(w/d) + 8, 0, 15))."""
    M, K = w_mk.shape
    assert K % 32 == 0
    blocks = w_mk.reshape(M * K // 32, 32).astype(np.float32)
    amax_idx = np.argmax(np.abs(blocks), axis=1)
    maxv = blocks[np.arange(len(blocks)), amax_idx]
    d = maxv / -8.0
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    q = np.clip(np.trunc(blocks * inv[:, None] + 8.5), 0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = (lo | (hi << 4)).astype(np.uint8)
    out = np.empty((len(blocks), 18), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:] = qs
    return out.tobytes()


def _pack_tq1_0(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> TQ1_0 blocks (llama.cpp quantize_row_tq1_0_ref
    semantics; see GGUFReader._tq1_0_fields for the digit layout)."""
    M, K = w_mk.shape
    assert K % 256 == 0
    blocks = w_mk.reshape(M * K // 256, 256).astype(np.float32)
    d = np.abs(blocks).max(axis=1)
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    t = (np.clip(np.rint(blocks * inv[:, None]), -1, 1) + 1).astype(np.uint32)
    out = np.zeros((len(blocks), 54), np.uint8)
    # qs[0:32]: elements m + 32n, base-3 with t(n=0) most significant
    q = np.zeros((len(blocks), 32), np.uint32)
    for n in range(5):
        q = q * 3 + t[:, 32 * n:32 * (n + 1)]
    out[:, :32] = (q * 256 + 242) // 243
    q = np.zeros((len(blocks), 16), np.uint32)
    for n in range(5):
        q = q * 3 + t[:, 160 + 16 * n:160 + 16 * (n + 1)]
    out[:, 32:48] = (q * 256 + 242) // 243
    q = np.zeros((len(blocks), 4), np.uint32)
    for n in range(4):
        q = q * 3 + t[:, 240 + 4 * n:240 + 4 * (n + 1)]
    out[:, 48:52] = (q * 256 + 80) // 81
    out[:, 52:54] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def _pack_tq2_0(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> TQ2_0 blocks (llama.cpp quantize_row_tq2_0_ref)."""
    M, K = w_mk.shape
    assert K % 256 == 0
    blocks = w_mk.reshape(M * K // 256, 256).astype(np.float32)
    d = np.abs(blocks).max(axis=1)
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    t = (np.clip(np.rint(blocks * inv[:, None]), -1, 1) + 1).astype(np.uint8)
    out = np.zeros((len(blocks), 66), np.uint8)
    for j in (0, 32):
        q = np.zeros((len(blocks), 32), np.uint8)
        for n in range(4):
            q |= t[:, j * 4 + 32 * n:j * 4 + 32 * (n + 1)] << (2 * n)
        out[:, j:j + 32] = q
    out[:, 64:66] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def _pack_q4_1(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> Q4_1 blocks (affine: d = (max-min)/15, m = min)."""
    M, K = w_mk.shape
    assert K % 32 == 0
    blocks = w_mk.reshape(M * K // 32, 32).astype(np.float32)
    mn, mx = blocks.min(axis=1), blocks.max(axis=1)
    d = (mx - mn) / 15.0
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    q = np.clip(np.trunc((blocks - mn[:, None]) * inv[:, None] + 0.5),
                0, 15).astype(np.uint8)
    out = np.empty((len(blocks), 20), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.tobytes()


def _pack_q5_0(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> Q5_0 blocks (quantize_row_q5_0: d = signed absmax
    / -16, q = clip(trunc(w/d + 16.5), 0, 31), bit 4 in the qh word)."""
    M, K = w_mk.shape
    assert K % 32 == 0
    blocks = w_mk.reshape(M * K // 32, 32).astype(np.float32)
    amax_idx = np.argmax(np.abs(blocks), axis=1)
    maxv = blocks[np.arange(len(blocks)), amax_idx]
    d = maxv / -16.0
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    q = np.clip(np.trunc(blocks * inv[:, None] + 16.5), 0, 31).astype(np.uint8)
    qh = np.zeros((len(blocks),), np.uint32)
    for i in range(32):
        qh |= ((q[:, i] >> 4).astype(np.uint32)) << np.uint32(i)
    out = np.empty((len(blocks), 22), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:6] = qh[:, None].view(np.uint8)
    out[:, 6:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.tobytes()


def _pack_q5_1(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> Q5_1 blocks (affine: d = (max-min)/31, m = min)."""
    M, K = w_mk.shape
    assert K % 32 == 0
    blocks = w_mk.reshape(M * K // 32, 32).astype(np.float32)
    mn, mx = blocks.min(axis=1), blocks.max(axis=1)
    d = (mx - mn) / 31.0
    inv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    q = np.clip(np.trunc((blocks - mn[:, None]) * inv[:, None] + 0.5),
                0, 31).astype(np.uint8)
    qh = np.zeros((len(blocks),), np.uint32)
    for i in range(32):
        qh |= ((q[:, i] >> 4).astype(np.uint32)) << np.uint32(i)
    out = np.empty((len(blocks), 24), np.uint8)
    out[:, :2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:8] = qh[:, None].view(np.uint8)
    out[:, 8:] = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    return out.tobytes()


def _pack_q3_k(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> Q3_K super-blocks (block model of
    dequantize_row_q3_K: per-16 symmetric q in [-4,3], 6-bit scales
    biased +32 x fp16 super scale)."""
    M, K = w_mk.shape
    assert K % 256 == 0
    blocks = w_mk.reshape(-1, 256).astype(np.float32)
    g = blocks.reshape(-1, 16, 16)
    amax = np.abs(g).max(axis=2)
    sc_f = amax / 4.0
    d = sc_f.max(axis=1) / 31.0
    d_s = np.where(d == 0, 1.0, d)
    sc6 = np.clip(np.rint(sc_f / d_s[:, None]), -32, 31).astype(np.int8)
    eff = d[:, None] * sc6.astype(np.float32)
    eff_s = np.where(eff == 0, 1.0, eff)
    q = np.clip(np.rint(g / eff_s[:, :, None]), -4, 3)
    q = np.where(eff[:, :, None] == 0, 0, q)
    codes = (q + 4).astype(np.uint8).reshape(-1, 256)  # bit2 = hmask bit
    nb = blocks.shape[0]
    out = np.zeros((nb, 110), np.uint8)
    for n in (0, 1):
        chunk = np.zeros((nb, 32), np.uint8)
        for j in range(4):
            c = codes[:, 128 * n + 32 * j:128 * n + 32 * (j + 1)]
            chunk |= (c & 3) << (2 * j)
            out[:, 0:32] |= (c >> 2) << (4 * n + j)
        out[:, 32 + 32 * n:32 + 32 * (n + 1)] = chunk
    s = (sc6.astype(np.int16) + 32).astype(np.uint8)  # biased 6-bit
    b0 = (s[:, 0:4] & 0x0F) | ((s[:, 8:12] & 0x0F) << 4)
    b1 = (s[:, 4:8] & 0x0F) | ((s[:, 12:16] & 0x0F) << 4)
    b2 = ((s[:, 0:4] >> 4) | ((s[:, 4:8] >> 4) << 2)
          | ((s[:, 8:12] >> 4) << 4) | ((s[:, 12:16] >> 4) << 6))
    out[:, 96:100], out[:, 100:104], out[:, 104:108] = b0, b1, b2
    out[:, 108:110] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def _pack_q6_k(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> Q6_K super-blocks (block model of
    dequantize_row_q6_K: per-16 int8 scales x fp16 super scale)."""
    M, K = w_mk.shape
    assert K % 256 == 0
    blocks = w_mk.reshape(-1, 256).astype(np.float32)
    g = blocks.reshape(-1, 16, 16)
    amax = np.abs(g).max(axis=2)
    sc_f = amax / 31.0
    d = sc_f.max(axis=1) / 127.0
    d_s = np.where(d == 0, 1.0, d)
    sc8 = np.clip(np.rint(sc_f / d_s[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc8.astype(np.float32)
    eff_s = np.where(eff == 0, 1.0, eff)
    q = np.clip(np.rint(g / eff_s[:, :, None]), -32, 31)
    q = np.where(eff[:, :, None] == 0, 0, q)
    codes = (q + 32).astype(np.uint8).reshape(-1, 256)
    nb = blocks.shape[0]
    out = np.zeros((nb, 210), np.uint8)
    for n in (0, 1):
        b = 128 * n
        c0 = codes[:, b + 0:b + 32]
        c1 = codes[:, b + 32:b + 64]
        c2 = codes[:, b + 64:b + 96]
        c3 = codes[:, b + 96:b + 128]
        out[:, 64 * n:64 * n + 32] = (c0 & 0x0F) | ((c2 & 0x0F) << 4)
        out[:, 64 * n + 32:64 * n + 64] = (c1 & 0x0F) | ((c3 & 0x0F) << 4)
        out[:, 128 + 32 * n:128 + 32 * (n + 1)] = (
            (c0 >> 4) | ((c1 >> 4) << 2) | ((c2 >> 4) << 4) | ((c3 >> 4) << 6))
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d.astype(np.float16)[:, None].view(np.uint8)
    return out.tobytes()


def _pack_i2_s(w_mk: np.ndarray) -> bytes:
    """(M, K) float -> i2_s bytes (per-tensor absmax scale; layout in
    GGUFReader._i2_s_fields)."""
    flat = w_mk.reshape(-1).astype(np.float32)
    assert flat.size % 4 == 0
    scale = float(np.abs(flat).max()) or 1.0
    t = (np.clip(np.rint(flat / scale), -1, 1) + 1).astype(np.uint8)
    qs = np.zeros((flat.size // 4,), np.uint8)
    for n in range(4):
        qs |= t[n::4] << (2 * n)
    return qs.tobytes() + np.float32(scale).tobytes()


class Lazy:
    """A tensor of write_gguf made only when its turn comes: its logical
    shape, and a function that returns it (a float array of that shape),
    so that a model's tensors need not all be held at once."""

    def __init__(self, shape, make: Callable[[], np.ndarray]):
        self.shape = tuple(int(d) for d in shape)
        self.make = make


# ---------------------------------------------------------------------------
# Q8_0 and the K-quants' affine types pack in torch, on the tensor's device
# (a model's matmuls pack in a second on the card; numpy and host tensors go
# through torch on the CPU), to the JAX package's numpy bytes: the same IEEE
# steps in the same order, each division by a tensor (CUDA divides by a host
# scalar as a multiplication by its reciprocal), rint as round-half-even.
# ---------------------------------------------------------------------------

def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _f16_bytes(v: torch.Tensor) -> torch.Tensor:
    """(n,) f32 -> (n, 2) uint8: each value as fp16, little-endian."""
    return v.half().view(torch.uint8).reshape(-1, 2)


def _pack_q8_0(w: torch.Tensor) -> torch.Tensor:
    """(M, K) float -> Q8_0 blocks (quantize_row_q8_0: d = absmax/127),
    (blocks, 34) uint8."""
    blocks = w.reshape(-1, 32).float()
    d = _div(blocks.abs().amax(1), 127.0)
    one = torch.ones_like(d)
    inv = torch.where(d == 0, torch.zeros_like(d), one / torch.where(d == 0, one, d))
    q = torch.clamp(torch.round(blocks * inv[:, None]), -128, 127).to(torch.int8)
    return torch.cat([_f16_bytes(d), q.view(torch.uint8)], 1)


def _kq_affine(blocks: torch.Tensor, qmax: int):
    """Shared Q4_K/Q5_K quantizer: per-32 affine with 6-bit quantized
    scales/mins.  -> (q codes, sc6, m6, d, dmin)."""
    g = blocks.reshape(-1, 8, 32)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    mn = torch.minimum(g.amin(2), zero)          # llama.cpp forces min <= 0
    mx = g.amax(2)
    sc_f = _div(mx - mn, float(qmax))
    m_f = -mn
    d = _div(sc_f.amax(1), 63.0)
    dmin = _div(m_f.amax(1), 63.0)
    d_s = torch.where(d == 0, torch.ones_like(d), d)
    dm_s = torch.where(dmin == 0, torch.ones_like(dmin), dmin)
    sc6 = torch.clamp(torch.round(sc_f / d_s[:, None]), 0, 63).to(torch.uint8)
    m6 = torch.clamp(torch.round(m_f / dm_s[:, None]), 0, 63).to(torch.uint8)
    eff = d[:, None] * sc6
    eff_s = torch.where(eff == 0, torch.ones_like(eff), eff)
    q = torch.clamp(torch.round((g + (dmin[:, None] * m6)[:, :, None])
                                / eff_s[:, :, None]), 0, qmax)
    q = torch.where(eff[:, :, None] == 0, torch.zeros_like(q), q).to(torch.uint8)
    return q.reshape(-1, 256), sc6, m6, d, dmin


def _kq_pack_scales(sc6: torch.Tensor, m6: torch.Tensor) -> torch.Tensor:
    """Inverse of GGUFReader._kq_scale_min: (nb, 8) 6-bit values ->
    (nb, 12) packed bytes."""
    lo = (sc6[:, 0:4] & 63) | ((sc6[:, 4:8] >> 4) << 6)
    mid = (m6[:, 0:4] & 63) | ((m6[:, 4:8] >> 4) << 6)
    hi = (sc6[:, 4:8] & 0x0F) | ((m6[:, 4:8] & 0x0F) << 4)
    return torch.cat([lo, mid, hi], 1)


def _kq_blocks(w: torch.Tensor, qmax: int):
    """w (M, K) -> its super-blocks' _kq_affine and their first 16 bytes
    (fp16 d and dmin, the packed 6-bit scales and mins)."""
    if w.shape[1] % 256:
        raise ValueError(f"K-quants pack rows of a multiple of 256, not {w.shape[1]}")
    q, sc6, m6, d, dmin = _kq_affine(w.reshape(-1, 256).float(), qmax)
    return q, [_f16_bytes(d), _f16_bytes(dmin), _kq_pack_scales(sc6, m6)]


def _pack_q4_k(w: torch.Tensor) -> torch.Tensor:
    """(M, K) float -> Q4_K super-blocks (block model of
    dequantize_row_q4_K; simplified scale search), (nb, 144) uint8."""
    q, head = _kq_blocks(w, 15)
    qs = [q[:, 64 * c:64 * c + 32] | (q[:, 64 * c + 32:64 * c + 64] << 4) for c in range(4)]
    return torch.cat(head + qs, 1)


def _pack_q5_k(w: torch.Tensor) -> torch.Tensor:
    """(M, K) float -> Q5_K super-blocks, (nb, 176) uint8."""
    q, head = _kq_blocks(w, 31)
    qh = torch.zeros((q.shape[0], 32), dtype=torch.uint8, device=q.device)
    qs = []
    for c in range(4):
        lo = q[:, 64 * c:64 * c + 32]
        hi = q[:, 64 * c + 32:64 * c + 64]
        qh |= ((lo >> 4) << (2 * c)) | ((hi >> 4) << (2 * c + 1))
        qs.append((lo & 0x0F) | ((hi & 0x0F) << 4))
    return torch.cat(head + [qh] + qs, 1)


def _pack_q2_k(w: torch.Tensor) -> torch.Tensor:
    """(M, K) float -> Q2_K super-blocks (block model of
    dequantize_row_q2_K: per-16 affine, 4-bit scales/mins x fp16 super
    scales; simplified scale search), (nb, 84) uint8."""
    if w.shape[1] % 256:
        raise ValueError(f"K-quants pack rows of a multiple of 256, not {w.shape[1]}")
    g = w.reshape(-1, 16, 16).float()
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    mn = torch.minimum(g.amin(2), zero)
    mx = g.amax(2)
    sc_f = _div(mx - mn, 3.0)
    m_f = -mn
    d = _div(sc_f.amax(1), 15.0)
    dmin = _div(m_f.amax(1), 15.0)
    d_s = torch.where(d == 0, torch.ones_like(d), d)
    dm_s = torch.where(dmin == 0, torch.ones_like(dmin), dmin)
    sc4 = torch.clamp(torch.round(sc_f / d_s[:, None]), 0, 15).to(torch.uint8)
    m4 = torch.clamp(torch.round(m_f / dm_s[:, None]), 0, 15).to(torch.uint8)
    eff = d[:, None] * sc4
    eff_s = torch.where(eff == 0, torch.ones_like(eff), eff)
    q = torch.clamp(torch.round((g + (dmin[:, None] * m4)[:, :, None])
                                / eff_s[:, :, None]), 0, 3)
    codes = torch.where(eff[:, :, None] == 0, torch.zeros_like(q), q).to(torch.uint8)
    codes = codes.reshape(-1, 256)
    chunks = []
    for n in (0, 1):
        chunk = codes[:, 128 * n:128 * n + 32].clone()
        for j in range(1, 4):
            chunk |= codes[:, 128 * n + 32 * j:128 * n + 32 * (j + 1)] << (2 * j)
        chunks.append(chunk)
    return torch.cat([sc4 | (m4 << 4)] + chunks + [_f16_bytes(d), _f16_bytes(dmin)], 1)


_TORCH_PACKERS = {GGML_Q2_K: _pack_q2_k, GGML_Q4_K: _pack_q4_k, GGML_Q5_K: _pack_q5_k,
                  GGML_Q8_0: _pack_q8_0}


def _tensor_nbytes(ttype: int, shape) -> int:
    """The bytes a tensor of `shape` takes in a gguf file as ttype."""
    elems = int(np.prod(shape))
    if ttype == GGML_I2_S:
        return elems // 4 + 4
    bele, bbytes = _block_layout(ttype)
    return elems // bele * bbytes


_PACKERS = {GGML_Q4_0: _pack_q4_0, GGML_Q4_1: _pack_q4_1, GGML_Q5_0: _pack_q5_0,
            GGML_Q5_1: _pack_q5_1, GGML_Q3_K: _pack_q3_k,
            GGML_Q6_K: _pack_q6_k, GGML_TQ1_0: _pack_tq1_0, GGML_TQ2_0: _pack_tq2_0,
            GGML_I2_S: _pack_i2_s}


def _tensor_data(ttype: int, arr) -> bytes:
    """A tensor's bytes in the file: block-packed along its last axis
    (stacked expert tensors as stacked rows), or F32/F16 values; the torch
    packers' types packed on the tensor's own device."""
    if isinstance(arr, Lazy):
        arr = arr.make()
    if ttype in _TORCH_PACKERS:
        a = (arr.detach() if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(arr)))
        a = a.reshape(-1, a.shape[-1]) if a.ndim > 1 else a.reshape(1, -1)
        return _TORCH_PACKERS[ttype](a).cpu().numpy().tobytes()
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    arr = np.asarray(arr)
    if arr.ndim > 2:
        arr = arr.reshape(-1, arr.shape[-1])
    if ttype in _PACKERS:
        return _PACKERS[ttype](arr)
    if ttype == GGML_F32:
        return arr.astype(np.float32).tobytes()
    if ttype == GGML_F16:
        return arr.astype(np.float16).tobytes()
    raise NotImplementedError(ttype)


def write_gguf(path: str, metadata: Dict[str, Any], tensors: Dict[str, tuple]):
    """Write a gguf v3 file. tensors: name -> (ggml_type, array in logical
    (rows, cols) = (ne1, ne0) layout, float for the block types and
    F32/F16; a numpy array, a torch tensor or a Lazy).  The header first,
    the offsets following from the shapes; then the tensors in order,
    packed on a few threads with at most that many in flight, each written
    as it is ready."""
    def enc_str(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def enc_val(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", _T_BOOL) + struct.pack("<?", v)
        if isinstance(v, int):
            return struct.pack("<I", _T_U32) + struct.pack("<I", v)
        if isinstance(v, float):
            return struct.pack("<I", _T_F32) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", _T_STR) + enc_str(v)
        if isinstance(v, (list, tuple)):
            # tokenizer metadata arrays: tokens (str), scores (f32),
            # token_type (i32).  Element type from the first element
            # (empty -> str array, matching llama.cpp's encoder).
            if len(v) == 0 or isinstance(v[0], str):
                et, body = _T_STR, b"".join(enc_str(s) for s in v)
            elif isinstance(v[0], float):
                et = _T_F32
                body = struct.pack(f"<{len(v)}f", *v)
            elif isinstance(v[0], int):
                et = _T_I32
                body = struct.pack(f"<{len(v)}i", *v)
            else:
                raise TypeError(f"array element {type(v[0])}")
            return (struct.pack("<I", _T_ARR) + struct.pack("<I", et) +
                    struct.pack("<Q", len(v)) + body)
        raise TypeError(type(v))

    align = 32
    infos, off = [], 0
    for tname, (ttype, arr) in tensors.items():
        shape = arr.shape if hasattr(arr, "shape") else np.shape(arr)
        nbytes = _tensor_nbytes(ttype, shape)
        infos.append((tname, list(reversed(shape)), ttype, off, nbytes))  # ne0 first
        off += nbytes + (-(off + nbytes)) % align

    hdr = [GGUF_MAGIC, struct.pack("<I", 3),
           struct.pack("<Q", len(tensors)), struct.pack("<Q", len(metadata))]
    for k, v in metadata.items():
        hdr.append(enc_str(k))
        hdr.append(enc_val(v))
    for tname, dims, ttype, toff, _ in infos:
        hdr.append(enc_str(tname))
        hdr.append(struct.pack("<I", len(dims)))
        for d in dims:
            hdr.append(struct.pack("<Q", d))
        hdr.append(struct.pack("<I", ttype))
        hdr.append(struct.pack("<Q", toff))
    header = b"".join(hdr)
    items = list(tensors.values())
    workers = _workers()
    with open(path, "wb") as f, ThreadPoolExecutor(workers) as ex:
        f.write(header)
        f.write(b"\0" * ((-len(header)) % align))
        pending = [ex.submit(_tensor_data, *items[i]) for i in range(min(workers, len(items)))]
        for i, (tname, _, _, toff, nbytes) in enumerate(infos):
            data = pending.pop(0).result()
            if i + workers < len(items):
                pending.append(ex.submit(_tensor_data, *items[i + workers]))
            if len(data) != nbytes:
                raise ValueError(f"{tname}: {len(data)} bytes, its shape says {nbytes}")
            f.write(data)
            f.write(b"\0" * ((-(toff + nbytes)) % align))
