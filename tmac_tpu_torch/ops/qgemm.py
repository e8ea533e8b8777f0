"""Public mpGEMM op of the port: quantized-weight matmul on packed weights.

The PyTorch counterpart of ``tmac_tpu/ops/qgemm.py``.  Every
implementation computes C = x @ Wdq with

    Wdq[k, m] = scales[k // gs, m] * wq[k, m] - sub[k // gs, m]

  * "fused" -- the kernel that ``qgemm_pallas`` runs for act, x's dtype and the
               weights and the N rows of x (``route``), each with an
               optional rms_norm / SwiGLU prologue and residual epilogue:
               one scale row (per tensor, or per column at group_size
               -1), per-token int8 activations and an exact
               int32 dot: K1 (ops/cuda/qgemm_kernel.py) for N < 64, K3 from
               64 rows; grouped scales: K4 (ops/cuda/qgemm_grouped_kernel.py,
               int8 activations per (token, group), exact int32 dots per
               group, scales folded per group; K4L, its tensor-core form,
               from 64 rows) below 3 * group_size rows or with dispatch
               "chunk", K5 (the same module: bf16 activations
               times bf16 dequantized weights, one f32 dot) from 64 rows
               with dispatch "dequant", or from 3 * group_size rows by
               default; with act other than "fused" the forms whose
               activations reach the kernel from outside (``form``: E1 on
               K1 / K3, E2 and E3 on K4 / K4L, E4 on K5)
  * "torch" -- plain grouped dequant matmul (the ``qgemm_xla`` role)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from tmac_tpu_torch.ops import packing
from tmac_tpu_torch.utils import round_up


@dataclasses.dataclass
class QuantizedTensor:
    """A low-bit quantized weight matrix in packed layout (the JAX
    package's ``QuantizedTensor`` contract, byte for byte).

    packed:    uint8 (K//p, M_pad)  strided bit-field packing (ops/packing.py);
               for bits=3 the 2-bit low plane; for bits=8 signed int8 codes
    packed_hi: uint8 (K//8, M_pad)  1-bit high plane, bits=3 only, else None
    scales:    (G, M_pad)           per-k-group scales
    sub:       (G, M_pad)           zero offsets: Wdq = scales*wq - sub
    bits:      1 | 2 | 3 | 4 | 8
    group_size: k elements per scale group; per-tensor tensors store the
               per-shard padded K
    k_shards / m_shards: packing shard counts along K / M
    shape:     logical (K, M) before padding
    m_segments: fused tensors (fuse_m): per-component (M_logical,
               per-shard padded width); None for plain tensors
    """

    packed: torch.Tensor
    packed_hi: Optional[torch.Tensor]
    scales: torch.Tensor
    sub: torch.Tensor
    bits: int
    group_size: int
    k_shards: int
    m_shards: int
    shape: tuple
    m_segments: Optional[tuple] = None

    @property
    def kdim(self) -> int:
        return self.shape[0]

    @property
    def mdim(self) -> int:
        return self.shape[1]

    @property
    def mdim_padded(self) -> int:
        return self.packed.shape[-1]

    @property
    def kdim_padded(self) -> int:
        """Total K after per-shard zero padding (see from_quantized)."""
        p = 4 if self.bits == 3 else 8 // self.bits
        return self.packed.shape[-2] * p

    def to(self, device) -> "QuantizedTensor":
        hi = self.packed_hi.to(device) if self.packed_hi is not None else None
        return dataclasses.replace(
            self, packed=self.packed.to(device), packed_hi=hi,
            scales=self.scales.to(device), sub=self.sub.to(device))

    @classmethod
    def from_quantized(cls, wq: np.ndarray, scales: np.ndarray,
                       sub: np.ndarray, bits: int, group_size: int,
                       k_shards: int = 1, m_shards: int = 1,
                       scale_dtype=torch.float32,
                       device="cuda") -> "QuantizedTensor":
        """Pack biased-unsigned (K, M) weights + (G, M) scales/sub.

        Padding (zero-filled and transparent):
          * M: padded PER m-shard to a multiple of 128;
          * K: padded PER k-shard, to a multiple of 4 fields-per-byte for
            per-tensor tensors and of fields-per-byte x group_size for
            grouped ones.
        bits=8 stores signed codes (wq - 128) and folds the shift into sub.
        wq, scales and sub may be numpy arrays or torch tensors; they are
        padded and packed on their own device (the host's for numpy).
        """
        return cls(**_packed(*(a if isinstance(a, torch.Tensor)
                               else torch.from_numpy(np.ascontiguousarray(a))
                               for a in (wq, scales, sub)),
                             bits, group_size, k_shards, m_shards, scale_dtype, device))

    @classmethod
    def from_float(cls, w: np.ndarray, bits: int,
                   group_size: Optional[int] = None, zero_point: bool = False,
                   k_shards: int = 1, m_shards: int = 1,
                   **kw) -> "QuantizedTensor":
        """Quantize float (K, M) weights and pack."""
        K, M = w.shape
        group_size = group_size or K
        wq, scales, sub = packing.quantize_weights(np.asarray(w), bits,
                                                   group_size, zero_point)
        return cls.from_quantized(wq, scales, sub, bits, group_size,
                                  k_shards, m_shards, **kw)

    def localized(self, tp: int, axis: int) -> "QuantizedTensor":
        """The view one rank of tp holds of its shard (the arrays already
        its slice): axis 0, row-parallel (k-sharded), k_shards 1 and K / tp
        rows; axis 1, column-parallel (m-sharded), m_shards 1, M / tp columns
        and each fused component's width divided.  The group size needs no
        change: per-tensor tensors store the per-shard padded K."""
        if axis == 0:
            if self.k_shards != tp:
                raise ValueError(f"k_shards {self.k_shards} is not tp {tp}")
            return dataclasses.replace(self, k_shards=1, shape=(self.kdim // tp, self.mdim))
        if self.m_shards != tp:
            raise ValueError(f"m_shards {self.m_shards} is not tp {tp}")
        segs = None
        if self.m_segments is not None:
            segs = tuple((Mi // tp, mspi) for (Mi, mspi) in self.m_segments)
        return dataclasses.replace(self, m_shards=1, shape=(self.kdim, self.mdim // tp),
                                   m_segments=segs)

    def k_shard(self, s: int) -> "QuantizedTensor":
        """Shard s of a row-parallel tensor (k_shards > 1) as views of its
        packed and scale rows, localized: the tensor a rank holds."""
        S = self.k_shards

        def rows(a):
            n = a.shape[-2] // S
            return a[..., s * n:(s + 1) * n, :]
        hi = rows(self.packed_hi) if self.packed_hi is not None else None
        return dataclasses.replace(self, packed=rows(self.packed), packed_hi=hi,
                                   scales=rows(self.scales), sub=rows(self.sub)).localized(S, 0)

    def _k_pad_geometry(self):
        """(ks, ksp): per-shard logical and padded K."""
        return self.kdim // self.k_shards, self.kdim_padded // self.k_shards

    def slice_m(self, out: torch.Tensor) -> torch.Tensor:
        """Strip the per-m-shard padding off a (..., mdim_padded) tensor.

        For fused tensors this also re-orders the per-shard component
        interleave back to logical [comp0 | comp1 | ...] order.  When
        nothing is padded and there is one shard the layout already is
        logical and `out` comes back as it is."""
        lead = out.shape[:-1]
        if self.mdim_padded == self.mdim and (
                self.m_segments is None or self.m_shards == 1):
            return out
        if self.m_segments is not None:
            o = out.reshape(*lead, self.m_shards, -1)
            pieces, off = [], 0
            for (Mi, mspi) in self.m_segments:
                seg = o[..., off:off + mspi][..., : Mi // self.m_shards]
                pieces.append(seg.reshape(*lead, Mi))
                off += mspi
            return torch.cat(pieces, dim=-1)
        ms = self.mdim // self.m_shards
        msp = self.mdim_padded // self.m_shards
        o = out.reshape(*lead, self.m_shards, msp)[..., :ms]
        return o.reshape(*lead, self.mdim)

    def unpack(self) -> torch.Tensor:
        """Unpacked biased-unsigned weights as int8, logical (K, M) shape
        (bits=8: the signed codes)."""
        w = unpack_codes(self)
        ks, ksp = self._k_pad_geometry()
        if ksp != ks:
            w = w.reshape(self.k_shards, ksp, -1)[:, :ks].reshape(self.kdim, -1)
        return self.slice_m(w.reshape(self.kdim, -1))


def _pack_fields(wq: torch.Tensor, bits: int, k_shards: int) -> torch.Tensor:
    """packing.pack_strided on wq's device: (K, M) -> (K // p, M) uint8."""
    p = 8 // bits
    K, M = wq.shape
    w = wq.reshape(k_shards, p, K // k_shards // p, M)
    packed = torch.zeros((k_shards, K // k_shards // p, M), dtype=torch.uint8,
                         device=wq.device)
    for j in range(p):
        packed |= w[:, j] << (bits * j)
    return packed.reshape(K // p, M)


def _packed(wq, scales, sub, bits, group_size, k_shards, m_shards,
            scale_dtype, device) -> dict:
    """QuantizedTensor.from_quantized's padding and packing, on the
    tensors' device, moved to `device` after.  -> the QuantizedTensor's
    fields."""
    F = torch.nn.functional
    K, M = wq.shape
    per_tensor = group_size >= K // k_shards
    G = k_shards if per_tensor else K // group_size
    assert scales.shape == (G, M), (scales.shape, G, M)
    assert M % m_shards == 0, (M, m_shards)
    assert K % (k_shards if per_tensor else k_shards * group_size) == 0, (
        K, k_shards, group_size)
    assert int(wq.max()) < (1 << bits), "weight values exceed bit width"
    wq = wq.to(torch.uint8)
    ms = M // m_shards
    msp = round_up(ms, 128)
    if msp != ms:
        def _pad_m(a):
            a = F.pad(a.reshape(a.shape[0], m_shards, ms), (0, msp - ms))
            return a.reshape(a.shape[0], m_shards * msp)
        wq, scales, sub = _pad_m(wq), _pad_m(scales), _pad_m(sub)
    mpad = m_shards * msp
    pmax = 8 if bits == 3 else 8 // bits
    ks = K // k_shards
    ksp = round_up(ks, pmax * 4) if per_tensor else round_up(ks, pmax * group_size)
    if ksp != ks:
        wq = F.pad(wq.reshape(k_shards, ks, mpad), (0, 0, 0, ksp - ks))
        wq = wq.reshape(k_shards * ksp, mpad)
        if not per_tensor:
            gsh, gp = ks // group_size, ksp // group_size

            def _pad_g(a):
                a = F.pad(a.reshape(k_shards, gsh, mpad), (0, 0, 0, gp - gsh))
                return a.reshape(k_shards * gp, mpad)
            scales, sub = _pad_g(scales), _pad_g(sub)
    hi = None
    if bits == 3:
        lo = _pack_fields(wq & 0b11, 2, k_shards)
        hi = _pack_fields((wq >> 2) & 0b1, 1, k_shards)
    elif bits == 8:
        lo = ((wq.to(torch.int16) - 128) & 0xFF).to(torch.uint8)
        sub = sub - 128.0 * scales
    else:
        lo = _pack_fields(wq, bits, k_shards)

    def _t(a, dtype=None):
        return (a if dtype is None else a.float().to(dtype)).contiguous().to(device)
    return dict(packed=_t(lo), packed_hi=_t(hi) if hi is not None else None,
                scales=_t(scales, scale_dtype), sub=_t(sub, scale_dtype), bits=bits,
                group_size=group_size if not per_tensor else ksp, k_shards=k_shards,
                m_shards=m_shards, shape=(K, M))


def unpack_codes(qt: QuantizedTensor) -> torch.Tensor:
    """The padded (kdim_padded, mdim_padded) int8 weight codes as stored:
    biased-unsigned for bits < 8, signed for bits=8."""
    if qt.bits == 8:
        return qt.packed.view(torch.int8)

    def _un(pk, b):
        p = 8 // b
        KP, M = pk.shape
        pk = pk.reshape(qt.k_shards, KP // qt.k_shards, M)
        mask = (1 << b) - 1
        blocks = [(pk >> (b * j)) & mask for j in range(p)]
        return torch.cat(blocks, dim=1).reshape(KP * p, M)

    if qt.bits == 3:
        return (_un(qt.packed, 2) + (_un(qt.packed_hi, 1) << 2)).to(torch.int8)
    return _un(qt.packed, qt.bits).to(torch.int8)


def fuse_m(qts: list) -> QuantizedTensor:
    """Fuse QuantizedTensors sharing K into one along M (fused QKV/GateUp),
    components interleaved PER M-SHARD ([q_s0 k_s0 v_s0 | q_s1 ...])."""
    base = qts[0]
    for q in qts[1:]:
        assert q.kdim == base.kdim and q.kdim_padded == base.kdim_padded
        assert q.bits == base.bits and q.group_size == base.group_size
        assert q.k_shards == base.k_shards and q.m_shards == base.m_shards
        assert q.scales.shape[0] == base.scales.shape[0]
        assert q.m_segments is None, "cannot re-fuse a fused tensor"
    ms = base.m_shards

    def cat(arrs):
        arrs = [a.reshape(a.shape[0], ms, -1) for a in arrs]
        out = torch.cat(arrs, dim=2)
        return out.reshape(out.shape[0], -1)

    return QuantizedTensor(
        packed=cat([q.packed for q in qts]),
        packed_hi=cat([q.packed_hi for q in qts])
        if base.packed_hi is not None else None,
        scales=cat([q.scales for q in qts]),
        sub=cat([q.sub for q in qts]),
        bits=base.bits, group_size=base.group_size, k_shards=base.k_shards,
        m_shards=ms, shape=(base.kdim, sum(q.mdim for q in qts)),
        m_segments=tuple((q.mdim, q.mdim_padded // ms) for q in qts),
    )


def pad_x_for(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Zero-pad activations along K to match the per-shard K padding."""
    N = x.shape[0]
    if qt.kdim_padded == qt.kdim:
        return x
    ks, ksp = qt._k_pad_geometry()
    xr = x.reshape(N, qt.k_shards, ks)
    xr = torch.nn.functional.pad(xr, (0, ksp - ks))
    return xr.reshape(N, qt.kdim_padded)


def qgemm_torch(x: torch.Tensor, qt: QuantizedTensor,
                out_dtype=None) -> torch.Tensor:
    """Grouped dequant matmul in plain PyTorch (the ``qgemm_xla`` role).

    C[n,m] = sum_g scales[g,m] * (x_g @ wq_g)[n,m] - (sum_k x_g)[n] * sub[g,m].

    int8 x accumulates exactly: the integer dot runs as a float64 matmul
    (exact, |sum| < 2^53), then becomes int32, on CPU and CUDA alike."""
    x = pad_x_for(x, qt)
    N = x.shape[0]
    K, Mp = qt.kdim_padded, qt.mdim_padded
    G = K // qt.group_size
    wq = unpack_codes(qt)
    int_path = x.dtype == torch.int8
    xg = x.reshape(N, G, qt.group_size)
    wg = wq.reshape(G, qt.group_size, Mp)
    scales, sub = qt.scales.float(), qt.sub.float()
    if int_path:
        parts = torch.einsum("ngk,gkm->gnm", xg.double(), wg.double())
        parts = parts.to(torch.int32).float()
        xsums = xg.to(torch.int32).sum(-1).float()
    else:
        xf = xg.float()
        parts = torch.einsum("ngk,gkm->gnm", xf, wg.float())
        xsums = xf.sum(-1)
    acc = torch.einsum("gnm,gm->nm", parts, scales)
    acc = acc - torch.einsum("ng,gm->nm", xsums, sub)
    acc = qt.slice_m(acc)
    return acc.to(out_dtype or (torch.float32 if int_path else x.dtype))


def dequant_baseline_matmul(x: torch.Tensor, w_codes: torch.Tensor, scales: torch.Tensor,
                            sub: torch.Tensor, group_size: int) -> torch.Tensor:
    """The comparator of the JAX package's ``dequant_baseline_matmul``:
    weights stored a byte each (int8 codes, (K, M)), dequantized to bf16
    (Wdq = scales * w - sub per group of group_size rows, in f32, rounded
    to bf16), then one plain bf16 matmul with f32 sums (torch.matmul; on
    the card cuBLAS's).  The bf16 dequant yardstick of the port's timings:
    the reference's is f32, but an f32 matmul on the card runs on its CUDA
    cores, not its tensor cores.  -> (N, M) f32."""
    K, M = w_codes.shape
    w = w_codes.float().reshape(K // group_size, group_size, M)
    wdq = (w * scales.float()[:, None] - sub.float()[:, None]).reshape(K, M)
    return torch.matmul(x.to(torch.bfloat16), wdq.to(torch.bfloat16)).float()


def dequant_bf16(qt: QuantizedTensor) -> torch.Tensor:
    """The (Kp, Mp) bf16 dequantized weights of qt (every scale row, its
    padding included): dequant_baseline_matmul's weights, made once."""
    w = unpack_codes(qt).float()
    G = qt.scales.shape[0]
    w = w.reshape(G, -1, w.shape[-1]) * qt.scales.float()[:, None] - qt.sub.float()[:, None]
    return w.reshape(qt.kdim_padded, -1).to(torch.bfloat16)


# qgemm_pallas leaves its small-N kernels from this many rows of x
LARGE_N = 64
DISPATCHES = (None, "chunk", "dequant")
# qgemm_pallas's activation handling (its `act`)
ACTS = ("auto", "int8", "fused", "native")


def _dispatch(qt: QuantizedTensor, N: int, dispatch: Optional[str], mode: str) -> str:
    """The grouped kernel from LARGE_N rows, "chunk" (K4's function) or
    "dequant" (K5): dispatch where given, else the tune table's entry for
    mode ("fused", or "float" for activations from outside;
    ops/tune_table.py, read only where the file exists), else "dequant"
    from 3 * group_size rows."""
    from tmac_tpu_torch.ops import tune_table
    d = dispatch or tune_table.lookup_dispatch(qt.bits, qt.kdim_padded, qt.mdim_padded, N,
                                               qt.group_size, mode)
    return d or ("dequant" if N >= 3 * qt.group_size else "chunk")


def plan(qt: QuantizedTensor, N: int, act: str = "fused", x_int8: bool = False,
         dispatch: Optional[str] = None) -> Tuple[str, str]:
    """(form, kernel): what ``qgemm_pallas`` runs for qt, N rows of x, act
    and x's dtype, by its rule off the TPU.

    The form is "fused" (the in-kernel prologue), or one of those whose
    activations reach the kernel from outside:
      E1 -- int8 x, one scale row: an exact int32 dot (its int_acc branch);
      E2 -- int8 activations per group: int8 x with grouped scales as
            given, or float x quantized per activation group by an XLA
            prologue (act "int8", or "auto" on the chunk path, one scale
            row too);
      E3 -- act "native": float dots on x's own dtype, pinned to the
            chunk path unless dispatch is "dequant";
      E4 -- float x at the dequant dot (act "auto" from LARGE_N grouped
            rows where _dispatch's "float" rule says "dequant"), and act
            "native" with dispatch "dequant".
    The kernel: one scale row takes K3 from LARGE_N rows and K1 below
    (fused and E1); grouped scales take K5 from LARGE_N rows where the
    fused form's _dispatch says "dequant", and for E4; K4's function
    otherwise (E2, E3, the fused "chunk"): K4L, its tensor-core form, from
    LARGE_N rows, K4 below (E2 at one scale row and bits 8, one fold chunk,
    K4L at any N; E3 on f32 x, which qgemm_native tells by x's dtype, K4
    at any N)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, not {act!r}")
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, not {dispatch!r}")
    grouped, large = qt.scales.shape[0] > 1, N >= LARGE_N
    if act == "fused":
        if x_int8:
            raise ValueError("the fused kernels quantize float activations; int8 x takes "
                             "act='auto' (or impl='torch')")
        f = "fused"
    elif x_int8:
        f = "E2" if grouped else "E1"
    elif grouped and large and (dispatch == "dequant" if act == "native" else
                                act == "auto" and _dispatch(qt, N, dispatch, "float")
                                == "dequant"):
        f = "E4"
    else:
        f = "E3" if act == "native" else "E2"
    if f == "E4" or (f == "fused" and grouped and large
                     and _dispatch(qt, N, dispatch, "fused") == "dequant"):
        return f, "K5"
    if f == "E1" or (f == "fused" and not grouped):
        return f, "K3" if large else "K1"
    if f == "E2" and not grouped and qt.bits == 8:
        # one scale row at bits 8 is one fold chunk: K4L's one-unit fold
        return f, "K4L"
    return f, "K4L" if large else "K4"


def form(qt: QuantizedTensor, N: int, act: str = "fused", x_int8: bool = False,
         dispatch: Optional[str] = None) -> str:
    """The form of ``plan``: "fused", or E1-E4."""
    return plan(qt, N, act, x_int8, dispatch)[0]


def route(qt: QuantizedTensor, N: int, dispatch: Optional[str] = None,
          act: str = "fused", x_int8: bool = False) -> str:
    """The kernel of ``plan``: K1, K3, K4, K4L or K5."""
    return plan(qt, N, act, x_int8, dispatch)[1]


def effective_ags(qt: QuantizedTensor, act_gs: int) -> int:
    """The activation group size that ``qgemm_pallas`` keeps: act_gs when
    the scales are grouped (G > 1) and 0 < act_gs < group_size divides
    group_size, else 0 (any other value is ignored, not an error).  Only
    K4's function (K4, K4L) quantizes per activation group; K5 keeps float
    activations and the per-tensor kernels quantize per token."""
    if (act_gs and qt.scales.shape[-2] > 1 and 0 < act_gs < qt.group_size
            and qt.group_size % act_gs == 0):
        return act_gs
    return 0


def kernel_for(qt: QuantizedTensor, N: int, plain: bool = False,
               dispatch: Optional[str] = None, act_gs: int = 0,
               act: str = "fused", x_int8: bool = False):
    """The wrapper of ``plan``'s kernel, or with plain=True its plain
    PyTorch version.  Every quantized linear of the port takes its kernel
    here."""
    return _wrapper(qt, *plan(qt, N, act, x_int8, dispatch), plain, act_gs)


def _wrapper(qt: QuantizedTensor, f: str, kernel: str, plain: bool, act_gs: int):
    """The wrapper (or plain version) of form f on kernel.  The fused form:
    a function (x, qt, norm=, glu=, residual=) -> (N, M) f32; act_gs, the
    activation group size, bound into K4's and K4L's function (the others
    ignore it, as the reference does).  The other forms (no norm or glu
    fold): a function (x, qt, residual=) -> (N, M) f32, act_gs bound into
    E2's."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as grouped
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as per_tensor
    if f != "fused":
        fn = {
            "E1": (per_tensor.qgemm_int8_x, per_tensor.int8_x_plain),
            "E2": (grouped.qgemm_grouped_ext, grouped.grouped_ext_plain),
            "E3": (grouped.qgemm_native, grouped.native_plain),
            "E4": (grouped.qgemm_dequant_ext, grouped.dequant_ext_plain),
        }[f][int(plain)]
        return functools.partial(fn, act_gs=act_gs) if f == "E2" else fn
    fn = {
        "K1": (per_tensor.qgemm_fused, per_tensor.qgemm_fused_plain),
        "K3": (per_tensor.qgemm_large_int, per_tensor.qgemm_fused_plain),
        "K4": (grouped.qgemm_grouped, grouped.qgemm_grouped_plain),
        "K4L": (grouped.qgemm_grouped_large, grouped.qgemm_grouped_plain),
        "K5": (grouped.qgemm_dequant, grouped.qgemm_dequant_plain),
    }[kernel][int(plain)]
    if kernel in ("K4", "K4L") and effective_ags(qt, act_gs):
        return functools.partial(fn, act_gs=act_gs)
    return fn


def qgemm(x: torch.Tensor, qt: QuantizedTensor, impl: str = "auto",
          out_dtype=None, norm=None, glu: bool = False,
          residual=None, dispatch: Optional[str] = None,
          act_group_size: int = 0, act: str = "auto") -> torch.Tensor:
    """Quantized matmul x (N, K) @ Wdq (K, M) -> (N, M).

    impl: "fused" (the kernel that ``plan`` picks for act), "torch", or
    "auto": "fused" for any tensor off the CPU, whose kernels raise on
    what they do not take; on the CPU, the kernels' plain versions where
    they take the weights (grouped: bits 1 to 4 or 8, bf16 or f32 scales,
    group size 16 or a multiple of 32) and x (act "fused": float x), and
    "torch" otherwise.
    act: the reference's activation handling (``plan``'s form), with its default:
      "fused"  -- the activations quantized inside the kernel (K1, K3, K4,
                  K4L; K5 keeps them bf16), with the norm / glu folds; the
                  form every model linear takes;
      "int8"   -- float x quantized per activation group outside the
                  kernel, int8 dots with the scales folded per group (E2);
      "native" -- float dots on x's own dtype (E3; bf16 x on the card);
      "auto"   -- "int8", but float x stays float at the dequant dot from
                  64 grouped rows where the dispatch is "dequant" (E4).
    int8 x takes the exact int32 route (E1) or the grouped fold (E2) at
    any act but "fused".  JAX's ``block_m`` has no counterpart on the card
    (the plans' tile and cluster sizes are ops/tune_table.py's).
    norm: optional (weight (K,), eps) rms_norm applied to x first (act
    "fused" only, as the reference).
    glu: x is (N, 2K) and silu(x[:, :K]) * x[:, K:] feeds the matmul (act
    "fused" only).
    residual: optional (N, M) added to the output.
    dispatch: the grouped large-N kernel, as qgemm_pallas's argument:
    "chunk" (K4), "dequant" (K5) or None (the tune table's, then the
    N >= 3 * group_size rule); ignored below LARGE_N rows and for
    per-tensor scales.
    act_group_size: activation groups finer than the weight groups (the
    reference's -ags knob) on K4's function; ignored where
    ``effective_ags`` drops it, by K5 and by impl="torch".
    """
    grouped = qt.scales.shape[0] > 1
    x_int8 = x.dtype == torch.int8
    if impl == "auto":
        from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import weights_form_error
        on_cpu_kernel = (x.is_floating_point() or act != "fused") and (
            not grouped or weights_form_error(qt) is None)
        impl = ("fused" if x.device.type != "cpu" or on_cpu_kernel
                else "torch")
    out_dtype = out_dtype or (torch.float32 if x_int8 else x.dtype)
    if impl == "fused":
        f, kernel = plan(qt, x.shape[0], act, x_int8, dispatch)
        fn = _wrapper(qt, f, kernel, False, act_group_size)
        if f != "fused":
            if norm is not None or glu:
                raise ValueError("the norm and glu folds take act='fused'")
            return fn(x, qt, residual=residual).to(out_dtype)
        out = fn(x.to(torch.bfloat16), qt, norm=norm, glu=glu, residual=residual)
        return out.to(out_dtype)
    if impl != "torch":
        raise ValueError(f"unknown impl {impl}")
    if glu:
        K = qt.kdim
        g, u = x[:, :K].float(), x[:, K:].float()
        x = (g * torch.sigmoid(g) * u).to(x.dtype)
    if norm is not None:
        w_n, eps = norm
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        x = (xf * torch.rsqrt(var + eps) * w_n.float()).to(x.dtype)
    out = qgemm_torch(x, qt, out_dtype)
    if residual is not None:
        out = out + residual.to(out.dtype)
    return out
