"""Public mpGEMM op of the port: quantized-weight matmul on packed weights.

The PyTorch counterpart of ``tmac_tpu/ops/qgemm.py``.  Every
implementation computes C = x @ Wdq with

    Wdq[k, m] = scales[k // gs, m] * wq[k, m] - sub[k // gs, m]

  * "fused" -- the kernel that ``qgemm_pallas(act="fused")`` runs for the
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
               default
  * "torch" -- plain grouped dequant matmul (the ``qgemm_xla`` role)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

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


# qgemm_pallas leaves its small-N kernels from this many rows of x
LARGE_N = 64
DISPATCHES = (None, "chunk", "dequant")


def route(qt: QuantizedTensor, N: int, dispatch: Optional[str] = None) -> str:
    """The kernel that ``qgemm_pallas(act="fused")`` runs for qt and N rows
    of x, by its rule off the TPU (its tune table is keyed to a TPU):
    per-tensor scales take K3 from LARGE_N rows and K1 below; grouped
    scales take K5 from LARGE_N rows when dispatch is "dequant", or is None
    and N >= 3 * group_size, and K4's function otherwise ("chunk", or fewer
    rows): K4L, its tensor-core form, from LARGE_N rows, K4 below."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"dispatch must be one of {DISPATCHES}, not {dispatch!r}")
    if qt.scales.shape[0] == 1:
        return "K3" if N >= LARGE_N else "K1"
    if N >= LARGE_N and (dispatch or ("dequant" if N >= 3 * qt.group_size
                                      else "chunk")) == "dequant":
        return "K5"
    return "K4L" if N >= LARGE_N else "K4"


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
               dispatch: Optional[str] = None, act_gs: int = 0):
    """The wrapper of ``route``'s kernel, or with plain=True its plain
    PyTorch version: a function (x, qt, norm=, glu=, residual=) -> (N, M)
    f32.  act_gs: the activation group size, bound into K4's and K4L's
    function (the others ignore it, as the reference does).  Every
    quantized linear of the port takes its kernel here."""
    from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as grouped
    from tmac_tpu_torch.ops.cuda import qgemm_kernel as per_tensor
    kernel = route(qt, N, dispatch)
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
          act_group_size: int = 0) -> torch.Tensor:
    """Quantized matmul x (N, K) @ Wdq (K, M) -> (N, M).

    impl: "fused" (float x: the kernel ``route`` picks: K1 or K3 for
    one scale row, K4 or K5 for grouped ones), "torch", or "auto":
    "fused" for any tensor off the CPU, whose kernels raise on what they do
    not cover yet (int8 x); on the CPU, the kernels' plain versions for float x (grouped: bits 1 to 4 or 8, bf16 or
    f32 scales, group size 16 or a multiple of 32) and "torch" otherwise.
    norm: optional (weight (K,), eps) rms_norm applied to x first.
    glu: x is (N, 2K) and silu(x[:, :K]) * x[:, K:] feeds the matmul.
    residual: optional (N, M) added to the output.
    dispatch: the grouped large-N kernel, as qgemm_pallas's argument:
    "chunk" (K4), "dequant" (K5) or None (the N >= 3 * group_size rule);
    ignored below LARGE_N rows and for per-tensor scales.
    act_group_size: activation groups finer than the weight groups (the
    reference's -ags knob) on K4's function; ignored where
    ``effective_ags`` drops it, by K5 and by impl="torch".
    """
    grouped = qt.scales.shape[0] > 1
    if impl == "auto":
        from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import weights_form_error
        on_cpu_kernel = x.is_floating_point() and (
            not grouped or weights_form_error(qt) is None)
        impl = ("fused" if x.device.type != "cpu" or on_cpu_kernel
                else "torch")
    out_dtype = out_dtype or (torch.float32 if x.dtype == torch.int8
                              else x.dtype)
    if impl == "fused":
        if not x.is_floating_point():
            raise ValueError("the fused kernels quantize float activations; "
                             "int8 x takes impl='torch'")
        kernel = kernel_for(qt, x.shape[0], dispatch=dispatch,
                            act_gs=act_group_size)
        out = kernel(x.to(torch.bfloat16), qt, norm=norm, glu=glu,
                     residual=residual)
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
