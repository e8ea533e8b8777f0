"""Kernel K4: per-group activation quantization + grouped-scale packed
low-bit matmul.

Replaces the grouped chunk path of
``tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel`` (G > 1 scale groups,
activations quantized to int8 per (token, weight group)): the fused form
that ``qgemm_pallas(act="fused")`` takes for N < 64 and the external-int8
form (``grouped_int=True``) that it takes for N >= 64.  Both compute the
same function, which the CUDA C++ in ``csrc/qgemm_grouped.cu`` computes
for Hopper; that source says what bounds the kernel on the card and how
its design answers it.

``qgemm_grouped`` is the wrapper: a CPU tensor goes to the plain PyTorch
version ``qgemm_grouped_plain``, a CUDA tensor to the kernel, which either
launches or raises.  ``qgemm_grouped.launches`` counts calls that launched
the kernel (the prologue, the group dots and the fold together).
Bits 2 and 4 are ported; bits 1 and 3 and an activation group size finer
than the weight groups are not.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.cuda.qgemm_kernel import (act_scale, prologue_values,
                                                  raise_on, require)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes
from tmac_tpu_torch.utils import fma_f32

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_supported(qt: QuantizedTensor, glu: bool, norm, residual) -> None:
    if qt.bits not in (2, 4):
        raise ValueError(f"K4 takes bits 2 and 4, not {qt.bits}")
    if qt.scales.shape[0] < 2 or qt.k_shards != 1:
        raise ValueError("K4 takes grouped scales (G > 1) and k_shards == 1")
    if qt.group_size % 32:
        raise ValueError(f"K4 takes a group size that is a multiple of 32, "
                         f"not {qt.group_size}")
    if qt.scales.dtype != torch.bfloat16 or qt.sub.dtype != torch.bfloat16:
        raise ValueError("K4 takes bf16 scales and sub")
    if glu and (norm is not None or qt.kdim_padded != qt.kdim):
        raise ValueError("the glu fold needs no norm and an unpadded K")
    if residual is not None and (qt.mdim_padded != qt.mdim
                                 or qt.m_segments is not None):
        raise ValueError("the residual fold needs an unpadded, unfused M")
    if residual is not None and residual.dtype != torch.bfloat16:
        raise ValueError(f"the residual fold takes bf16, not {residual.dtype}")


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and what the kernel is held to)
# ---------------------------------------------------------------------------

def act_quant_grouped_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                            glu: bool = False):
    """The prologue: x (N, K) or (N, 2K) -> (codes int8 (N, Kp) in natural
    k order, xs (N, G) f32, xsum (N, G) f32): one absmax scale per (row,
    group of group_size columns) and the dequantized code sum per group."""
    xf = prologue_values(x, qt.kdim, qt.kdim_padded, norm, glu)
    N, Kp = xf.shape
    xg = xf.reshape(N, Kp // qt.group_size, qt.group_size)
    xs = act_scale(xg.abs().amax(-1))
    q = torch.clamp(torch.round(xg / xs[..., None]), -127, 127)
    xsum = q.sum(-1) * xs
    return q.reshape(N, Kp).to(torch.int8), xs, xsum


def group_dots_plain(codes: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Exact per-group int32 dots (G, N, Mp) of codes (N, Kp) with the
    weight codes: a float64 matmul per group (exact: |sum| <= 127 * 15 *
    group_size < 2^53), on CPU and CUDA alike."""
    N, Kp = codes.shape
    gs = qt.group_size
    w = unpack_codes(qt)
    return torch.stack([
        (codes[:, k:k + gs].double() @ w[k:k + gs].double()).to(torch.int32)
        for k in range(0, Kp, gs)])


def fold_plain(parts: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
               qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """The f32 epilogue on the int32 partials (G, N, Mp) -> (N, Mp), in
    the order of csrc/qgemm_grouped.cu (that of the compiled reference):
    acc = fma(p_0, x_0, p_1 * x_1), then acc = fma(p_g, x_g, acc) with
    x_g = xs[:, g] * scale[g]; z = fma(xsum[:, g], sub[g], z) from 0;
    acc - z (+ residual)."""
    G = parts.shape[0]
    scales, sub = qt.scales.float(), qt.sub.float()
    p = parts.float()

    def xscale(g):
        return xs[:, g:g + 1] * scales[g]

    acc = fma_f32(p[0], xscale(0).expand_as(p[0]), p[1] * xscale(1))
    for g in range(2, G):
        acc = fma_f32(p[g], xscale(g).expand_as(acc), acc)
    z = torch.zeros_like(acc)
    for g in range(G):
        z = fma_f32(xsum[:, g:g + 1].expand_as(z), sub[g].expand_as(z), z)
    out = acc - z
    if residual is not None:
        out = out + residual.float()
    return out


def qgemm_grouped_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                        glu: bool = False, residual=None) -> torch.Tensor:
    """The function K4 computes, in plain PyTorch: (N, M) f32."""
    _check_supported(qt, glu, norm, residual)
    codes, xs, xsum = act_quant_grouped_plain(x, qt, norm, glu)
    parts = group_dots_plain(codes, qt)
    return qt.slice_m(fold_plain(parts, xs, xsum, qt, residual))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_grouped")
    lib.tmac_act_quant_grouped.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_float, _c_float, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_group_dots.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_ptr,
        _c_ptr]
    lib.tmac_group_fold.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
        _c_ptr, _c_ptr, _c_ptr]
    for fn in (lib.tmac_act_quant_grouped, lib.tmac_group_dots,
               lib.tmac_group_fold):
        fn.restype = _c_int
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch_act_quant_grouped(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                             glu: bool = False):
    """Launch the prologue: -> (codes (N, Kp) int8, xs (N, G), xsum (N, G))."""
    dev = x.device
    N = x.shape[0]
    K, Kp, gs = qt.kdim, qt.kdim_padded, qt.group_size
    G = Kp // gs
    require("K4", x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        require("K4", w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    codes = torch.empty((N, Kp), dtype=torch.int8, device=dev)
    xs = torch.empty((N, G), dtype=torch.float32, device=dev)
    xsum = torch.empty((N, G), dtype=torch.float32, device=dev)
    err = _lib().tmac_act_quant_grouped(
        x.data_ptr(), N, x.shape[1], K, Kp, gs, int(glu), norm_ptr,
        float(eps), 1.0 / K, codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(),
        _stream(dev))
    raise_on("K4", err, "prologue")
    return codes, xs, xsum


def launch_group_dots(codes: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Launch the per-group int32 dots: -> parts (G, N, Mp) int32."""
    dev = codes.device
    N, Kp, Mp, gs = codes.shape[0], qt.kdim_padded, qt.mdim_padded, qt.group_size
    require("K4", codes, "codes", torch.int8, (N, Kp), dev)
    require("K4", qt.packed, "packed", torch.uint8, (Kp * qt.bits // 8, Mp), dev)
    if qt.packed.data_ptr() % 4 or codes.data_ptr() % 4:
        raise ValueError("K4: packed and codes must be 4-byte aligned")
    parts = torch.empty((Kp // gs, N, Mp), dtype=torch.int32, device=dev)
    err = _lib().tmac_group_dots(
        codes.data_ptr(), N, Kp, gs, qt.bits, qt.packed.data_ptr(), Mp,
        parts.data_ptr(), _stream(dev))
    raise_on("K4", err, "group dots")
    return parts


def launch_fold(parts: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """Launch the f32 fold: -> (N, Mp) f32."""
    dev = parts.device
    G, N, Mp = parts.shape
    require("K4", parts, "parts", torch.int32, (G, N, Mp), dev)
    require("K4", xs, "xs", torch.float32, (N, G), dev)
    require("K4", xsum, "xsum", torch.float32, (N, G), dev)
    require("K4", qt.scales, "scales", torch.bfloat16, (G, Mp), dev)
    require("K4", qt.sub, "sub", torch.bfloat16, (G, Mp), dev)
    res_ptr = None
    if residual is not None:
        require("K4", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib().tmac_group_fold(
        parts.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, G, Mp,
        qt.scales.data_ptr(), qt.sub.data_ptr(), res_ptr, out.data_ptr(),
        _stream(dev))
    raise_on("K4", err, "fold")
    return out


def qgemm_grouped(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None) -> torch.Tensor:
    """x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32, with the
    activations quantized to int8 per (row, scale group) inside K4.

    norm: (weight (K,), eps) rms_norm before quantization.  glu: x is the
    fused gate_up output and silu(g) * u feeds the matmul.  residual:
    (N, M) added in the epilogue.  CPU tensors take the plain version; CUDA
    tensors take the kernel (x, the norm weight and the residual in bf16)."""
    _check_supported(qt, glu, norm, residual)
    if x.device.type == "cpu":
        return qgemm_grouped_plain(x, qt, norm, glu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CPU or CUDA tensors, not {x.device}")
    codes, xs, xsum = launch_act_quant_grouped(x, qt, norm, glu)
    parts = launch_group_dots(codes, qt)
    out = launch_fold(parts, xs, xsum, qt, residual)
    qgemm_grouped.launches += 1
    return qt.slice_m(out)


qgemm_grouped.launches = 0
