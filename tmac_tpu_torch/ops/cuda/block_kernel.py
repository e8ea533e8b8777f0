"""Kernel K10: a decode step's residual block in one program.

Replaces ``tmac_tpu/ops/pallas/block_kernel.py::wo_mlp_block``: for one
token and per-tensor bits-2 weights (BitNet), wo + residual -> rms_norm ->
gate_up -> SwiGLU -> down + residual, every matmul on int8 activations
quantized per row, as CUDA C++ for Hopper in ``csrc/block_kernel.cu``.
That source says what bounds the kernel (device-memory bytes), how its
blocks wait for each other between phases, and which f32 steps of the
reference it follows.

``wo_mlp_block`` is the wrapper: a CPU tensor goes to the plain PyTorch
version ``wo_mlp_block_plain``, a CUDA tensor to the kernel, which either
launches or raises.  ``wo_mlp_block.launches`` counts launches.  Bits 1
and 4, which the reference also takes, are not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (act_scale, int_dot_plain,
                                                  raise_on, require)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.utils import fma_f32

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def check_supported(attn: torch.Tensor, wo: QuantizedTensor,
                    gu: QuantizedTensor, dn: QuantizedTensor) -> None:
    """Raise where the reference's wo_mlp_block asserts, and on the bits
    not ported."""
    H = attn.shape[-1]
    if attn.dim() != 2 or attn.shape[0] != 1:
        raise ValueError(f"K10 is decode-only: attn (1, H), not {tuple(attn.shape)}")
    for qt in (wo, gu, dn):
        if qt.scales.shape[0] != 1 or qt.k_shards != 1:
            raise ValueError("K10 takes per-tensor scales and k_shards == 1")
        if qt.bits != wo.bits or qt.bits not in (1, 2, 4):
            raise ValueError("K10's three weights share bits 1, 2 or 4")
        if qt.mdim_padded != qt.mdim:
            raise ValueError("K10 takes weights unpadded in M")
    if not wo.kdim_padded == wo.kdim == H:
        raise ValueError(f"wo's K must be the hidden size {H}, unpadded")
    if dn.mdim != H or wo.mdim != H:
        raise ValueError(f"wo's and down's M must be the hidden size {H}")
    if gu.mdim_padded != 2 * dn.kdim or dn.kdim_padded != dn.kdim:
        raise ValueError("gate_up's M must be twice down's K, unpadded")
    if wo.bits != 2:
        raise NotImplementedError(f"K10 is ported for bits 2, not {wo.bits}")


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and what the kernel is held to)
# ---------------------------------------------------------------------------

def _quantize_row(v: torch.Tensor):
    """(1, K) f32 -> (codes as f32, scale (1, 1), code sum times scale)."""
    sc = act_scale(v.abs().amax(1, keepdim=True))
    # a true division, by a tensor (see act_quant_plain)
    q = torch.clamp(torch.round(v / sc), -127, 127)
    return q, sc, q.sum(1, keepdim=True) * sc


def _matmul_phase(q, sc, zsc, qt: QuantizedTensor) -> torch.Tensor:
    """fma(acc * scale, sc, -(zsc * sub)) (1, M) on the exact int dot."""
    acc = int_dot_plain(q.to(torch.int8), qt).float()
    return fma_f32(acc * qt.scales[0].float(), sc.expand_as(acc),
                   -(zsc * qt.sub[0].float()))


def wo_mlp_block_plain(attn: torch.Tensor, resid: torch.Tensor,
                       norm_w: torch.Tensor, wo: QuantizedTensor,
                       gu: QuantizedTensor, dn: QuantizedTensor,
                       eps: float) -> torch.Tensor:
    """The function K10 computes, in plain PyTorch: (1, H) f32, every f32
    step as csrc/block_kernel.cu's header writes it."""
    check_supported(attn, wo, gu, dn)
    H, Ip = attn.shape[1], dn.kdim
    x2 = _matmul_phase(*_quantize_row(attn.float()), wo) + resid.float()
    xn = k1.rms_norm_values(x2, norm_w, eps, H)
    guo = _matmul_phase(*_quantize_row(xn), gu)
    g, u = guo[:, :Ip], guo[:, Ip:]
    h = g * (1.0 / (1.0 + torch.exp(-g))) * u
    return _matmul_phase(*_quantize_row(h), dn) + x2


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("block_kernel")
    lib.tmac_wo_mlp_block.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_float, _c_float, _c_int, _c_int, _c_int,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_wo_mlp_block.restype = _c_int
    return lib


def wo_mlp_block(attn: torch.Tensor, resid: torch.Tensor,
                 norm_w: torch.Tensor, wo: QuantizedTensor,
                 gu: QuantizedTensor, dn: QuantizedTensor,
                 eps: float) -> torch.Tensor:
    """One decode token through [wo + resid, rms_norm, gate_up, SwiGLU,
    down + resid]: attn and resid (1, H) bf16, norm_w (H,) bf16 -> (1, H)
    f32.  CPU tensors take the plain version; CUDA tensors the kernel."""
    check_supported(attn, wo, gu, dn)
    if attn.device.type == "cpu":
        return wo_mlp_block_plain(attn, resid, norm_w, wo, gu, dn, eps)
    if attn.device.type != "cuda":
        raise ValueError(f"K10 runs on CPU or CUDA tensors, not {attn.device}")
    dev = attn.device
    H, I2, Ip = attn.shape[1], gu.mdim, dn.kdim
    require("K10", attn, "attn", torch.bfloat16, (1, H), dev)
    require("K10", resid, "resid", torch.bfloat16, (1, H), dev)
    require("K10", norm_w, "norm weight", torch.bfloat16, (H,), dev)
    for name, qt, K, M in (("wo", wo, H, H), ("gate_up", gu, H, I2),
                           ("down", dn, Ip, H)):
        require("K10", qt.packed, f"{name} packed", torch.uint8, (K // 4, M), dev)
        require("K10", qt.scales, f"{name} scales", torch.float32, (1, M), dev)
        require("K10", qt.sub, f"{name} sub", torch.float32, (1, M), dev)
        if qt.packed.data_ptr() % 4:
            raise ValueError(f"K10: {name} packed must be 4-byte aligned")
    x2 = torch.empty((H,), dtype=torch.float32, device=dev)
    gu_out = torch.empty((I2,), dtype=torch.float32, device=dev)
    out = torch.empty((1, H), dtype=torch.float32, device=dev)
    err = _lib().tmac_wo_mlp_block(
        attn.data_ptr(), resid.data_ptr(), norm_w.data_ptr(), float(eps),
        1.0 / H, H, I2, Ip,
        wo.packed.data_ptr(), wo.scales.data_ptr(), wo.sub.data_ptr(),
        gu.packed.data_ptr(), gu.scales.data_ptr(), gu.sub.data_ptr(),
        dn.packed.data_ptr(), dn.scales.data_ptr(), dn.sub.data_ptr(),
        x2.data_ptr(), gu_out.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on("K10", err, "block")
    wo_mlp_block.launches += 1
    return out


wo_mlp_block.launches = 0
