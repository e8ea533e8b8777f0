"""Kernel K10: a decode step's residual block in one program.

Replaces ``tmac_tpu/ops/pallas/block_kernel.py::wo_mlp_block``: for one
token and per-tensor weights at bits 1, 2 or 4 (the model's block mode
takes BitNet's bits 2; bits 1 and 4 are reached by a direct call, as in
JAX), wo + residual -> rms_norm ->
gate_up -> SwiGLU -> down + residual, every matmul on int8 activations
quantized per row, as CUDA C++ for Hopper in ``csrc/block_kernel.cu``.
That source says what bounds the kernel (device-memory bytes), how its
blocks wait for each other between phases while the next phase's weights
stream in, how the int32 sums of a strip are added across blocks, and
which f32 steps of the reference it follows.  ``block_plan`` and the
functions after it model the kernel's static partition of the work (the
CPU tests hold them to ``int_dot_plain``).

``wo_mlp_block`` is the wrapper: a CPU tensor goes to the plain PyTorch
version ``wo_mlp_block_plain``, a CUDA tensor to the kernel (one template
instance a bits), which either launches or raises.
``wo_mlp_block.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (act_scale, int_dot_plain,
                                                  raise_on, require)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.utils import cdiv, fma_f32

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def check_supported(attn: torch.Tensor, wo: QuantizedTensor,
                    gu: QuantizedTensor, dn: QuantizedTensor) -> None:
    """Raise where the reference's wo_mlp_block asserts."""
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
# The kernel's static plan (csrc/block_kernel.cu)
# ---------------------------------------------------------------------------

BLOCK_STRIP = 128       # columns of a unit
BLOCK_STAGE_ROWS = 64   # packed rows of a unit (a stage of the ring)


def block_plan(K: int, M: int, bits: int = 2):
    """A phase's units: (units a strip, unit count) of a (K, M) matmul at
    bits (K // (8 // bits) packed rows), units numbered strip-major (strip
    = u // per_strip, its packed rows from (u % per_strip) * 64)."""
    per_strip = cdiv(K // (8 // bits), BLOCK_STAGE_ROWS)
    return per_strip, (M // BLOCK_STRIP) * per_strip


def block_spans(total: int, blocks: int):
    """The units [u0, u1) of each of `blocks` blocks: b * total // blocks
    on, in order, covering every unit once (empty where blocks > total)."""
    return [(b * total // blocks, (b + 1) * total // blocks) for b in range(blocks)]


def int_dot_units_plain(codes: torch.Tensor, qt: QuantizedTensor,
                        blocks: int) -> torch.Tensor:
    """The exact int32 dot (1, M) as the kernel's blocks add it: each block
    sums each strip's packed rows of its units (field j of packed row r,
    masked in place, meets code j * K / P + r, shifted back by bits * j;
    P = 8 // bits fields a byte), and the blocks' strip sums are added in
    device memory.  Equal to int_dot_plain."""
    K, M, b = qt.kdim_padded, qt.mdim_padded, qt.bits
    P = 8 // b
    Kb = K // P
    per_strip, total = block_plan(K, M, b)
    c = codes.long()
    pk = qt.packed.long()
    sums = torch.zeros((codes.shape[0], M), dtype=torch.long)
    for u0, u1 in block_spans(total, blocks):
        for u in range(u0, u1):
            strip, r0 = u // per_strip, (u % per_strip) * BLOCK_STAGE_ROWS
            r1 = min(r0 + BLOCK_STAGE_ROWS, Kb)
            cols = slice(strip * BLOCK_STRIP, (strip + 1) * BLOCK_STRIP)
            for j in range(P):
                masked = pk[r0:r1, cols] & (((1 << b) - 1) << (b * j))
                sums[:, cols] += (c[:, j * Kb + r0:j * Kb + r1] @ masked) >> (b * j)
    return sums.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("block_kernel")
    lib.tmac_wo_mlp_block.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_float, _c_float, _c_int, _c_int, _c_int, _c_int,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_ptr]
    lib.tmac_wo_mlp_block.restype = _c_int
    return lib


# per (card, H, I2): the int32 sums of wo, gate_up and down (2H + I2) the
# kernel's blocks add into, and its counters (zero when made and left zero
# by every launch)
_scratch: dict = {}


def _sums_scratch(dev, H: int, I2: int):
    key = (dev, H, I2)
    if key not in _scratch:
        _scratch[key] = (torch.zeros(2 * H + I2, dtype=torch.int32, device=dev),
                         torch.zeros(4, dtype=torch.int32, device=dev))
    return _scratch[key]


def wo_mlp_block(attn: torch.Tensor, resid: torch.Tensor,
                 norm_w: torch.Tensor, wo: QuantizedTensor,
                 gu: QuantizedTensor, dn: QuantizedTensor,
                 eps: float, blocks: int = 0) -> torch.Tensor:
    """One decode token through [wo + resid, rms_norm, gate_up, SwiGLU,
    down + resid]: attn and resid (1, H) bf16, norm_w (H,) bf16 -> (1, H)
    f32.  CPU tensors take the plain version; CUDA tensors the kernel (H
    and gate_up's M multiples of 128, down's K of 32 // bits; one launch
    at a time on a card, as
    its scratch sums are the card's).  blocks: the kernel's grid, 0 for
    one block an SM (the plan); a grid larger than can be resident at once
    is refused."""
    check_supported(attn, wo, gu, dn)
    if attn.device.type == "cpu":
        return wo_mlp_block_plain(attn, resid, norm_w, wo, gu, dn, eps)
    if attn.device.type != "cuda":
        raise ValueError(f"K10 runs on CPU or CUDA tensors, not {attn.device}")
    dev = attn.device
    H, I2, Ip, P = attn.shape[1], gu.mdim, dn.kdim, 8 // wo.bits
    require("K10", attn, "attn", torch.bfloat16, (1, H), dev)
    require("K10", resid, "resid", torch.bfloat16, (1, H), dev)
    require("K10", norm_w, "norm weight", torch.bfloat16, (H,), dev)
    for name, qt, K, M in (("wo", wo, H, H), ("gate_up", gu, H, I2),
                           ("down", dn, Ip, H)):
        require("K10", qt.packed, f"{name} packed", torch.uint8, (K // P, M), dev)
        require("K10", qt.scales, f"{name} scales", torch.float32, (1, M), dev)
        require("K10", qt.sub, f"{name} sub", torch.float32, (1, M), dev)
    if H % BLOCK_STRIP or I2 % BLOCK_STRIP or Ip % (4 * P):
        raise ValueError(f"K10 takes H and gate_up's M multiples of {BLOCK_STRIP} and "
                         f"down's K of {4 * P}, not {H}, {I2} and {Ip}")
    # the kernel copies each array into shared memory 16 bytes at a time
    for name, t in (("resid", resid), ("norm weight", norm_w),
                    ("wo packed", wo.packed), ("wo scales", wo.scales), ("wo sub", wo.sub),
                    ("gate_up packed", gu.packed), ("down packed", dn.packed)):
        if t.data_ptr() % 16:
            raise ValueError(f"K10: {name} must be 16-byte aligned")
    sums, counts = _sums_scratch(dev, H, I2)
    # down's input before quantization, the blocks' absmax
    work = torch.empty((Ip + 1024,), dtype=torch.float32, device=dev)
    out = torch.empty((1, H), dtype=torch.float32, device=dev)
    err = _lib().tmac_wo_mlp_block(
        attn.data_ptr(), resid.data_ptr(), norm_w.data_ptr(), float(eps),
        1.0 / H, H, I2, Ip, wo.bits,
        wo.packed.data_ptr(), wo.scales.data_ptr(), wo.sub.data_ptr(),
        gu.packed.data_ptr(), gu.scales.data_ptr(), gu.sub.data_ptr(),
        dn.packed.data_ptr(), dn.scales.data_ptr(), dn.sub.data_ptr(),
        work.data_ptr(), out.data_ptr(), sums.data_ptr(), counts.data_ptr(), int(blocks),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on("K10", err, "block")
    wo_mlp_block.launches += 1
    return out


wo_mlp_block.launches = 0
