"""Kernels K4 and K5: grouped-scale packed low-bit matmuls.

K4 replaces the grouped chunk path of
``tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel`` (G > 1 scale groups,
activations quantized to int8 per (token, weight group)): the fused form
that ``qgemm_pallas(act="fused")`` takes for N < 64 and the external-int8
form (``grouped_int=True``) that it takes from 64 rows with dispatch
"chunk", or below 3 * group_size rows.  Both compute the same function,
which the CUDA C++ in ``csrc/qgemm_grouped.cu`` computes for Hopper.

K5 replaces its ``dequant_dot`` path, which the same call takes from 64
rows with dispatch "dequant", or from 3 * group_size rows (the route is
``ops.qgemm.route``): the prologue's values rounded to bf16, times the
weights dequantized to bf16, in one f32 dot (``csrc/qgemm_large.cu``: xa
by TMA, wgmma on the tensor cores, every warpgroup dequantizing its share
of the weights two depth steps ahead of the products).

K4 runs as two designs on the card: below LARGE_N (64) rows the decode
form (``csrc/decode_matmul.cuh``, shared with K1: launched right after the
prologue so that it streams its weights while the prologue runs, K split
over a thread-block cluster by ``decode_plan``, the per-group int32
partials kept in shared memory and folded in group order through
distributed shared memory), from 64 rows K4L, the same function on the
int8 tensor cores with the group fold in registers
(``qgemm_grouped_large``); both are bit for bit the plain version.

Each source says what bounds its kernel on the card and how its design
answers it.  ``qgemm_grouped`` (K4), ``qgemm_grouped_large`` (K4L) and
``qgemm_dequant`` (K5) are the wrappers: a CPU tensor goes to the plain
PyTorch version (``qgemm_grouped_plain``, ``qgemm_dequant_plain``), a
CUDA tensor to the kernel, which either launches or raises;
``qgemm_grouped`` raises for a CUDA tensor of LARGE_N rows or more, which
``ops.qgemm.kernel_for`` routes to K4L.
Each wrapper's ``launches`` counts calls that launched its kernel
(prologue and matmul together).
Bits 1, 2, 3 and 4 are ported (bits 3: a 2-bit lo plane and a 1-bit hi
plane, code = lo + 4 * hi); an activation group size finer than the
weight groups is not.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.cuda.qgemm_kernel import (DECODE_STRIP, _sms, act_scale,
                                                  check_decode_smem, decode_fields,
                                                  decode_owner, decode_plan,
                                                  decode_spans, decode_units,
                                                  prologue_values, raise_on,
                                                  require)
from tmac_tpu_torch.ops.qgemm import LARGE_N, QuantizedTensor, unpack_codes
from tmac_tpu_torch.utils import fma_f32

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


GROUPED_BITS = (1, 2, 3, 4)


def _check_supported(qt: QuantizedTensor, glu: bool, norm, residual,
                     kernel: str = "K4") -> None:
    if qt.bits not in GROUPED_BITS:
        raise ValueError(f"{kernel} takes bits 1, 2, 3 and 4, not {qt.bits}")
    if (qt.bits == 3) != (qt.packed_hi is not None):
        raise ValueError(f"{kernel} takes a hi plane (packed_hi) at bits 3 only")
    if qt.scales.shape[0] < 2 or qt.k_shards != 1:
        raise ValueError(f"{kernel} takes grouped scales (G > 1) and k_shards == 1")
    if qt.group_size % 32:
        raise ValueError(f"{kernel} takes a group size that is a multiple of "
                         f"32, not {qt.group_size}")
    if qt.scales.dtype != torch.bfloat16 or qt.sub.dtype != torch.bfloat16:
        raise ValueError(f"{kernel} takes bf16 scales and sub")
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


def fold_chunk(Kp: int, bits: int, gs: int) -> int:
    """The k of one step of the f32 fold: the reference's chunk
    (``_make_kernel``), min(gs, Kp / p) with p the fields of a byte (4 at
    bits 3), and at bits 3 also at most Kp / 8 (one block of the hi
    plane).  It is the group unless Kp / p < gs (at bits 3, Kp / 8 < gs),
    which the packing's padding (K a multiple of p * gs, of 8 * gs at bits
    3) leaves only to a tensor made by hand; then a group is folded in
    parts, each part's int32 dot scaled on its own."""
    chunk = min(gs, Kp // (4 if bits == 3 else 8 // bits))
    return min(chunk, Kp // 8) if bits == 3 else chunk


def group_dots_plain(codes: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Exact int32 dots (C, N, Mp) of codes (N, Kp) with the weight codes,
    one per fold chunk (fold_chunk: a group, or a part of one), in k order:
    a float64 matmul each (exact: |sum| <= 127 * 15 * group_size < 2^53),
    on CPU and CUDA alike."""
    N, Kp = codes.shape
    ch = fold_chunk(Kp, qt.bits, qt.group_size)
    w = unpack_codes(qt)
    return torch.stack([
        (codes[:, k:k + ch].double() @ w[k:k + ch].double()).to(torch.int32)
        for k in range(0, Kp, ch)])


def fold_plain(parts: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
               qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """The f32 epilogue on the int32 partials (C, N, Mp) of the C fold
    chunks (group_dots_plain) -> (N, Mp), in the order of
    csrc/qgemm_grouped.cu (that of the compiled reference):
    acc = fma(p_0, x_0, p_1 * x_1), then acc = fma(p_c, x_c, acc) with
    x_c = xs[:, g] * scale[g] of chunk c's group g; z = fma(xsum[:, g],
    sub[g], z) from 0 over the groups; acc - z (+ residual)."""
    C, G = parts.shape[0], xs.shape[1]
    scales, sub = qt.scales.float(), qt.sub.float()
    p = parts.float()

    def xscale(c):
        g = c * G // C
        return xs[:, g:g + 1] * scales[g]

    acc = fma_f32(p[0], xscale(0).expand_as(p[0]), p[1] * xscale(1))
    for c in range(2, C):
        acc = fma_f32(p[c], xscale(c).expand_as(acc), acc)
    z = torch.zeros_like(acc)
    for g in range(G):
        z = fma_f32(xsum[:, g:g + 1].expand_as(z), sub[g].expand_as(z), z)
    out = acc - z
    if residual is not None:
        out = out + residual.float()
    return out


def decode_slot_weights(qt: QuantizedTensor, r0: int, r1: int, e: int):
    """What slot e of the decode matmul's rows [r0, r1) (decode_units)
    multiplies in its dp4a, as csrc/decode_matmul.cuh forms it in place:
    -> (weight bytes (r1 - r0, Mp) int64, the shift its flush takes back).
    Bits 1, 2, 4: field e of the packed bytes masked in place, i.e. times
    2^(bits * e).  Bits 3: the code lo + 4 * hi of k = e * Kb + r
    assembled at bit t = min(2 * (e // 2), 4) of the byte: field e // 2 of
    lo plane row r + (e % 2) * Kb, shifted right by 2 * (e // 2) - t, and
    bit e of hi plane row r, moved to bit t + 2 (tmac::decode::b3_slot)."""
    pk = qt.packed.long()
    if qt.bits != 3:
        return pk[r0:r1] & (((1 << qt.bits) - 1) << (qt.bits * e)), qt.bits * e
    Kb, j = qt.kdim_padded // 8, e // 2
    t = min(2 * j, 4)
    lo = pk[r0 + (e % 2) * Kb:r1 + (e % 2) * Kb] >> (2 * j - t)
    hi, hs = qt.packed_hi.long()[r0:r1], t + 2 - e
    hi = hi << hs if hs >= 0 else hi >> -hs
    return (lo & (3 << t)) | (hi & (4 << t)), t


def block_partials_plain(codes: torch.Tensor, qt: QuantizedTensor,
                         ksplit: int):
    """The per-group int32 partials each block of a decode cluster keeps in
    its shared memory: for block `rank`, the chunks [u0, u1) of its span
    (decode_spans), as (u1 - u0, P, N, Mp) int32, entry (c - u0, j) being
    group j * nchunks + c: slot j's in-place weights (decode_slot_weights)
    against the codes of k = j * Kb + row, shifted back.  Exact int64
    sums, as the kernel's."""
    P, gs = decode_fields(qt.bits), qt.group_size
    Kb, _, nchunks = decode_units(qt.kdim_padded, qt.bits, gs)
    c = codes.long()

    def slot(ch, j):
        w, shift = decode_slot_weights(qt, ch * gs, (ch + 1) * gs, j)
        return (c[:, j * Kb + ch * gs:j * Kb + (ch + 1) * gs] @ w) >> shift
    blocks = []
    for u0, u1 in decode_spans(nchunks, ksplit):
        blocks.append(torch.stack([torch.stack([slot(ch, j) for j in range(P)])
                                   for ch in range(u0, u1)]).to(torch.int32)
                      if u1 > u0 else None)
    return blocks


def fold_split_plain(blocks, xs: torch.Tensor, xsum: torch.Tensor,
                     qt: QuantizedTensor, ksplit: int, residual=None) -> torch.Tensor:
    """The decode matmul's on-chip fold: partial g read from the block that
    owns chunk g % nchunks (decode_owner), slot g // nchunks, and folded in
    group order (fold_plain's chain) -> (N, Mp) f32."""
    _, _, nchunks = decode_units(qt.kdim_padded, qt.bits, qt.group_size)
    owner = decode_owner(nchunks, ksplit)
    G = qt.kdim_padded // qt.group_size
    parts = torch.stack([blocks[owner[g % nchunks][0]][owner[g % nchunks][1],
                                                        g // nchunks]
                         for g in range(G)])
    return fold_plain(parts, xs, xsum, qt, residual)


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
    lib.tmac_decode_group_gemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr]
    lib.tmac_group_gemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    for fn in (lib.tmac_act_quant_grouped, lib.tmac_decode_group_gemm,
               lib.tmac_group_gemm):
        fn.restype = _c_int
    return lib


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _planes(kernel: str, qt: QuantizedTensor, dev, row_multiple: int = 1):
    """Raise unless qt's packed planes are what `kernel` takes: packed
    (Kp * bits / 8, Mp), at bits 3 the lo plane (Kp / 4, Mp) and the hi
    plane (Kp / 8, Mp), each 16-byte aligned with a row count that is a
    multiple of row_multiple; and, for K4 and K4L at bits 1 and 3, Kp a
    multiple of 8 * group_size (so that the reference's fold chunk is the
    group; fold_chunk).  -> the hi plane's pointer, or None."""
    Kp, Mp, bits, gs = qt.kdim_padded, qt.mdim_padded, qt.bits, qt.group_size
    planes = [("packed", qt.packed, Kp // 4 if bits == 3 else Kp * bits // 8)]
    if bits == 3:
        planes.append(("packed_hi", qt.packed_hi, Kp // 8))
    for what, t, rows in planes:
        require(kernel, t, what, torch.uint8, (rows, Mp), dev)
        if t.data_ptr() % 16 or rows % row_multiple:
            raise ValueError(f"{kernel}: {what} must be 16-byte aligned with "
                             f"a multiple of {row_multiple} rows, not {rows}")
    if kernel != "K5" and Kp % (decode_fields(bits) * gs):
        raise ValueError(f"{kernel} at bits {bits} takes Kp a multiple of "
                         f"{decode_fields(bits)} * group_size, not {Kp}")
    return qt.packed_hi.data_ptr() if bits == 3 else None


def launch_act_quant_grouped(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                             glu: bool = False, kernel: str = "K4"):
    """Launch the prologue: -> (codes (N, Kp) int8, xs (N, G), xsum (N, G))."""
    dev = x.device
    N = x.shape[0]
    K, Kp, gs = qt.kdim, qt.kdim_padded, qt.group_size
    G = Kp // gs
    require(kernel, x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        require(kernel, w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    codes = torch.empty((N, Kp), dtype=torch.int8, device=dev)
    xs = torch.empty((N, G), dtype=torch.float32, device=dev)
    xsum = torch.empty((N, G), dtype=torch.float32, device=dev)
    err = _lib().tmac_act_quant_grouped(
        x.data_ptr(), N, x.shape[1], K, Kp, gs, int(glu), norm_ptr,
        float(eps), 1.0 / K, codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(),
        _stream(dev))
    raise_on(kernel, err, "prologue")
    return codes, xs, xsum


def launch_decode_grouped(codes: torch.Tensor, xs: torch.Tensor,
                          xsum: torch.Tensor, qt: QuantizedTensor, residual=None,
                          ksplit=None) -> torch.Tensor:
    """Launch K4's matmul on its prologue's outputs, right after the
    prologue (it starts while the prologue runs), the group fold on chip:
    -> (N, Mp) f32.  ksplit: the cluster size along K (decode_plan's by
    default)."""
    dev = codes.device
    N, Kp, Mp, gs = codes.shape[0], qt.kdim_padded, qt.mdim_padded, qt.group_size
    G = Kp // gs
    require("K4", codes, "codes", torch.int8, (N, Kp), dev)
    require("K4", xs, "xs", torch.float32, (N, G), dev)
    require("K4", xsum, "xsum", torch.float32, (N, G), dev)
    hi_ptr = _planes("K4", qt, dev)
    require("K4", qt.scales, "scales", torch.bfloat16, (G, Mp), dev)
    require("K4", qt.sub, "sub", torch.bfloat16, (G, Mp), dev)
    if Mp % DECODE_STRIP or codes.data_ptr() % 4 or any(
            t.data_ptr() % 16 for t in (qt.scales, qt.sub)):
        raise ValueError("K4: Mp % 128 == 0, 4-byte aligned codes and 16-byte "
                         "aligned scales and sub")
    res_ptr = None
    if residual is not None:
        require("K4", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    plan, nt = decode_plan(N, Kp, Mp, qt.bits, gs, _sms(dev))
    check_decode_smem("K4", N, Kp, qt.bits, gs, ksplit or plan, nt)
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib().tmac_decode_group_gemm(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, gs, qt.bits,
        qt.packed.data_ptr(), hi_ptr, Mp, qt.scales.data_ptr(), qt.sub.data_ptr(),
        res_ptr, out.data_ptr(), ksplit or plan, nt, _stream(dev))
    raise_on("K4", err, "matmul")
    return out


def qgemm_grouped(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None) -> torch.Tensor:
    """x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32, with the
    activations quantized to int8 per (row, scale group) inside K4.

    norm: (weight (K,), eps) rms_norm before quantization.  glu: x is the
    fused gate_up output and silu(g) * u feeds the matmul.  residual:
    (N, M) added in the epilogue.  CPU tensors take the plain version; CUDA
    tensors take the kernel (x, the norm weight and the residual in bf16)
    below LARGE_N rows; from there the route takes K4L,
    qgemm_grouped_large (``ops.qgemm.kernel_for`` picks)."""
    _check_supported(qt, glu, norm, residual)
    if x.device.type == "cpu":
        return qgemm_grouped_plain(x, qt, norm, glu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CPU or CUDA tensors, not {x.device}")
    if x.shape[0] >= LARGE_N:
        raise ValueError(f"K4 takes N < {LARGE_N} rows on the card, not "
                         f"{x.shape[0]}: K4L (qgemm_grouped_large) takes the rest")
    codes, xs, xsum = launch_act_quant_grouped(x, qt, norm, glu)
    out = launch_decode_grouped(codes, xs, xsum, qt, residual)
    qgemm_grouped.launches += 1
    return qt.slice_m(out)


qgemm_grouped.launches = 0


def launch_group_gemm(codes: torch.Tensor, xs: torch.Tensor,
                      xsum: torch.Tensor, qt: QuantizedTensor,
                      residual=None) -> torch.Tensor:
    """Launch K4L's matmul on its prologue's outputs: -> (N, Mp) f32."""
    dev = codes.device
    N, Kp, Mp, gs = codes.shape[0], qt.kdim_padded, qt.mdim_padded, qt.group_size
    G = Kp // gs
    require("K4L", codes, "codes", torch.int8, (N, Kp), dev)
    require("K4L", xs, "xs", torch.float32, (N, G), dev)
    require("K4L", xsum, "xsum", torch.float32, (N, G), dev)
    hi_ptr = _planes("K4L", qt, dev)
    require("K4L", qt.scales, "scales", torch.bfloat16, (G, Mp), dev)
    require("K4L", qt.sub, "sub", torch.bfloat16, (G, Mp), dev)
    if Mp % 128 or codes.data_ptr() % 16:
        raise ValueError("K4L: Mp % 128 == 0 and 16-byte aligned codes")
    res_ptr = None
    if residual is not None:
        require("K4L", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib().tmac_group_gemm(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, gs, qt.bits,
        qt.packed.data_ptr(), hi_ptr, Mp, qt.scales.data_ptr(), qt.sub.data_ptr(),
        res_ptr, out.data_ptr(), _stream(dev))
    raise_on("K4L", err, "matmul")
    return out


def qgemm_grouped_large(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                        glu: bool = False, residual=None) -> torch.Tensor:
    """K4L: qgemm_grouped's function on the int8 tensor cores, the group
    fold in registers (csrc/qgemm_grouped.cu, group_mma_kernel), the form
    the route takes from LARGE_N rows; any N on a CUDA tensor.  CPU
    tensors take the plain version."""
    _check_supported(qt, glu, norm, residual, "K4L")
    if x.device.type == "cpu":
        return qgemm_grouped_plain(x, qt, norm, glu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"K4L runs on CPU or CUDA tensors, not {x.device}")
    codes, xs, xsum = launch_act_quant_grouped(x, qt, norm, glu, "K4L")
    out = launch_group_gemm(codes, xs, xsum, qt, residual)
    qgemm_grouped_large.launches += 1
    return qt.slice_m(out)


qgemm_grouped_large.launches = 0


# ---------------------------------------------------------------------------
# K5: plain PyTorch version
# ---------------------------------------------------------------------------

def act_bf16_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                   glu: bool = False) -> torch.Tensor:
    """K5's prologue: x (N, K) or (N, 2K) -> the bf16 activations (N, Kp),
    K4's prologue values (SwiGLU or rms_norm, zero past K) rounded to
    bf16."""
    return prologue_values(x, qt.kdim, qt.kdim_padded, norm, glu).to(torch.bfloat16)


def dequant_weights_plain(qt: QuantizedTensor) -> torch.Tensor:
    """The bf16 weights (Kp, Mp) K5 multiplies: code * scale[g] - sub[g]
    in f32 (code * scale is exact), rounded to bf16."""
    Kp, Mp, gs = qt.kdim_padded, qt.mdim_padded, qt.group_size
    w = unpack_codes(qt).float().reshape(Kp // gs, gs, Mp)
    w = w * qt.scales.float()[:, None] - qt.sub.float()[:, None]
    return w.reshape(Kp, Mp).to(torch.bfloat16)


def qgemm_dequant_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                        glu: bool = False, residual=None) -> torch.Tensor:
    """The function K5 computes, in plain PyTorch: (N, M) f32, the bf16
    activations times the bf16 weights in an f32 matmul (in full f32 on
    the card: callers there keep TF32 off), plus the residual."""
    _check_supported(qt, glu, norm, residual, "K5")
    out = act_bf16_plain(x, qt, norm, glu).float() @ dequant_weights_plain(qt).float()
    if residual is not None:
        out = out + residual.float()
    return qt.slice_m(out)


# ---------------------------------------------------------------------------
# K5: CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib_large():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_large")
    lib.tmac_act_bf16.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_float,
        _c_float, _c_ptr, _c_ptr]
    lib.tmac_qgemm_dequant.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_int,
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    for fn in (lib.tmac_act_bf16, lib.tmac_qgemm_dequant):
        fn.restype = _c_int
    return lib


def launch_act_bf16(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                    glu: bool = False) -> torch.Tensor:
    """Launch K5's prologue: -> xa (N, Kp) bf16."""
    dev = x.device
    N, K, Kp = x.shape[0], qt.kdim, qt.kdim_padded
    require("K5", x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        require("K5", w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    xa = torch.empty((N, Kp), dtype=torch.bfloat16, device=dev)
    err = _lib_large().tmac_act_bf16(
        x.data_ptr(), N, x.shape[1], K, Kp, int(glu), norm_ptr, float(eps),
        1.0 / K, xa.data_ptr(), _stream(dev))
    raise_on("K5", err, "prologue")
    return xa


def launch_dequant_gemm(xa: torch.Tensor, qt: QuantizedTensor,
                        residual=None) -> torch.Tensor:
    """Launch K5's matmul on its prologue's activations: -> (N, Mp) f32."""
    dev = xa.device
    N, Kp, Mp, gs = xa.shape[0], qt.kdim_padded, qt.mdim_padded, qt.group_size
    G = Kp // gs
    require("K5", xa, "xa", torch.bfloat16, (N, Kp), dev)
    hi_ptr = _planes("K5", qt, dev, row_multiple=64)
    require("K5", qt.scales, "scales", torch.bfloat16, (G, Mp), dev)
    require("K5", qt.sub, "sub", torch.bfloat16, (G, Mp), dev)
    if Mp % 128 or any(t.data_ptr() % 16 for t in (xa, qt.scales, qt.sub)):
        raise ValueError("K5: Mp % 128 == 0 and 16-byte aligned operands")
    res_ptr = None
    if residual is not None:
        require("K5", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib_large().tmac_qgemm_dequant(
        xa.data_ptr(), N, Kp, gs, qt.bits, qt.packed.data_ptr(), hi_ptr, Mp,
        qt.scales.data_ptr(), qt.sub.data_ptr(), res_ptr, out.data_ptr(),
        _stream(dev))
    raise_on("K5", err, "matmul")
    return out


def qgemm_dequant(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None) -> torch.Tensor:
    """K5: x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32 on the
    reference's large-N dequant route: the prologue's values in bf16
    times the weights dequantized to bf16, summed in f32.  The folds as
    qgemm_grouped's.  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    _check_supported(qt, glu, norm, residual, "K5")
    if x.device.type == "cpu":
        return qgemm_dequant_plain(x, qt, norm, glu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CPU or CUDA tensors, not {x.device}")
    xa = launch_act_bf16(x, qt, norm, glu)
    out = launch_dequant_gemm(xa, qt, residual)
    qgemm_dequant.launches += 1
    return qt.slice_m(out)


qgemm_dequant.launches = 0
