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

K4 runs as two designs on the card (``csrc/qgemm_grouped.cu`` and
``csrc/qgemm_grouped_large.cu``): below LARGE_N (64) rows the decode
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
Bits 1, 2, 3, 4 and 8 are ported (bits 3: a 2-bit lo plane and a 1-bit
hi plane, code = lo + 4 * hi; bits 8, GGUF's Q8_0: signed codes, one a
byte), at group size 16 (GGUF's Q2_K and Q3_K) or a multiple of 32, and so
is the reference's ``act_group_size`` (its -ags knob, ``effective_ags``):
activation scales per group of ags columns, finer than the weight groups,
on K4 and K4L (``act_gs=``; on the card ags 16 or a multiple of 32).  The int32 dots are then per activation
group, each scaled by its own activation scale and its weight group's
scale in the f32 chain, and the zero-point fold takes each weight
group's code sum, the sum of its activation groups' (in order).

The scales and sub may be bf16 or f32 (GGUF's block types: the reference
widens any dtype to f32 where it reads it), each kernel taking f32 in a
template instance of its own; K4L streams its fold's factors, so any K
fits a block, and so does K4 where staging them all would not (gs 16 with
f32 factors at K 14336).  A 16-row unit is half a ring stage of the
decode matmul and half a depth step of K4L (two folds a step there).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tmac_tpu_torch.ops.cuda.qgemm_kernel import (DECODE_STRIP, _sms, act_scale,
                                                  check_decode_smem, decode_fields,
                                                  decode_owner, decode_plan,
                                                  decode_slot_weights,
                                                  decode_spans, decode_units,
                                                  prologue_values, raise_on,
                                                  require)
from tmac_tpu_torch.ops.qgemm import (LARGE_N, QuantizedTensor, effective_ags,
                                      unpack_codes)
from tmac_tpu_torch.utils import fma_f32

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


GROUPED_BITS = (1, 2, 3, 4, 8)  # the kernels' and the plain versions' (bits 8: GGUF's Q8_0)
SCALE_DTYPES = (torch.bfloat16, torch.float32)


def unit_size_ok(gs: int) -> bool:
    """A group size, or activation group size, the grouped kernels take: 16
    (half a ring stage of the decode matmul, half a depth step of K4L) or
    a multiple of 32 (whole ones)."""
    return gs == 16 or (gs > 0 and gs % 32 == 0)


def weights_form_error(qt: QuantizedTensor, kernel: str = "K4") -> Optional[str]:
    """What of qt the function (kernel and plain version alike) does not
    take, or None.  It takes grouped scales and sub of one dtype, bf16 or
    f32 (the reference widens any to f32 where it reads them), a group size
    of 16 or a multiple of 32 (GGUF's K-quants and the rest), bits 1 to 4
    or 8.  What the CUDA kernel lacks of it, check_kernel_form says."""
    if qt.bits not in GROUPED_BITS:
        return f"{kernel} takes bits 1, 2, 3, 4 and 8, not {qt.bits}"
    if (qt.bits == 3) != (qt.packed_hi is not None):
        return f"{kernel} takes a hi plane (packed_hi) at bits 3 only"
    if qt.scales.shape[0] < 2 or qt.k_shards != 1:
        return f"{kernel} takes grouped scales (G > 1) and k_shards == 1"
    if not unit_size_ok(qt.group_size):
        return f"{kernel} takes a group size of 16 or a multiple of 32, not {qt.group_size}"
    if qt.scales.dtype not in SCALE_DTYPES or qt.sub.dtype != qt.scales.dtype:
        return (f"{kernel} takes bf16 or f32 scales and sub of one dtype, "
                f"not {qt.scales.dtype} and {qt.sub.dtype}")
    return None


def _check_supported(qt: QuantizedTensor, glu: bool, norm, residual,
                     kernel: str = "K4") -> None:
    """Raise unless the function takes qt (weights_form_error) and the
    folds."""
    err = weights_form_error(qt, kernel)
    if err:
        raise ValueError(err)
    if glu and (norm is not None or qt.kdim_padded != qt.kdim):
        raise ValueError("the glu fold needs no norm and an unpadded K")
    if residual is not None and (qt.mdim_padded != qt.mdim
                                 or qt.m_segments is not None):
        raise ValueError("the residual fold needs an unpadded, unfused M")
    if residual is not None and residual.dtype != torch.bfloat16:
        raise ValueError(f"the residual fold takes bf16, not {residual.dtype}")


def check_kernel_form(qt: QuantizedTensor, kernel: str = "K4") -> None:
    """Raise a ValueError naming the form that the CUDA kernel lacks: the
    kernels take every form of the function (weights_form_error: bits 1 to
    4 and 8, group size 16 or a multiple of 32) with bf16 or f32 scales
    (each its own template instance), so what is left are other scale
    dtypes.  Nothing falls back to the plain version."""
    if qt.scales.dtype not in SCALE_DTYPES:
        raise ValueError(f"{kernel} on the card takes bf16 or f32 scales, not "
                         f"{qt.scales.dtype}")


def scale_f32(qt: QuantizedTensor) -> int:
    """The C interfaces' scale_f32 argument: 1 for f32 scales and sub."""
    return int(qt.scales.dtype == torch.float32)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path, and what the kernel is held to)
# ---------------------------------------------------------------------------

def act_quant_grouped_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                            glu: bool = False, ags: int = 0):
    """The prologue: x (N, K) or (N, 2K) -> (codes int8 (N, Kp) in natural
    k order, xs (N, Ga) f32, xsum (N, G) f32): one absmax scale per (row,
    activation group of ags columns; of group_size columns when ags is 0,
    Ga = G) and the dequantized code sum per weight group: with ags, that
    of its gs / ags activation groups (weight_group_sums)."""
    xf = prologue_values(x, qt.kdim, qt.kdim_padded, norm, glu)
    N, Kp = xf.shape
    a = ags or qt.group_size
    xg = xf.reshape(N, Kp // a, a)
    xs = act_scale(xg.abs().amax(-1))
    q = torch.clamp(torch.round(xg / xs[..., None]), -127, 127)
    qs = q.sum(-1)
    xsum = qs * xs
    if ags:
        xsum = weight_group_sums(qs, xs, qt.group_size // ags, N >= LARGE_N)
    return q.reshape(N, Kp).to(torch.int8), xs, xsum


def weight_group_sums(qs: torch.Tensor, xs: torch.Tensor, per: int,
                      large: bool) -> torch.Tensor:
    """Each weight group's dequantized code sum from its `per` activation
    groups' code sums qs and scales xs (N, Ga) -> (N, G), in the order the
    reference compiles its `(qs * xs).reshape(N, G, per).sum(-1)` to on
    the CPU: from LARGE_N rows (XLA's prologue before the external-int8
    kernel), and at per = 2 below, a chain of FMAs, s = fma(qs_i, xs_i, s)
    from s = qs_0 * xs_0; below LARGE_N rows (inside the fused kernel) at
    per >= 4, two lanes, the even and the odd products each added from
    left to right, then the two lanes' sums (measured at per 2 and 4;
    csrc/qgemm_grouped.cu repeats it)."""
    N, Ga = qs.shape
    qs, xs = qs.reshape(N, Ga // per, per), xs.reshape(N, Ga // per, per)
    prod = qs * xs
    if large or per == 2:
        s = prod[..., 0]
        for i in range(1, per):
            s = fma_f32(qs[..., i], xs[..., i], s)
        return s
    lanes = [prod[..., 0], prod[..., 1]]
    for i in range(2, per):
        lanes[i % 2] = lanes[i % 2] + prod[..., i]
    return lanes[0] + lanes[1]


def fold_chunk(Kp: int, bits: int, gs: int, ags: int = 0) -> int:
    """The k of one step of the f32 fold: the reference's chunk
    (``_make_kernel``), min(gs, Kp / p) with p the fields of a byte (4 at
    bits 3), with an activation group size also at most ags, and at bits 3
    also at most Kp / 8 (one block of the hi plane).  It is the group (the
    activation group) unless Kp / p < gs (at bits 3, Kp / 8 < gs), which
    the packing's padding (K a multiple of p * gs, of 8 * gs at bits 3)
    leaves only to a tensor made by hand; then a group is folded in
    parts, each part's int32 dot scaled on its own."""
    chunk = min(gs, Kp // (4 if bits == 3 else 8 // bits))
    if ags:
        chunk = min(chunk, ags)
    return min(chunk, Kp // 8) if bits == 3 else chunk


def group_dots_plain(codes: torch.Tensor, qt: QuantizedTensor,
                     ags: int = 0) -> torch.Tensor:
    """Exact int32 dots (C, N, Mp) of codes (N, Kp) with the weight codes,
    one per fold chunk (fold_chunk: a group or an activation group, or a
    part of one), in k order: one batched float64 matmul (exact in any
    order: every partial sum is an integer below 2^53), on CPU and CUDA
    alike."""
    N, Kp = codes.shape
    ch = fold_chunk(Kp, qt.bits, qt.group_size, ags)
    w = unpack_codes(qt)
    C = Kp // ch
    return torch.einsum("nck,ckm->cnm", codes.double().reshape(N, C, ch),
                        w.double().reshape(C, ch, -1)).to(torch.int32)


def fold_plain(parts: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
               qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """The f32 epilogue on the int32 partials (C, N, Mp) of the C fold
    chunks (group_dots_plain) -> (N, Mp), in the order of
    csrc/qgemm_grouped.cu (that of the compiled reference):
    acc = fma(p_0, x_0, p_1 * x_1), then acc = fma(p_c, x_c, acc) with
    x_c = xs[:, a] * scale[g] of chunk c's activation group a (xs (N, Ga))
    and weight group g; z = fma(xsum[:, g], sub[g], z) from 0 over the
    groups (xsum (N, G)); acc - z (+ residual)."""
    C, Ga, G = parts.shape[0], xs.shape[1], xsum.shape[1]
    scales, sub = qt.scales.float(), qt.sub.float()
    p = parts.float()

    def xscale(c):
        a, g = c * Ga // C, c * G // C
        return xs[:, a:a + 1] * scales[g]

    acc = fma_f32(p[0], xscale(0).expand_as(p[0]), p[1] * xscale(1))
    z = torch.zeros_like(acc)
    # the two chains are independent: a step of each in one fma_f32 call
    for i in range(max(C - 2, G)):
        c, g = i + 2, i
        if c < C and g < G:
            acc, z = fma_f32(torch.stack([p[c], xsum[:, g:g + 1].expand_as(z)]),
                             torch.stack([xscale(c).expand_as(acc), sub[g].expand_as(z)]),
                             torch.stack([acc, z])).unbind(0)
        elif c < C:
            acc = fma_f32(p[c], xscale(c).expand_as(acc), acc)
        else:
            z = fma_f32(xsum[:, g:g + 1].expand_as(z), sub[g].expand_as(z), z)
    out = acc - z
    if residual is not None:
        out = out + residual.float()
    return out


def block_partials_plain(codes: torch.Tensor, qt: QuantizedTensor,
                         ksplit: int, ags: int = 0):
    """The per-group int32 partials each block of a decode cluster keeps in
    its shared memory: for block `rank`, the chunks [u0, u1) of its span
    (decode_spans; a chunk is a group, or with ags an activation group, of
    packed rows), as (u1 - u0, P, N, Mp) int32, entry (c - u0, j) being
    (activation) group j * nchunks + c: slot j's in-place weights
    (decode_slot_weights) against the codes of k = j * Kb + row, shifted
    back.  Exact int64 sums, as the kernel's."""
    P, gs = decode_fields(qt.bits), ags or qt.group_size
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
                     qt: QuantizedTensor, ksplit: int, residual=None,
                     ags: int = 0) -> torch.Tensor:
    """The decode matmul's on-chip fold: partial g read from the block that
    owns chunk g % nchunks (decode_owner), slot g // nchunks, and folded in
    (activation) group order (fold_plain's chain) -> (N, Mp) f32."""
    unit = ags or qt.group_size
    _, _, nchunks = decode_units(qt.kdim_padded, qt.bits, unit)
    owner = decode_owner(nchunks, ksplit)
    parts = torch.stack([blocks[owner[g % nchunks][0]][owner[g % nchunks][1],
                                                        g // nchunks]
                         for g in range(qt.kdim_padded // unit)])
    return fold_plain(parts, xs, xsum, qt, residual)


def qgemm_grouped_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                        glu: bool = False, residual=None,
                        act_gs: int = 0) -> torch.Tensor:
    """The function K4 computes, in plain PyTorch: (N, M) f32; act_gs as
    the reference's act_group_size (effective_ags)."""
    _check_supported(qt, glu, norm, residual)
    ags = effective_ags(qt, act_gs)
    codes, xs, xsum = act_quant_grouped_plain(x, qt, norm, glu, ags)
    parts = group_dots_plain(codes, qt, ags)
    return qt.slice_m(fold_plain(parts, xs, xsum, qt, residual))


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_grouped")
    lib.tmac_act_quant_grouped.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_float, _c_float, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_decode_group_gemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_ptr]
    for fn in (lib.tmac_act_quant_grouped, lib.tmac_decode_group_gemm):
        fn.restype = _c_int
    return lib


@functools.cache
def _lib_k4l(f32: int = 0):
    """K4L's library for bf16 (f32 0) or f32 scales: one source built twice,
    each library with its dtype's instances (csrc/qgemm_grouped_large.cu)."""
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_grouped_large_f32" if f32 else "qgemm_grouped_large")
    lib.tmac_group_gemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_group_gemm.restype = _c_int
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


def _check_ags(kernel: str, qt: QuantizedTensor, ags: int) -> None:
    """Raise unless ags is 0 or an activation group size the kernels take
    (unit_size_ok) below and dividing the group size."""
    if ags and (not unit_size_ok(ags) or qt.group_size % ags or ags >= qt.group_size):
        raise ValueError(f"{kernel} takes an activation group size of 16 or a "
                         f"multiple of 32, below and dividing group_size "
                         f"{qt.group_size}, not {ags}")


def launch_act_quant_grouped(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                             glu: bool = False, kernel: str = "K4", ags: int = 0):
    """Launch the prologue: -> (codes (N, Kp) int8, xs (N, Ga), xsum (N, G));
    Ga = Kp / ags with an activation group size, else G."""
    dev = x.device
    N = x.shape[0]
    K, Kp, gs = qt.kdim, qt.kdim_padded, qt.group_size
    G = Kp // gs
    _check_ags(kernel, qt, ags)
    require(kernel, x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        require(kernel, w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    codes = torch.empty((N, Kp), dtype=torch.int8, device=dev)
    xs = torch.empty((N, Kp // (ags or gs)), dtype=torch.float32, device=dev)
    xsum = torch.empty((N, G), dtype=torch.float32, device=dev)
    err = _lib().tmac_act_quant_grouped(
        x.data_ptr(), N, x.shape[1], K, Kp, gs, ags, int(glu), norm_ptr,
        float(eps), 1.0 / K, codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(),
        _stream(dev))
    raise_on(kernel, err, "prologue")
    return codes, xs, xsum


def launch_decode_grouped(codes: torch.Tensor, xs: torch.Tensor,
                          xsum: torch.Tensor, qt: QuantizedTensor, residual=None,
                          ksplit=None, ags: int = 0) -> torch.Tensor:
    """Launch K4's matmul on its prologue's outputs, right after the
    prologue (it starts while the prologue runs), the group fold on chip:
    -> (N, Mp) f32.  ksplit: the cluster size along K (decode_plan's by
    default).  ags: the activation group size of the prologue's xs (its
    own template instance: one partial and one fold step an activation
    group), or 0."""
    dev = codes.device
    N, Kp, Mp, gs = codes.shape[0], qt.kdim_padded, qt.mdim_padded, qt.group_size
    G = Kp // gs
    _check_ags("K4", qt, ags)
    require("K4", codes, "codes", torch.int8, (N, Kp), dev)
    require("K4", xs, "xs", torch.float32, (N, Kp // (ags or gs)), dev)
    require("K4", xsum, "xsum", torch.float32, (N, G), dev)
    check_kernel_form(qt, "K4")
    hi_ptr = _planes("K4", qt, dev)
    require("K4", qt.scales, "scales", qt.scales.dtype, (G, Mp), dev)
    require("K4", qt.sub, "sub", qt.scales.dtype, (G, Mp), dev)
    if Mp % DECODE_STRIP or codes.data_ptr() % 4 or any(
            t.data_ptr() % 16 for t in (qt.scales, qt.sub)):
        raise ValueError("K4: Mp % 128 == 0, 4-byte aligned codes and 16-byte "
                         "aligned scales and sub")
    res_ptr = None
    if residual is not None:
        require("K4", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    sb = qt.scales.element_size()
    plan, nt = decode_plan(N, Kp, Mp, qt.bits, gs, _sms(dev), ags=ags, scale_bytes=sb)
    check_decode_smem("K4", N, Kp, qt.bits, gs, ksplit or plan, nt, ags=ags,
                      scale_bytes=sb)
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib().tmac_decode_group_gemm(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, gs, ags, qt.bits,
        qt.packed.data_ptr(), hi_ptr, Mp, qt.scales.data_ptr(), qt.sub.data_ptr(),
        scale_f32(qt), res_ptr, out.data_ptr(), ksplit or plan, nt, _stream(dev))
    raise_on("K4", err, "matmul")
    return out


def qgemm_grouped(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None, act_gs: int = 0) -> torch.Tensor:
    """x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32, with the
    activations quantized to int8 per (row, scale group) inside K4.

    norm: (weight (K,), eps) rms_norm before quantization.  glu: x is the
    fused gate_up output and silu(g) * u feeds the matmul.  residual:
    (N, M) added in the epilogue.  act_gs: the reference's act_group_size
    (per (row, activation group) instead, where effective_ags keeps it).
    CPU tensors take the plain version; CUDA tensors take the kernel (x,
    the norm weight and the residual in bf16) below LARGE_N rows; from
    there the route takes K4L, qgemm_grouped_large
    (``ops.qgemm.kernel_for`` picks)."""
    _check_supported(qt, glu, norm, residual)
    if x.device.type == "cpu":
        return qgemm_grouped_plain(x, qt, norm, glu, residual, act_gs)
    check_kernel_form(qt, "K4")
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CPU or CUDA tensors, not {x.device}")
    if x.shape[0] >= LARGE_N:
        raise ValueError(f"K4 takes N < {LARGE_N} rows on the card, not "
                         f"{x.shape[0]}: K4L (qgemm_grouped_large) takes the rest")
    ags = effective_ags(qt, act_gs)
    codes, xs, xsum = launch_act_quant_grouped(x, qt, norm, glu, ags=ags)
    out = launch_decode_grouped(codes, xs, xsum, qt, residual, ags=ags)
    qgemm_grouped.launches += 1
    return qt.slice_m(out)


qgemm_grouped.launches = 0


# K4L's shared memory (csrc/qgemm_grouped_large.cu, k4l_smem): a ring of
# K4L_STAGES depth steps of KT codes for 64 rows (rows of KT + 16 bytes) and
# KT packed rows of 128 columns (two B tiles at bits 3), then
# K4L_FACTOR_BLOCKS slots of the streamed fold factors of K4L_BLOCK_UNITS
# fold units each (2 where the fold units are not a multiple of 4): 64 f32
# row factors and 128 column factors (bf16 or f32) a unit.  The same for
# every K.  The epilogue's z chain passes groups' xsum and sub through the
# idle ring, K4L_ROW_BYTES (64 f32, padded) and 128 factors a group.
K4L_STAGES, K4L_FACTOR_BLOCKS, K4L_BLOCK_UNITS, K4L_ROW_BYTES = 4, 4, 4, 272
K4L_TWO_BLOCKS = 113 * 1024


def k4l_ring(bits: int, kt: int) -> int:
    return K4L_STAGES * (64 * (kt + 16) + kt * 128 * (2 if bits == 3 else 1))


def k4l_smem(bits: int, kt: int, scale_bytes: int = 2) -> int:
    return k4l_ring(bits, kt) + K4L_FACTOR_BLOCKS * K4L_BLOCK_UNITS * (
        64 * 4 + 128 * scale_bytes)


def k4l_kt(bits: int, gs: int, ags: int = 0, scale_bytes: int = 2) -> int:
    """K4L's depth step: 64 where the fold's unit (ags, else gs) is a
    multiple of 64 and, at bits 3, two blocks still fit an SM; else 32 (at
    a unit of 16, two units a step)."""
    unit = ags or gs
    return 64 if unit % 64 == 0 and (
        bits != 3 or k4l_smem(bits, 64, scale_bytes) <= K4L_TWO_BLOCKS) else 32


def launch_group_gemm(codes: torch.Tensor, xs: torch.Tensor,
                      xsum: torch.Tensor, qt: QuantizedTensor,
                      residual=None, ags: int = 0) -> torch.Tensor:
    """Launch K4L's matmul on its prologue's outputs: -> (N, Mp) f32.  ags:
    the prologue's activation group size (its own template instance: one
    int32 accumulator and one fold step an activation group), or 0.  The
    fold's factors stream through a few slots of shared memory, so any K
    fits a block (k4l_smem)."""
    dev = codes.device
    N, Kp, Mp, gs = codes.shape[0], qt.kdim_padded, qt.mdim_padded, qt.group_size
    G = Kp // gs
    _check_ags("K4L", qt, ags)
    Ga = Kp // ags if ags else 0
    require("K4L", codes, "codes", torch.int8, (N, Kp), dev)
    require("K4L", xs, "xs", torch.float32, (N, Ga or G), dev)
    require("K4L", xsum, "xsum", torch.float32, (N, G), dev)
    check_kernel_form(qt, "K4L")
    hi_ptr = _planes("K4L", qt, dev)
    require("K4L", qt.scales, "scales", qt.scales.dtype, (G, Mp), dev)
    require("K4L", qt.sub, "sub", qt.scales.dtype, (G, Mp), dev)
    if Mp % 128 or any(t.data_ptr() % 16 for t in (codes, qt.scales, qt.sub)):
        raise ValueError("K4L: Mp % 128 == 0 and 16-byte aligned codes, scales and sub")
    res_ptr = None
    if residual is not None:
        require("K4L", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib_k4l(scale_f32(qt)).tmac_group_gemm(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, gs, ags, qt.bits,
        qt.packed.data_ptr(), hi_ptr, Mp, qt.scales.data_ptr(), qt.sub.data_ptr(),
        scale_f32(qt), res_ptr, out.data_ptr(), _stream(dev))
    raise_on("K4L", err, "matmul")
    return out


def qgemm_grouped_large(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                        glu: bool = False, residual=None,
                        act_gs: int = 0) -> torch.Tensor:
    """K4L: qgemm_grouped's function on the int8 tensor cores, the group
    fold in registers (csrc/qgemm_grouped_large.cu, group_mma_kernel), the form
    the route takes from LARGE_N rows; any N on a CUDA tensor.  CPU
    tensors take the plain version."""
    _check_supported(qt, glu, norm, residual, "K4L")
    if x.device.type == "cpu":
        return qgemm_grouped_plain(x, qt, norm, glu, residual, act_gs)
    check_kernel_form(qt, "K4L")
    if x.device.type != "cuda":
        raise ValueError(f"K4L runs on CPU or CUDA tensors, not {x.device}")
    ags = effective_ags(qt, act_gs)
    codes, xs, xsum = launch_act_quant_grouped(x, qt, norm, glu, "K4L", ags)
    out = launch_group_gemm(codes, xs, xsum, qt, residual, ags)
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
    in f32 with one rounding (an fma), rounded to bf16.  With bf16 scales
    code * scale is exact, so two steps give the fma's bits: that branch
    exists only because fma_f32 (float64, round to odd) is several times
    slower, on the card's checks too."""
    Kp, Mp, gs = qt.kdim_padded, qt.mdim_padded, qt.group_size
    w = unpack_codes(qt).float().reshape(Kp // gs, gs, Mp)
    sc = qt.scales.float()[:, None].expand_as(w)
    if qt.scales.dtype == torch.bfloat16:
        w = w * sc - qt.sub.float()[:, None]
    else:
        w = fma_f32(w, sc, -qt.sub.float()[:, None].expand_as(w))
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
        _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
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
    check_kernel_form(qt, "K5")
    hi_ptr = _planes("K5", qt, dev, row_multiple=64)
    require("K5", qt.scales, "scales", qt.scales.dtype, (G, Mp), dev)
    require("K5", qt.sub, "sub", qt.scales.dtype, (G, Mp), dev)
    if Mp % 128 or any(t.data_ptr() % 16 for t in (xa, qt.scales, qt.sub)):
        raise ValueError("K5: Mp % 128 == 0 and 16-byte aligned operands")
    res_ptr = None
    if residual is not None:
        require("K5", residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib_large().tmac_qgemm_dequant(
        xa.data_ptr(), N, Kp, gs, qt.bits, qt.packed.data_ptr(), hi_ptr, Mp,
        qt.scales.data_ptr(), qt.sub.data_ptr(), scale_f32(qt), res_ptr, out.data_ptr(),
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
    check_kernel_form(qt, "K5")
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on CPU or CUDA tensors, not {x.device}")
    xa = launch_act_bf16(x, qt, norm, glu)
    out = launch_dequant_gemm(xa, qt, residual)
    qgemm_dequant.launches += 1
    return qt.slice_m(out)


qgemm_dequant.launches = 0
