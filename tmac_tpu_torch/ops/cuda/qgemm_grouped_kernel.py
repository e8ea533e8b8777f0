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

The forms whose activations reach the kernel from outside (``qgemm_pallas``
with act "int8", "auto" or "native"; ``ops.qgemm.form``), each a wrapper
with its own ``launches`` and a plain version:
  * E2, ``qgemm_grouped_ext`` (``grouped_ext_plain``): int8 activations
    per group from outside, K4's matmul below LARGE_N rows and K4L's from
    there on the caller's codes, xs and xsum: float x quantized per
    activation group as the reference's XLA prologue does
    (``act_quant_external``; K4's prologue kernel where its bytes are
    those: bf16 x, and no ags below LARGE_N rows), or int8 x as given
    (xs = 1, the reference's float-fold branch on int8 operands); one
    scale row too, as a grouped tensor of the reference's fold chunks
    (``as_grouped``), or, at bits 8 (one chunk, folded once), K4L's
    one-unit fold at any N;
  * E3, ``qgemm_native`` (``native_plain``): float dots on bf16 or f32 x,
    a fold chunk at a time, f32 sums (the reference's act="native", pinned
    to the chunk path): K4's native kernel (``k4_native_kernel`` in
    ``csrc/qgemm_grouped.cu``, an instance for each x dtype) on bf16 x
    below LARGE_N rows and on f32 x at any N (the tensor cores have no f32
    x bf16 product), K4L's native instances on bf16 x from there
    (``csrc/qgemm_grouped_large_native.cu``, m16n8k16 bf16); only the sum
    order inside a chunk differs from the plain version's (and, on f32 x,
    the kernel's fma rounding each product with its sum), so each output
    is held to native_bound of it;
  * E4, ``qgemm_dequant_ext`` (``dequant_ext_plain``): float x at the
    dequant dot (act "auto" from 64 rows where the dispatch is "dequant"):
    K5 on x rounded to bf16, with no norm or glu.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from tmac_tpu_torch.ops.cuda.qgemm_kernel import (DECODE_STRIP, _on_device, _sms, act_scale,
                                                  check_decode_smem, decode_fields,
                                                  decode_owner, decode_plan,
                                                  decode_slot_weights,
                                                  decode_spans, decode_units,
                                                  prologue_values, raise_on,
                                                  require)
from tmac_tpu_torch.ops.qgemm import (LARGE_N, QuantizedTensor, effective_ags,
                                      pad_x_for, unpack_codes)
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
    _check_folds(qt, glu, norm, residual)


def _check_folds(qt: QuantizedTensor, glu: bool, norm, residual) -> None:
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
    chunks (group_dots_plain; or E3's f32 sums) -> (N, Mp), in the order of
    csrc/qgemm_grouped.cu (that of the compiled reference):
    acc = fma(p_0, x_0, p_1 * x_1), then acc = fma(p_c, x_c, acc) with
    x_c = xs[:, a] * scale[g] of chunk c's activation group a (xs (N, Ga))
    and weight group g (p_0 * x_0 alone for one chunk: bits 8 at one scale
    row); z = fma(xsum[:, g], sub[g], z) from 0 over the groups (xsum (N,
    G)); acc - z (+ residual)."""
    C, Ga, G = parts.shape[0], xs.shape[1], xsum.shape[1]
    scales, sub = qt.scales.float(), qt.sub.float()
    p = parts.float()

    def xscale(c):
        a, g = c * Ga // C, c * G // C
        return xs[:, a:a + 1] * scales[g]

    acc = (p[0] * xscale(0) if C == 1 else
           fma_f32(p[0], xscale(0).expand_as(p[0]), p[1] * xscale(1)))
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
    lib.tmac_decode_native.argtypes = [
        _c_ptr, _c_int, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
        _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
    for fn in (lib.tmac_act_quant_grouped, lib.tmac_decode_group_gemm,
               lib.tmac_decode_native):
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


# ---------------------------------------------------------------------------
# The forms whose activations come from outside: E2, E3, E4
# ---------------------------------------------------------------------------

def _check_ext(qt: QuantizedTensor, x: torch.Tensor, residual, kernel: str) -> None:
    """Raise unless the form takes qt (one scale row, or what
    weights_form_error takes), x (N, K) and the residual."""
    if qt.scales.shape[0] > 1:
        _check_supported(qt, False, None, residual, kernel)
    else:
        if (qt.bits not in GROUPED_BITS or (qt.bits == 3) != (qt.packed_hi is not None)
                or qt.k_shards != 1):
            raise ValueError(f"{kernel} takes bits 1 to 4 and 8 (a hi plane at bits 3 "
                             "only) and k_shards == 1")
        _check_folds(qt, False, None, residual)
    if x.dim() != 2 or x.shape[1] != qt.kdim:
        raise ValueError(f"{kernel} takes x (N, {qt.kdim}), not {tuple(x.shape)}")


def act_quant_external(x: torch.Tensor, qt: QuantizedTensor, ags: int = 0):
    """E2's quantization of float x, the reference's XLA prologue in
    qgemm_pallas (act "int8", or "auto" on the chunk path): x (N, K) in
    f32 (bf16 widened exactly), zero-padded to Kp -> (codes (N, Kp) int8,
    xs (N, Ga), xsum (N, G)): per activation group of ags columns (of
    group_size at ags 0, Ga = G; of Kp at one scale row) xs =
    max(amax, 1e-20) * (1/127), codes rint(x / xs) clamped to +-127 (a true
    division), and each weight group's dequantized code sum in the order
    XLA adds it there (weight_group_sums' N >= LARGE_N order at any N)."""
    xf = pad_x_for(x.float(), qt)
    N, Kp = xf.shape
    a = ags or qt.group_size
    xg = xf.reshape(N, Kp // a, a)
    xs = act_scale(xg.abs().amax(-1))
    q = torch.clamp(torch.round(xg / xs[..., None]), -127, 127)
    qs = q.sum(-1)
    xsum = weight_group_sums(qs, xs, qt.group_size // ags, True) if ags else qs * xs
    return q.reshape(N, Kp).to(torch.int8), xs, xsum


def external_int8(x: torch.Tensor, qt: QuantizedTensor, ags: int = 0):
    """E2's (codes (N, Kp), xs, xsum): float x through act_quant_external;
    int8 x as given, xs = 1 and xsum its exact code sums a scale group (the
    reference's float-fold branch: part * scale, no activation scale)."""
    if x.dtype != torch.int8:
        return act_quant_external(x, qt, ags)
    codes = pad_x_for(x, qt)
    N, Kp, G = codes.shape[0], codes.shape[1], qt.scales.shape[0]
    xsum = codes.reshape(N, G, Kp // G).to(torch.int32).sum(-1).float()
    return codes, torch.ones_like(xsum), xsum


def one_row_zero_fold(acc: torch.Tensor, xsum: torch.Tensor, qt: QuantizedTensor,
                      residual=None) -> torch.Tensor:
    """E2's epilogue at one scale row: the reference's xsum @ sub has one
    term there, and XLA fuses it into the subtraction: fma(-xsum, sub, acc)
    (+ residual), acc (N, Mp) the chain's f32 sum."""
    out = fma_f32(-xsum.expand_as(acc), qt.sub.float().expand_as(acc), acc)
    return out if residual is None else out + residual.float()


def grouped_ext_plain(x: torch.Tensor, qt: QuantizedTensor, residual=None,
                      act_gs: int = 0) -> torch.Tensor:
    """E2 in plain PyTorch: external_int8's codes, exact int32 dots a fold
    chunk (group_dots_plain) and the f32 fold (fold_plain; at one scale row
    its chain, then one_row_zero_fold, or at one chunk E1's epilogue).  act_gs as the reference's
    act_group_size (float x only).  -> (N, M) f32."""
    _check_ext(qt, x, residual, "E2")
    ags = effective_ags(qt, act_gs) if x.dtype != torch.int8 else 0
    codes, xs, xsum = external_int8(x, qt, ags)
    parts = group_dots_plain(codes, qt, ags)
    if qt.scales.shape[0] > 1:
        return qt.slice_m(fold_plain(parts, xs, xsum, qt, residual))
    if parts.shape[0] > 1:
        acc = fold_plain(parts, xs, torch.zeros_like(xsum), qt)
        return qt.slice_m(one_row_zero_fold(acc, xsum, qt, residual))
    # one chunk (bits 8): fma(p, xs * scale, -(xsum * sub)), E1's pattern
    p = parts[0].float()
    x0 = (xs[:, :1] * qt.scales.float()[0]).expand_as(p)
    out = fma_f32(p, x0, -(xsum * qt.sub.float()[0]).expand_as(p))
    return qt.slice_m(out if residual is None else out + residual.float())


def as_grouped(qt: QuantizedTensor, xs, xsum: torch.Tensor):
    """One scale row as the grouped kernels take it: the reference folds
    its C chunks (fold_chunk: Kp / p, at bits 3 Kp / 8) one at a time with
    the one scale, so a tensor of C groups of that size with the row
    repeated, xs (N, 1) repeated, and xsum (N, 1) followed by zeros (z =
    fma(xsum, sub, 0), then fma(0, sub, z) = z) computes the same chain.
    (E2 passes xsum 0 and folds the zero point after, one_row_zero_fold.)
    Grouped tensors come back as they are, and so does one chunk (bits 8,
    Kp a multiple of 32: K4L's one fold unit).  Raises where the kernels
    cannot take the chunk (not 16 or a multiple of 32)."""
    if qt.scales.shape[0] > 1:
        return qt, xs, xsum
    Kp = qt.kdim_padded
    ch = fold_chunk(Kp, qt.bits, Kp)
    G = Kp // ch
    if G == 1 and Kp % 32 == 0:
        # one chunk (bits 8): K4L folds it as its one unit
        return qt, xs, xsum
    if not unit_size_ok(ch) or G == 1:
        raise ValueError(f"the grouped kernels fold one scale row in chunks of {ch} at "
                         f"bits {qt.bits}: of 16 or a multiple of 32 (one chunk: of Kp "
                         "a multiple of 32)")
    q = dataclasses.replace(qt, scales=qt.scales.expand(G, -1).contiguous(),
                            sub=qt.sub.expand(G, -1).contiguous(), group_size=ch)
    xs = xs.expand(-1, G).contiguous() if xs is not None else None
    return q, xs, torch.nn.functional.pad(xsum, (0, G - 1)).contiguous()


def qgemm_grouped_ext(x: torch.Tensor, qt: QuantizedTensor, residual=None,
                      act_gs: int = 0) -> torch.Tensor:
    """E2: x (N, K) float or int8 @ Wdq -> (N, M) f32, the activations
    quantized per group outside the kernel (external_int8), then K4's
    matmul below LARGE_N rows or K4L's from there.  Float x: K4's prologue
    kernel where it writes the reference's bytes (bf16 x, grouped scales,
    and no ags below LARGE_N rows, where its ags order is the fused
    kernel's), torch ops otherwise.  CPU tensors take grouped_ext_plain."""
    _check_ext(qt, x, residual, "E2")
    if not _on_device("E2", x):
        return grouped_ext_plain(x, qt, residual, act_gs)
    N = x.shape[0]
    ags = effective_ags(qt, act_gs) if x.dtype != torch.int8 else 0
    if x.dtype == torch.bfloat16 and qt.scales.shape[0] > 1 and (not ags or N >= LARGE_N):
        codes, xs, xsum = launch_act_quant_grouped(x.contiguous(), qt, ags=ags,
                                                   kernel="K4L" if N >= LARGE_N else "K4")
    else:
        codes, xs, xsum = external_int8(x, qt, ags)
    one_row = qt.scales.shape[0] == 1
    codes = codes.contiguous()
    # one scale row: the chain on the card (z = 0), the fused zero fold after
    qk, xs_k, xsum_k = as_grouped(qt, xs.contiguous(),
                                  torch.zeros_like(xsum) if one_row else xsum.contiguous())
    if qk.scales.shape[0] == 1:
        # one chunk (bits 8), which the reference folds once, fma(p, xs *
        # scale, -(xsum * sub)): K4L's one-unit fold takes xsum, at any N
        out = launch_group_gemm(codes, xs_k, xsum.contiguous(), qk, residual)
    else:
        res_k = None if one_row else residual
        if N < LARGE_N:
            out = launch_decode_grouped(codes, xs_k, xsum_k, qk, res_k, ags=ags)
        else:
            out = launch_group_gemm(codes, xs_k, xsum_k, qk, res_k, ags)
        if one_row:
            out = one_row_zero_fold(out, xsum, qt, residual)
    qgemm_grouped_ext.launches += 1
    return qt.slice_m(out)


qgemm_grouped_ext.launches = 0


def native_sums(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """E3's xsum: the f32 sums of x (zero-padded to Kp) a scale group, (N, G)
    (the reference's XLA reduction; its order is not followed)."""
    xf = pad_x_for(x.float(), qt)
    N, G = xf.shape[0], qt.scales.shape[0]
    return xf.reshape(N, G, -1).sum(-1)


def native_parts_plain(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """E3's per-chunk sums (C, N, Mp) f32: x (in f32, bf16 widened exactly)
    times the codes (as floats), a fold chunk (fold_chunk) at a time; the
    sums f32 (TF32 off on the card), every product exact on bf16 x (on f32
    x rounded once, as the reference's f32 dot)."""
    xf = pad_x_for(x.float(), qt)
    N, Kp = xf.shape
    ch = fold_chunk(Kp, qt.bits, qt.group_size)
    w = unpack_codes(qt).float()
    return torch.einsum("nck,ckm->cnm", xf.reshape(N, Kp // ch, ch),
                        w.reshape(Kp // ch, ch, -1))


def native_plain(x: torch.Tensor, qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """E3 in plain PyTorch: native_parts_plain's chunk sums folded with the
    scales (fold_plain with xs = 1), minus native_sums @ sub.  -> (N, M)
    f32."""
    _check_ext(qt, x, residual, "E3")
    xsum = native_sums(x, qt)
    return qt.slice_m(fold_plain(native_parts_plain(x, qt), torch.ones_like(xsum), xsum, qt,
                                 residual))


def native_bound(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Where E3's kernel and plain version may differ, an output at a time:
    bf16 x, sqrt(chunk) * 2^-23 * sum |x * Wdq| (every product exact, only
    the order of a chunk's f32 sums differs); f32 x, (sqrt(chunk) + 1) *
    2^-23 * sum |x * Wdq| (K4's native kernel adds each product to its sum
    in one fma, where the plain version rounds each f32 product first: at
    most 2^-24 of each term more).  -> (N, M) f32."""
    xf = pad_x_for(x.float(), qt).abs()
    ch = fold_chunk(qt.kdim_padded, qt.bits, qt.group_size)
    w = unpack_codes(qt).float().reshape(qt.scales.shape[0], -1, qt.mdim_padded)
    w = (w * qt.scales.float()[:, None] - qt.sub.float()[:, None]).abs()
    f = ch ** 0.5 if x.dtype == torch.bfloat16 else ch ** 0.5 + 1
    return qt.slice_m(xf @ w.reshape(qt.kdim_padded, -1)) * (f * 2.0 ** -23)


@functools.cache
def _lib_native():
    """K4L's native instances, both scale dtypes
    (csrc/qgemm_grouped_large_native.cu)."""
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_grouped_large_native")
    lib.tmac_group_gemm_native.argtypes = [
        _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_ptr, _c_int,
        _c_ptr, _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_group_gemm_native.restype = _c_int
    return lib


NATIVE_X = (torch.bfloat16, torch.float32)  # the x dtypes E3's kernels take


def _native_args(kernel: str, xb: torch.Tensor, xsum: torch.Tensor, qt: QuantizedTensor,
                 residual, cols: int):
    """Raise unless the native kernels take these operands; -> (hi plane
    pointer, residual pointer)."""
    dev = xb.device
    N, Kp, Mp, G = xb.shape[0], qt.kdim_padded, qt.mdim_padded, qt.scales.shape[0]
    if xb.dtype not in NATIVE_X:
        raise ValueError(f"{kernel}'s native form takes bf16 or f32 x, not {xb.dtype}")
    require(kernel, xb, "x", xb.dtype, (N, Kp), dev)
    require(kernel, xsum, "xsum", torch.float32, (N, G), dev)
    check_kernel_form(qt, kernel)
    require(kernel, qt.scales, "scales", qt.scales.dtype, (G, Mp), dev)
    require(kernel, qt.sub, "sub", qt.scales.dtype, (G, Mp), dev)
    if Mp % cols or any(t.data_ptr() % 16 for t in (xb, qt.scales, qt.sub)):
        raise ValueError(f"{kernel}: Mp % {cols} == 0 and 16-byte aligned x, scales and sub")
    res_ptr = None
    if residual is not None:
        require(kernel, residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    return res_ptr


def launch_decode_native(xb: torch.Tensor, xsum: torch.Tensor, qt: QuantizedTensor,
                         residual=None) -> torch.Tensor:
    """Launch K4's native kernel (E3: bf16 x below LARGE_N rows, f32 x at
    any N) on x (N, Kp) and its sums xsum (N, G): -> (N, Mp) f32."""
    res_ptr = _native_args("K4", xb, xsum, qt, residual, 64)
    Kp, bits = qt.kdim_padded, qt.bits
    rows = Kp // 4 if bits == 3 else Kp * bits // 8
    require("K4", qt.packed, "packed", torch.uint8, (rows, qt.mdim_padded), xb.device)
    if bits == 3:
        require("K4", qt.packed_hi, "packed_hi", torch.uint8, (Kp // 8, qt.mdim_padded),
                xb.device)
    out = torch.empty((xb.shape[0], qt.mdim_padded), dtype=torch.float32, device=xb.device)
    err = _lib().tmac_decode_native(
        xb.data_ptr(), int(xb.dtype == torch.float32), xsum.data_ptr(), xb.shape[0], Kp,
        qt.group_size,
        fold_chunk(Kp, bits, qt.group_size), bits, qt.packed.data_ptr(),
        qt.packed_hi.data_ptr() if bits == 3 else None, qt.mdim_padded,
        qt.scales.data_ptr(), qt.sub.data_ptr(), scale_f32(qt), res_ptr, out.data_ptr(),
        _stream(xb.device))
    raise_on("K4", err, "native matmul")
    return out


def launch_group_gemm_native(xb: torch.Tensor, xsum: torch.Tensor, qt: QuantizedTensor,
                             residual=None) -> torch.Tensor:
    """Launch K4L's native instance (E3 on bf16 x from LARGE_N rows) on x
    (N, Kp) and xsum (N, G), G >= 2 (or one unit: bits 8 at one scale
    row): -> (N, Mp) f32."""
    res_ptr = _native_args("K4L", xb, xsum, qt, residual, 128)
    if xb.dtype != torch.bfloat16:
        raise ValueError(f"K4L's native form takes bf16 x, not {xb.dtype}")
    hi_ptr = _planes("K4L", qt, xb.device)
    out = torch.empty((xb.shape[0], qt.mdim_padded), dtype=torch.float32, device=xb.device)
    err = _lib_native().tmac_group_gemm_native(
        xb.data_ptr(), xsum.data_ptr(), xb.shape[0], qt.kdim_padded, qt.group_size,
        qt.bits,
        qt.packed.data_ptr(), hi_ptr, qt.mdim_padded, qt.scales.data_ptr(), qt.sub.data_ptr(),
        scale_f32(qt), res_ptr, out.data_ptr(), _stream(xb.device))
    raise_on("K4L", err, "native matmul")
    return out


def qgemm_native(x: torch.Tensor, qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """E3: x (N, K) @ Wdq -> (N, M) f32 with float dots on x's own dtype
    (the reference's act="native"), bf16 or f32: K4's native kernel on bf16
    x below LARGE_N rows and on f32 x at any N, K4L's native instance on
    bf16 x from there (one scale row as_grouped; at bits 8 its one chunk as
    K4L's one unit).  CPU tensors take native_plain."""
    _check_ext(qt, x, residual, "E3")
    if not _on_device("E3", x):
        return native_plain(x, qt, residual)
    if x.dtype not in NATIVE_X:
        raise ValueError(f"E3 on the card takes bf16 or f32 x, not {x.dtype}")
    xb = pad_x_for(x, qt).contiguous()
    xsum = native_sums(x, qt)
    if x.shape[0] < LARGE_N or x.dtype == torch.float32:
        out = launch_decode_native(xb, xsum, qt, residual)
    else:
        qk, _, xsum = as_grouped(qt, None, xsum)
        out = launch_group_gemm_native(xb, xsum, qk, residual)
    qgemm_native.launches += 1
    return qt.slice_m(out)


qgemm_native.launches = 0


def dequant_ext_plain(x: torch.Tensor, qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """E4 in plain PyTorch: K5's function on x rounded to bf16, with no
    norm or glu (qgemm_dequant_plain)."""
    _check_supported(qt, False, None, residual, "K5")
    return qgemm_dequant_plain(x, qt, residual=residual)


def qgemm_dequant_ext(x: torch.Tensor, qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """E4: float x (N, K) @ Wdq -> (N, M) f32 at the dequant dot: x rounded
    to bf16 and zero-padded (as the reference's kernel casts it), then K5's
    matmul, no prologue kernel.  CPU tensors take dequant_ext_plain."""
    _check_supported(qt, False, None, residual, "K5")
    if not _on_device("E4", x):
        return dequant_ext_plain(x, qt, residual)
    out = launch_dequant_gemm(pad_x_for(x.to(torch.bfloat16), qt).contiguous(), qt, residual)
    qgemm_dequant_ext.launches += 1
    return qt.slice_m(out)


qgemm_dequant_ext.launches = 0
