"""Kernel K7: decode qgemm against the routed experts of a stacked MoE weight.

Replaces ``tmac_tpu/ops/pallas/expert_kernel.py::_expert_kernel`` (reached
through ``qgemm_expert_pallas``), the select form of the MoE MLP at B=1:
x (N, K) [(N, 2K) with the SwiGLU prologue] times expert e of a stacked
QuantizedTensor (packed (E, K/p, Mp), scales and sub (E, G, Mp)), with e
read by the kernel from device memory.  No copy of an expert is made and
the host never learns e, so a decode step that routes through it can be
captured in a CUDA graph.  The CUDA C++ is ``csrc/qgemm_expert.cu``, on the
decode matmul of K1 and K4 (``csrc/decode_matmul.cuh``); the source says
what bounds the kernel on the card and how its design answers it.

The function is K4's (ops/cuda/qgemm_grouped_kernel.py) on expert e: int8
activations per (row, scale group), exact int32 group dots, and the same
f32 fold, whose order is the one XLA compiles the JAX package's grouped
epilogues to on the CPU (the K4 tests hold it bit for bit).  With
per-tensor scales (G = 1, f32 (E, 1, Mp): the w_a8 experts) it is K1's
(ops/cuda/qgemm_kernel.py, N < 64): int8 activations per row, one exact
int32 dot, K1's f32 epilogue.  XLA's compiled
form of the expert kernel itself varies with the shape: it pairs the first
two groups' terms the other way round at some shapes and, from 32 groups,
adds the zero-point dot's group terms in vector lanes.  The port keeps the
one sequential order; tests/test_torch_expert_kernel.py measures the gap.

Two wrappers: ``qgemm_experts(x, stacked, idx)`` runs the k experts of a
route, a (k,) index tensor, in one prologue and one matmul launch (x shared
by the experts, or a block of rows each) -> (k, N, M), the form the MoE
select path calls; ``qgemm_expert(x, stacked, e)`` is its k = 1 case for
one (1,) index.  A CPU tensor goes to the plain PyTorch version
(``qgemm_experts_plain``, ``qgemm_expert_plain``), a CUDA tensor to the
kernel, which either launches or raises.  Each wrapper's ``launches``
counts its own calls that launched the kernel (a call is the prologue and
the matmul together, whatever k).  Ported: the TPU kernel's scope, bits 1,
2 and 4, grouped or per-tensor scales, an unpadded K, N <= 4, grouped at
group size 16 (GGUF's Q2_K experts: two 16-row units a ring stage) or a
multiple of 32, which are every group size the packing and the GGUF
reader give; narrowed to bf16 or f32 scales (f32: GGUF's block scales,
their own template instance) when grouped, f32 scales when per-tensor
(what the model's weights hold).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import qgemm_grouped_plain, unit_size_ok
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (DECODE_STRIP, _sms, act_quant_plain,
                                                  check_decode_smem, decode_epilogue_plain,
                                                  decode_plan, int_dot_plain, raise_on,
                                                  require)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int

MAX_ROWS = 4  # token rows the kernel takes (decode: 1)


def per_tensor(stacked: QuantizedTensor) -> bool:
    """Whether a stack holds one scale per expert and column (G = 1)."""
    return stacked.scales.shape[-2] == 1


def expert_kernel_supported(stacked: QuantizedTensor, act_gs: int = 0) -> bool:
    """Whether a stacked QuantizedTensor is in K7's scope: the JAX
    package's rule (``expert_kernel_supported``: bits 1, 2 or 4, no hi
    plane, a stack, no k-sharding, no k-padding, no activation groups),
    narrowed to the scales the kernel reads: grouped bf16 or f32 scales and
    sub of one dtype with a group size of 16 or a multiple of 32
    (unit_size_ok), or per-tensor f32 ones."""
    if not (stacked.bits in (1, 2, 4)
            and stacked.packed_hi is None
            and stacked.packed.ndim == 3
            and act_gs == 0
            and stacked.k_shards == 1
            and stacked.kdim_padded == stacked.kdim):
        return False
    dtypes = (torch.float32,) if per_tensor(stacked) else (torch.bfloat16, torch.float32)
    return (stacked.scales.dtype == stacked.sub.dtype and stacked.scales.dtype in dtypes
            and (per_tensor(stacked) or unit_size_ok(stacked.group_size)))


def _check_supported(stacked: QuantizedTensor, x: torch.Tensor, glu: bool,
                     per_expert: int = 0):
    """Raise unless `stacked` is in K7's scope and x is (N, width), or
    (per_expert, N, width) with a block of rows for each routed expert."""
    if not expert_kernel_supported(stacked):
        raise ValueError(
            "K7 takes a stacked (E, ...) QuantizedTensor at bits 1, 2 or 4 with "
            "grouped bf16 or f32 or per-tensor f32 scales, k_shards 1 and an "
            "unpadded K")
    width = 2 * stacked.kdim if glu else stacked.kdim
    want = (per_expert, -1, width) if per_expert else (-1, width)
    if x.ndim != len(want) or any(w not in (-1, d) for w, d in zip(want, x.shape)):
        rows = f"({per_expert}, N, {width})" if per_expert else f"(N, {width})"
        raise ValueError(f"K7: x must be {rows}, got {tuple(x.shape)}")


def expert_copy(stacked: QuantizedTensor, e) -> QuantizedTensor:
    """A copy of expert e (a Python int, or a one-element tensor on the
    stack's device, gathered there without a host sync): the plain
    version's operand."""
    if isinstance(e, torch.Tensor):
        idx = e.reshape(1).long()

        def pick(a):
            return torch.index_select(a, 0, idx)[0]
    else:
        def pick(a):
            return a[e]
    hi = pick(stacked.packed_hi) if stacked.packed_hi is not None else None
    return QuantizedTensor(pick(stacked.packed), hi, pick(stacked.scales),
                           pick(stacked.sub), stacked.bits,
                           stacked.group_size, stacked.k_shards,
                           stacked.m_shards, stacked.shape,
                           stacked.m_segments)


def qgemm_expert_plain(x: torch.Tensor, stacked: QuantizedTensor, e,
                       glu: bool = False) -> torch.Tensor:
    """The function K7 computes, in plain PyTorch: K4's plain version on a
    copy of expert e -> (N, M) f32; per-tensor, K1's (N < 64): the row's
    int8 codes, the exact int32 dot, K1's epilogue."""
    _check_supported(stacked, x, glu)
    qt = expert_copy(stacked, e)
    if not per_tensor(stacked):
        return qgemm_grouped_plain(x, qt, glu=glu)
    codes, xs, xsum = act_quant_plain(x, qt, glu=glu)
    return qt.slice_m(decode_epilogue_plain(int_dot_plain(codes, qt), xs, xsum, qt))


def qgemm_experts_plain(x: torch.Tensor, stacked: QuantizedTensor, idx,
                        glu: bool = False) -> torch.Tensor:
    """The function qgemm_experts computes, in plain PyTorch: qgemm_expert_plain
    on each routed expert idx[j] (a (k,) tensor or a list of ints), with x
    shared or x[j] -> (k, N, M) f32."""
    k = len(idx)
    _check_supported(stacked, x, glu, k if x.ndim == 3 else 0)
    rows = list(x) if x.ndim == 3 else [x] * k
    return torch.stack([qgemm_expert_plain(
        rows[j], stacked, idx[j:j + 1] if isinstance(idx, torch.Tensor) else idx[j], glu)
        for j in range(k)])


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_expert")
    lib.tmac_qgemm_experts.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr,
        _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr,
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr]
    lib.tmac_qgemm_experts.restype = _c_int
    return lib


def launch_experts(x: torch.Tensor, stacked: QuantizedTensor, idx: torch.Tensor,
                   glu: bool = False, ksplit=None) -> torch.Tensor:
    """Launch K7's prologue and matmul for the routed experts idx (k,) int32
    on the card: x (N, width) shared by them or (k, N, width), bf16 or f32
    (rounded to bf16 as it is read) -> (k, N, Mp) f32.  ksplit: the
    cluster size along K (decode_plan's for k experts by default; its
    token rows a block and ring stages either way)."""
    dev = x.device
    k = idx.numel()
    per_expert = k if x.ndim == 3 else 0
    _check_supported(stacked, x, glu, per_expert)
    N, x_cols = x.shape[-2:]
    E, K, Mp, bits = (stacked.packed.shape[0], stacked.kdim, stacked.mdim_padded,
                      stacked.bits)
    # per-tensor: one group of K (the C interface's gs = K), K1's split
    gs, G = (K, 1) if per_tensor(stacked) else (stacked.group_size, K // stacked.group_size)
    plan_gs = 0 if G == 1 else gs
    sdtype = stacked.scales.dtype
    if not 1 <= N <= MAX_ROWS:
        raise ValueError(f"K7 takes 1 to {MAX_ROWS} rows, not {N}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K7: x must be bf16 or f32, not {x.dtype}")
    require("K7", x, "x", x.dtype, tuple(x.shape), dev)
    require("K7", idx, "idx", torch.int32, (k,), dev)
    require("K7", stacked.packed, "packed", torch.uint8, (E, K * bits // 8, Mp), dev)
    require("K7", stacked.scales, "scales", sdtype, (E, G, Mp), dev)
    require("K7", stacked.sub, "sub", sdtype, (E, G, Mp), dev)
    # every block copies its expert's weights, scales and zero points 16
    # bytes at a time: the stacks aligned, and Mp % 128 == 0 aligns each
    # expert's offset in them
    if Mp % DECODE_STRIP or any(t.data_ptr() % 16 for t in (
            stacked.packed, stacked.scales, stacked.sub)):
        raise ValueError("K7: Mp % 128 == 0 and 16-byte aligned packed weights, "
                         "scales and sub")
    sb = stacked.scales.element_size()
    plan, nt, stages = decode_plan(N, K, Mp, bits, plan_gs, _sms(dev), experts=k,
                                   scale_bytes=sb)
    check_decode_smem("K7", N, K, bits, plan_gs, ksplit or plan, nt, stages,
                      scale_bytes=sb)
    rows = per_expert * N if per_expert else N
    out = torch.empty((k, N, Mp), dtype=torch.float32, device=dev)
    # the prologue's codes, scales and code sums, read by every matmul block
    codes = torch.empty((rows, K), dtype=torch.int8, device=dev)
    xs = torch.empty((rows, G), dtype=torch.float32, device=dev)
    xsum = torch.empty_like(xs)
    err = _lib().tmac_qgemm_experts(
        x.data_ptr(), int(x.dtype == torch.float32), int(per_expert > 0), N, x_cols,
        K, gs, int(glu), idx.data_ptr(), k, E, stacked.packed.data_ptr(),
        stacked.scales.data_ptr(), stacked.sub.data_ptr(),
        int(sdtype == torch.float32), Mp, bits, out.data_ptr(),
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), ksplit or plan, nt, stages,
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on("K7", err, "kernel")
    return out


def qgemm_experts(x: torch.Tensor, stacked: QuantizedTensor, idx,
                  glu: bool = False) -> torch.Tensor:
    """x @ each routed expert idx[j] of `stacked` -> (k, N, M) f32 in the
    logical column order, activations quantized to int8 per (row, scale
    group) inside K7.

    x: (N, K) [(N, 2K) with glu] shared by the k experts, or (k, N, K)
    [(k, N, 2K)], a block of rows each (down, on each expert's gate_up
    output).  glu: x is the fused gate_up output and silu(g) * u feeds the
    matmul.  CPU tensors take the plain version (idx a tensor or a list of
    ints).  CUDA tensors take the kernel: one prologue and one matmul
    launch for all k experts; x bf16, or f32 rounded to bf16 as it is read,
    with at most 4 rows; idx a (k,) int32 tensor on x's device, read by the
    kernel (an index outside [0, E) gives NaN outputs)."""
    if x.device.type == "cpu":
        return qgemm_experts_plain(x, stacked, idx, glu)
    if x.device.type != "cuda":
        raise ValueError(f"K7 runs on CPU or CUDA tensors, not {x.device}")
    if not isinstance(idx, torch.Tensor):
        raise ValueError("K7 on CUDA takes idx as a (k,) int32 tensor")
    out = launch_experts(x, stacked, idx, glu)
    qgemm_experts.launches += 1
    return stacked.slice_m(out)


qgemm_experts.launches = 0


def qgemm_expert(x: torch.Tensor, stacked: QuantizedTensor, e,
                 glu: bool = False) -> torch.Tensor:
    """x (N, K) [(N, 2K) with glu] @ expert e of `stacked` -> (N, M) f32 in
    the logical column order: qgemm_experts for one expert.

    CPU tensors take the plain version (e an int or a tensor).  CUDA
    tensors take the kernel: x bf16 (or f32, rounded to bf16 as it is
    read) with at most 4 rows, e a one-element int32 tensor on x's device,
    read by the kernel (an e outside [0, E) gives NaN outputs)."""
    _check_supported(stacked, x, glu)
    if x.device.type == "cpu":
        return qgemm_expert_plain(x, stacked, e, glu)
    if x.device.type != "cuda":
        raise ValueError(f"K7 runs on CPU or CUDA tensors, not {x.device}")
    if not isinstance(e, torch.Tensor):
        raise ValueError("K7 on CUDA takes e as a one-element int32 tensor")
    require("K7", e, "e", torch.int32, (1,), x.device)
    out = launch_experts(x, stacked, e, glu)[0]
    qgemm_expert.launches += 1
    return stacked.slice_m(out)


qgemm_expert.launches = 0
