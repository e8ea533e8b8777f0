"""Kernels K1 and K3: per-tensor-scale packed low-bit matmuls with the
activations quantized to int8 per row.

Both replace ``tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel`` on the
two routes that ``qgemm_pallas(act="fused")`` takes for per-tensor scales
(``ops.qgemm.route``): K1, for N < 64 rows of x, its
``fused_quant=True, int_acc=True`` form, as CUDA C++ for Hopper in
``csrc/qgemm_fused.cu``; K3, from 64 rows, its ``single_dot`` form after
the reference's XLA prologue, in ``csrc/qgemm_large.cu`` on K1's prologue.
Each source says what bounds its kernel on the card (device-memory bytes
at decode, the tensor cores at prefill) and how its design answers it.

``qgemm_fused`` (K1) and ``qgemm_large_int`` (K3) are the wrappers: a CPU
tensor goes to the plain PyTorch version ``qgemm_fused_plain`` (which
takes the epilogue of the route for N), a CUDA tensor to the kernel, which
either launches or raises.  Each wrapper's ``launches`` counts calls that
launched its kernel (the quantization prologue and the matmul together).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.qgemm import LARGE_N, QuantizedTensor, unpack_codes
from tmac_tpu_torch.utils import fma_f32

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _check_supported(qt: QuantizedTensor, glu: bool, norm, residual) -> None:
    if qt.bits not in (2, 8):
        raise ValueError(f"K1 takes bits 2 and 8, not {qt.bits}")
    if qt.scales.shape[0] != 1 or qt.k_shards != 1:
        raise ValueError("K1 takes per-tensor scales (G == 1) and k_shards == 1")
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

# XLA's CPU backend adds a row longer than this in windows of this many
# values (kSumWindow in csrc/act_prologue.cuh)
SUM_WINDOW = 32


def row_sum_xla_order(v: torch.Tensor) -> torch.Tensor:
    """Row sums (N, 1) of v (N, n) in the order the JAX reference compiles
    to on the CPU, each addition rounded on its own: a row longer than 32
    is zero-padded evenly on both sides to a multiple of 32, each window
    of 32 is summed from left to right, and the window sums are reduced
    the same way until 32 or fewer remain, which are added from left to
    right.  The prologue kernels add in this order too."""
    W = SUM_WINDOW
    while v.shape[1] > W:
        pad = -v.shape[1] % W
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
        v = v.reshape(v.shape[0], -1, W)
        s = torch.zeros_like(v[:, :, 0])
        for j in range(W):
            s = s + v[:, :, j]
        v = s
    s = torch.zeros_like(v[:, :1])
    for j in range(v.shape[1]):
        s = s + v[:, j:j + 1]
    return s


def prologue_values(x: torch.Tensor, K: int, Kp: int, norm=None,
                    glu: bool = False) -> torch.Tensor:
    """x (N, K) or (N, 2K) -> the f32 values (N, Kp) that are quantized:
    silu(g) * u with glu, then rms_norm with norm (variance over the
    logical K), zero past K.  Written as the prologue kernels compute them
    (IEEE exp, sqrt and division, the row sum in the reference's order),
    so that kernel and plain version agree bit for bit."""
    xf = x.to(torch.bfloat16).float()
    if glu:
        g = xf[:, :K]
        xf = g * (1.0 / (1.0 + torch.exp(-g))) * xf[:, K:]
    xf = torch.nn.functional.pad(xf, (0, Kp - K))
    if norm is not None:
        xf = rms_norm_values(xf, norm[0], norm[1], K)
    return xf


def rms_norm_values(xf: torch.Tensor, w: torch.Tensor, eps: float,
                    K: int) -> torch.Tensor:
    """rms_norm of f32 rows xf (N, Kp), zero past the logical K, with the
    weight w (K,): (xf * (1 / sqrt(var + eps))) * w, the variance over K
    with the row sum in the reference's order (the prologue kernels' and
    K10's steps)."""
    var = row_sum_xla_order(xf * xf) * (1.0 / K)
    xf = xf * (1.0 / torch.sqrt(var + eps))
    return xf * torch.nn.functional.pad(w.float(), (0, xf.shape[1] - K))


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """The int8 scale of an absmax, as XLA compiles the JAX package's
    `max(amax, 1e-20) / 127.0`: times the f32 reciprocal of 127."""
    return torch.clamp_min(amax, 1e-20) * torch.full_like(amax, 1.0 / 127.0)


def act_quant_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                    glu: bool = False, large_n: bool = False):
    """The prologue: x (N, K) or (N, 2K) -> (codes int8 (N, Kp) in natural
    k order, xs (N,) f32, xsum (N,) f32), as the TPU kernel's step 0.
    xsum is the code sum times xs, or the bare code sum for the large-N
    epilogue."""
    xf = prologue_values(x, qt.kdim, qt.kdim_padded, norm, glu)
    xs = act_scale(xf.abs().amax(1, keepdim=True))
    # the codes take a true division, by a tensor: on CUDA PyTorch turns
    # division by a Python scalar into a reciprocal multiply
    q = torch.clamp(torch.round(xf / xs), -127, 127)
    xsum = q.sum(1, keepdim=True)
    if not large_n:
        xsum = xsum * xs
    return q.to(torch.int8), xs[:, 0], xsum[:, 0]


def int_dot_plain(codes: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Exact int32 codes (N, Kp) @ weight codes (Kp, Mp): a float64 matmul
    (exact: |sum| <= 127 * 255 * Kp < 2^53) that runs on CPU and CUDA."""
    w = unpack_codes(qt)
    return (codes.double() @ w.double()).to(torch.int32)


def dp4a_order(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Natural-order codes (N, Kp) -> the grouping K1's prologue writes:
    byte j of 32-bit word q holds the code of k = q + j*Kp/4 for bits=2
    (the packed field order) and of k = 4q + j for bits=8."""
    if bits == 8:
        return codes
    N, Kp = codes.shape
    return codes.reshape(N, 4, Kp // 4).transpose(1, 2).reshape(N, Kp)


def qgemm_fused_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                      glu: bool = False, residual=None) -> torch.Tensor:
    """The function K1 (N < LARGE_N) and K3 (from LARGE_N rows) compute, in
    plain PyTorch: (N, M) f32.  The f32 epilogue is the one the reference
    compiles to on its route for N (the headers of csrc/qgemm_fused.cu and
    csrc/qgemm_large.cu), every step rounded as there."""
    _check_supported(qt, glu, norm, residual)
    large = x.shape[0] >= LARGE_N
    codes, xs, xsum = act_quant_plain(x, qt, norm, glu, large)
    acc = int_dot_plain(codes, qt).float()
    scale, xs = qt.scales[0].float().expand_as(acc), xs[:, None].expand_as(acc)
    zero_fold = -(xsum[:, None] * qt.sub[0].float())
    if large:
        out = fma_f32(acc, scale, zero_fold)
        out = (out * xs if residual is None
               else fma_f32(out, xs, residual.float()))
    else:
        out = fma_f32(acc * scale, xs, zero_fold)
        if residual is not None:
            out = out + residual.float()
    return qt.slice_m(out)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_fused")
    lib.tmac_act_quant.argtypes = [
        _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int, _c_ptr, _c_float,
        _c_float, _c_int, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_act_quant.restype = _c_int
    lib.tmac_qgemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_qgemm.restype = _c_int
    return lib


def require(kernel: str, t: torch.Tensor, what: str, dtype, shape,
            device) -> None:
    """Raise unless t is what `kernel`'s C interface takes."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {what} must be a contiguous {dtype} {tuple(shape)} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def raise_on(kernel: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel} {what} launch failed with CUDA error {err}")


def launch_act_quant(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                     glu: bool = False, large_n: bool = False):
    """Launch K1's prologue (K3's with large_n): -> (codes (N, Kp) int8
    in dp4a grouping, xs (N,), xsum (N,)); xsum as act_quant_plain gives
    it."""
    dev = x.device
    N = x.shape[0]
    K, Kp = qt.kdim, qt.kdim_padded
    require("K1", x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        require("K1", w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    codes = torch.empty((N, Kp), dtype=torch.int8, device=dev)
    xs = torch.empty((N,), dtype=torch.float32, device=dev)
    xsum = torch.empty((N,), dtype=torch.float32, device=dev)
    err = _lib().tmac_act_quant(
        x.data_ptr(), N, x.shape[1], K, Kp, int(glu), norm_ptr, float(eps),
        1.0 / K, qt.bits, int(large_n), codes.data_ptr(), xs.data_ptr(),
        xsum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    raise_on("K1", err, "prologue")
    return codes, xs, xsum


def _check_gemm_args(kernel: str, codes, xs, xsum, qt: QuantizedTensor,
                     residual):
    """Raise unless the prologue's outputs, the weights and the residual
    are what `kernel`'s matmul takes; -> the residual's pointer or None."""
    dev = codes.device
    N, Kp, Mp = codes.shape[0], qt.kdim_padded, qt.mdim_padded
    require(kernel, codes, "codes", torch.int8, (N, Kp), dev)
    require(kernel, xs, "xs", torch.float32, (N,), dev)
    require(kernel, xsum, "xsum", torch.float32, (N,), dev)
    rows = Kp // 4 if qt.bits == 2 else Kp
    require(kernel, qt.packed, "packed", torch.uint8, (rows, Mp), dev)
    require(kernel, qt.scales, "scales", torch.float32, (1, Mp), dev)
    require(kernel, qt.sub, "sub", torch.float32, (1, Mp), dev)
    if residual is None:
        return None
    require(kernel, residual, "residual", torch.bfloat16, (N, Mp), dev)
    return residual.data_ptr()


def launch_gemm(codes: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """Launch K1's matmul on its prologue's outputs (large_n off): ->
    (N, Mp) f32."""
    res_ptr = _check_gemm_args("K1", codes, xs, xsum, qt, residual)
    N, Mp = codes.shape[0], qt.mdim_padded
    if qt.packed.data_ptr() % 4 or Mp % 32:
        raise ValueError("K1: packed must be 4-byte aligned with Mp % 32 == 0")
    out = torch.empty((N, Mp), dtype=torch.float32, device=codes.device)
    err = _lib().tmac_qgemm(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, qt.kdim_padded,
        qt.bits, qt.packed.data_ptr(), qt.scales.data_ptr(),
        qt.sub.data_ptr(), Mp, res_ptr, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on("K1", err, "matmul")
    return out


def _on_device(kernel: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU one (the
    plain version runs); raise on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CPU or CUDA tensors, not {x.device}")
    return x.device.type == "cuda"


def qgemm_fused(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                glu: bool = False, residual=None) -> torch.Tensor:
    """K1: x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32 for N < 64
    rows, with the activations quantized per row to int8 inside the kernel.

    norm: (weight (K,), eps) rms_norm before quantization.  glu: x is the
    fused gate_up output and silu(g) * u feeds the matmul.  residual:
    (N, M) added in the epilogue.  CPU tensors take the plain version; CUDA
    tensors take the kernel (x, the norm weight and the residual in bf16).
    From 64 rows the reference takes another route: K3, qgemm_large_int
    (``ops.qgemm.kernel_for`` picks)."""
    _check_supported(qt, glu, norm, residual)
    if x.shape[0] >= LARGE_N:
        raise ValueError(f"K1 takes N < {LARGE_N} rows, not {x.shape[0]}: "
                         "K3 (qgemm_large_int) takes the rest")
    if not _on_device("K1", x):
        return qgemm_fused_plain(x, qt, norm, glu, residual)
    codes, xs, xsum = launch_act_quant(x, qt, norm, glu)
    out = launch_gemm(codes, xs, xsum, qt, residual)
    qgemm_fused.launches += 1
    return qt.slice_m(out)


qgemm_fused.launches = 0


@functools.cache
def _lib_large():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("qgemm_large")
    lib.tmac_qgemm_large_int.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_qgemm_large_int.restype = _c_int
    return lib


def launch_large_int(codes: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                     qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """Launch K3's matmul on K1's prologue outputs (large_n on): -> (N, Mp)
    f32."""
    res_ptr = _check_gemm_args("K3", codes, xs, xsum, qt, residual)
    N, Kp, Mp = codes.shape[0], qt.kdim_padded, qt.mdim_padded
    if Kp % 16 or Mp % 128 or qt.packed.data_ptr() % 16:
        raise ValueError("K3: Kp % 16 == 0, Mp % 128 == 0 and 16-byte "
                         "aligned packed weights")
    out = torch.empty((N, Mp), dtype=torch.float32, device=codes.device)
    err = _lib_large().tmac_qgemm_large_int(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, qt.bits,
        qt.packed.data_ptr(), qt.scales.data_ptr(), qt.sub.data_ptr(), Mp,
        res_ptr, out.data_ptr(),
        torch.cuda.current_stream(codes.device).cuda_stream)
    raise_on("K3", err, "matmul")
    return out


def qgemm_large_int(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                    glu: bool = False, residual=None) -> torch.Tensor:
    """K3: qgemm_fused's function for N >= 64 rows, on the reference's
    large-N route (its single int8 dot and that route's epilogue): K1's
    prologue with the bare code sum, then one exact int32 dot over the
    whole depth on the tensor cores."""
    _check_supported(qt, glu, norm, residual)
    if x.shape[0] < LARGE_N:
        raise ValueError(f"K3 takes N >= {LARGE_N} rows, not {x.shape[0]}: "
                         "K1 (qgemm_fused) takes fewer")
    if not _on_device("K3", x):
        return qgemm_fused_plain(x, qt, norm, glu, residual)
    codes, xs, xsum = launch_act_quant(x, qt, norm, glu, large_n=True)
    out = launch_large_int(codes, xs, xsum, qt, residual)
    qgemm_large_int.launches += 1
    return qt.slice_m(out)


qgemm_large_int.launches = 0
