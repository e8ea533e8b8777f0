"""Kernel K1: fused activation quantization + packed low-bit matmul.

Replaces ``tmac_tpu/ops/pallas/qgemm_kernel.py::_make_kernel`` (the
``fused_quant=True, int_acc=True`` form that ``qgemm_pallas(act="fused")``
reaches for per-tensor scales), as CUDA C++ for Hopper in
``csrc/qgemm_fused.cu``.  That source says what bounds the kernel on the
card (device-memory bytes at decode) and how its design answers it.

``qgemm_fused`` is the wrapper: a CPU tensor goes to the plain PyTorch
version ``qgemm_fused_plain``, a CUDA tensor to the kernel, which either
launches or raises.  ``qgemm_fused.launches`` counts kernel launches (one
per call: the quantization prologue and the matmul together).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes

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

# threads of the prologue kernel (kQuantThreads in csrc/qgemm_fused.cu)
PROLOGUE_THREADS = 512


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of v (N, K) in the prologue kernel's order, each addition
    rounded on its own: thread t adds k = t, t + 512, ...; each warp of 32
    threads folds its values with an xor butterfly (16, 8, 4, 2, 1); the
    16 warp values are added in warp order."""
    N, K = v.shape
    T = PROLOGUE_THREADS
    v = torch.nn.functional.pad(v, (0, -K % T)).reshape(N, -1, T)
    s = v[:, 0]
    for i in range(1, v.shape[1]):
        s = s + v[:, i]
    s = s.reshape(N, T // 32, 32)
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    s = s[..., 0]
    out = s[:, 0]
    for w in range(1, s.shape[1]):
        out = out + s[:, w]
    return out[:, None]


def act_quant_plain(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                    glu: bool = False):
    """The prologue: x (N, K) or (N, 2K) -> (codes int8 (N, Kp) in natural
    k order, xs (N,) f32, xsum (N,) f32), as the TPU kernel's step 0."""
    K, Kp = qt.kdim, qt.kdim_padded
    xf = x.to(torch.bfloat16).float()
    # written as the kernel computes them (IEEE exp, sqrt and division,
    # the variance summed in its order), so that the two agree bit for bit
    if glu:
        g = xf[:, :K]
        xf = g * (1.0 / (1.0 + torch.exp(-g))) * xf[:, K:]
    if norm is not None:
        w, eps = norm
        var = _block_sum(xf * xf) * (1.0 / K)
        xf = xf * (1.0 / torch.sqrt(var + eps))
        xf = xf * w.float()
    xf = torch.nn.functional.pad(xf, (0, Kp - K))
    amax = xf.abs().amax(1, keepdim=True)
    # the scale as XLA compiles the JAX package's `amax / 127.0`: times the
    # f32 reciprocal of 127.  The codes then take a true division, by a
    # tensor: on CUDA PyTorch turns division by a Python scalar into a
    # reciprocal multiply
    xs = torch.clamp_min(amax, 1e-20) * torch.full_like(amax, 1.0 / 127.0)
    q = torch.clamp(torch.round(xf / xs), -127, 127)
    xsum = q.sum(1, keepdim=True) * xs
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
    """The function K1 computes, in plain PyTorch: (N, M) f32."""
    _check_supported(qt, glu, norm, residual)
    codes, xs, xsum = act_quant_plain(x, qt, norm, glu)
    acc = int_dot_plain(codes, qt)
    out = acc.float() * qt.scales[0].float() * xs[:, None]
    out = out - xsum[:, None] * qt.sub[0].float()
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
        _c_float, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_act_quant.restype = _c_int
    lib.tmac_qgemm.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr]
    lib.tmac_qgemm.restype = _c_int
    return lib


def _require(t: torch.Tensor, what: str, dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"K1: {what} must be a contiguous {dtype} {tuple(shape)} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"K1 {what} launch failed with CUDA error {err}")


def launch_act_quant(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                     glu: bool = False):
    """Launch the prologue: -> (codes (N, Kp) int8 in dp4a grouping,
    xs (N,), xsum (N,))."""
    dev = x.device
    N = x.shape[0]
    K, Kp = qt.kdim, qt.kdim_padded
    _require(x, "x", torch.bfloat16, (N, 2 * K if glu else K), dev)
    norm_ptr, eps = None, 0.0
    if norm is not None:
        w, eps = norm
        _require(w, "norm weight", torch.bfloat16, (K,), dev)
        norm_ptr = w.data_ptr()
    codes = torch.empty((N, Kp), dtype=torch.int8, device=dev)
    xs = torch.empty((N,), dtype=torch.float32, device=dev)
    xsum = torch.empty((N,), dtype=torch.float32, device=dev)
    err = _lib().tmac_act_quant(
        x.data_ptr(), N, x.shape[1], K, Kp, int(glu), norm_ptr, float(eps),
        1.0 / K, qt.bits, codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "prologue")
    return codes, xs, xsum


def launch_gemm(codes: torch.Tensor, xs: torch.Tensor, xsum: torch.Tensor,
                qt: QuantizedTensor, residual=None) -> torch.Tensor:
    """Launch the matmul on prologue outputs: -> (N, Mp) f32."""
    dev = codes.device
    N, Kp, Mp = codes.shape[0], qt.kdim_padded, qt.mdim_padded
    _require(codes, "codes", torch.int8, (N, Kp), dev)
    _require(xs, "xs", torch.float32, (N,), dev)
    _require(xsum, "xsum", torch.float32, (N,), dev)
    rows = Kp // 4 if qt.bits == 2 else Kp
    _require(qt.packed, "packed", torch.uint8, (rows, Mp), dev)
    _require(qt.scales, "scales", torch.float32, (1, Mp), dev)
    _require(qt.sub, "sub", torch.float32, (1, Mp), dev)
    if qt.packed.data_ptr() % 4 or Mp % 32:
        raise ValueError("K1: packed must be 4-byte aligned with Mp % 32 == 0")
    res_ptr = None
    if residual is not None:
        _require(residual, "residual", torch.bfloat16, (N, Mp), dev)
        res_ptr = residual.data_ptr()
    out = torch.empty((N, Mp), dtype=torch.float32, device=dev)
    err = _lib().tmac_qgemm(
        codes.data_ptr(), xs.data_ptr(), xsum.data_ptr(), N, Kp, qt.bits,
        qt.packed.data_ptr(), qt.scales.data_ptr(), qt.sub.data_ptr(), Mp,
        res_ptr, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "matmul")
    return out


def qgemm_fused(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                glu: bool = False, residual=None) -> torch.Tensor:
    """x (N, K) [(N, 2K) with glu] @ Wdq -> (N, M) f32, with the
    activations quantized per row to int8 inside K1.

    norm: (weight (K,), eps) rms_norm before quantization.  glu: x is the
    fused gate_up output and silu(g) * u feeds the matmul.  residual:
    (N, M) added in the epilogue.  CPU tensors take the plain version; CUDA
    tensors take the kernel (x, the norm weight and the residual in bf16)."""
    _check_supported(qt, glu, norm, residual)
    if x.device.type == "cpu":
        return qgemm_fused_plain(x, qt, norm, glu, residual)
    if x.device.type != "cuda":
        raise ValueError(f"K1 runs on CPU or CUDA tensors, not {x.device}")
    codes, xs, xsum = launch_act_quant(x, qt, norm, glu)
    out = launch_gemm(codes, xs, xsum, qt, residual)
    qgemm_fused.launches += 1
    return qt.slice_m(out)


qgemm_fused.launches = 0
