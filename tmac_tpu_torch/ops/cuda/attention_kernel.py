"""Kernel K2: single-token attention over the stacked KV cache.

Replaces ``tmac_tpu/ops/pallas/attention_kernel.py::_kernel`` as reached
through ``flash_decode_stacked`` (append, quant, window and write off), as
CUDA C++ for Hopper in ``csrc/flash_decode.cu``.  That source says what
bounds the kernel on the card (device-memory bytes of the valid cache rows)
and how its design answers it.

``flash_decode`` is the wrapper: a CPU tensor goes to the plain PyTorch
version ``flash_decode_plain``, a CUDA tensor to the kernel, which either
launches or raises.  ``flash_decode.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


GROUPS = 16  # half-warps of a K2 block (kGroups in csrc/flash_decode.cu)


def flash_decode_plain(q: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, kv_lens: torch.Tensor, layer,
                       scale: float | None = None) -> torch.Tensor:
    """The function K2 computes, in plain PyTorch, in the kernel's order.

    q (B, KV, rep, Dl); k_all/v_all (L, B, KV, S, Dp); kv_lens (B,) valid
    rows (the current token already written); layer: int or (1,) int
    tensor.  -> (B, KV, rep, Dl) in q's dtype; a row with no valid entry
    gives zeros.

    f32 throughout, each step rounded on its own as the kernel rounds it:
    scores summed 8 dims at a time per lane then over 16 lanes by an xor
    butterfly; 16 position groups (rows g, g+16, ...) each keep an online
    softmax; the groups merge in group order.  So kernel and plain version
    agree bit for bit, and a model run through either gives the same
    tokens."""
    B, KV, rep, Dl = q.shape
    S, Dp = k_all.shape[3], k_all.shape[4]
    G = GROUPS
    scale = 1.0 / math.sqrt(Dl) if scale is None else scale
    li = torch.as_tensor(layer, device=k_all.device).reshape(1).long()
    pad = (0, 0, 0, -S % G)                           # rows past S: never valid
    k = F.pad(k_all.index_select(0, li)[0].float(), pad)   # (B, KV, S', Dp)
    v = F.pad(v_all.index_select(0, li)[0].float(), pad)
    qf = F.pad(q.float() * scale, (0, Dp - Dl))
    prod = (qf[:, :, :, None, :] * k[:, :, None, :, :]).reshape(
        B, KV, rep, -1, G, Dp // G)
    sc = prod[..., 0]
    for i in range(1, Dp // G):                       # 8 dims per lane
        sc = sc + prod[..., i]
    while sc.shape[-1] > 1:                           # butterfly, 16 lanes
        h = sc.shape[-1] // 2
        sc = sc[..., :h] + sc[..., h:]
    sc = sc[..., 0].reshape(B, KV, rep, -1, G)        # (.., S/G, G)
    vg = v.reshape(B, KV, 1, -1, G, Dp)
    lens = kv_lens.to(k.device).long()[:, None, None, None]
    m = torch.full((B, KV, rep, G), float("-inf"), device=k.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, rep, G, Dp), device=k.device)
    g_idx = torch.arange(G, device=k.device)
    for j in range(k.shape[2] // G):                  # rows j*G + g
        s = sc[..., j, :]
        valid = (j * G + g_idx) < lens
        m_new = torch.maximum(m, s)
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = torch.where(valid, l * corr + p, l)
        acc = torch.where(valid[..., None], acc * corr[..., None]
                          + p[..., None] * vg[:, :, :, j], acc)
        m = torch.where(valid, m_new, m)
    mx = m.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    cg = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
    lg = torch.where(live, l * torch.exp(m - mx), torch.zeros_like(m))
    a, lt = torch.zeros_like(acc[..., 0, :]), torch.zeros_like(m[..., 0])
    for g in range(G):                                # group order
        a = a + acc[..., g, :] * cg[..., g, None]
        lt = lt + lg[..., g]
    o = a / torch.clamp_min(lt, 1e-30)[..., None]
    return o[..., :Dl].to(q.dtype)


@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("flash_decode")
    lib.tmac_flash_decode.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_ptr]
    lib.tmac_flash_decode.restype = _c_int
    return lib


def flash_decode(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 kv_lens: torch.Tensor, layer: torch.Tensor,
                 scale: float | None = None) -> torch.Tensor:
    """Attention of one query token per (batch row, head) over layer
    `layer` of the stacked cache; shapes as in flash_decode_plain.

    On CUDA: q, k_all, v_all all bf16 or all f32 and contiguous, Dp == 128,
    rep <= 8, kv_lens (B,) and layer (1,) int32 on the same device (read by
    the kernel; the host never waits for them)."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_all, v_all, kv_lens, layer, scale)
    if q.device.type != "cuda":
        raise ValueError(f"K2 runs on CPU or CUDA tensors, not {q.device}")
    B, KV, rep, Dl = q.shape
    L, _, _, S, Dp = k_all.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 takes bf16 or f32, not {q.dtype}")
    for name, t, shape in (("k_all", k_all, (L, B, KV, S, Dp)),
                           ("v_all", v_all, (L, B, KV, S, Dp))):
        if t.dtype != q.dtype or tuple(t.shape) != shape \
                or t.device != q.device:
            raise ValueError(f"K2: {name} must be {q.dtype} {shape} on {q.device}")
    for name, t, shape in (("kv_lens", kv_lens, (B,)), ("layer", layer, (1,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != q.device:
            raise ValueError(f"K2: {name} must be int32 {shape} on {q.device}")
    if not all(t.is_contiguous() for t in (q, k_all, v_all, kv_lens)):
        raise ValueError("K2: q, k_all, v_all and kv_lens must be contiguous")
    if Dp != 128 or not 1 <= rep <= 8 or Dl > Dp:
        raise ValueError(f"K2 takes Dp == 128, rep <= 8, Dl <= Dp; got "
                         f"Dp={Dp} rep={rep} Dl={Dl}")
    if any(t.data_ptr() % 16 for t in (k_all, v_all)):
        raise ValueError("K2: the cache must be 16-byte aligned")
    scale = 1.0 / math.sqrt(Dl) if scale is None else scale
    out = torch.empty_like(q)
    err = _lib().tmac_flash_decode(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), kv_lens.data_ptr(),
        layer.data_ptr(), out.data_ptr(), L, B, KV, rep, Dl, Dp, S,
        float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed with CUDA error {err}")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
