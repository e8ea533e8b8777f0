"""Kernels K2, K6, K8 and K9: single-token attention over the stacked KV
cache.

All four replace ``tmac_tpu/ops/pallas/attention_kernel.py::_kernel``, as
CUDA C++ for Hopper in ``csrc/flash_decode.cu``, which says what bounds them
on the card (device-memory bytes of the valid cache rows) and how their
designs answer it:

- K2, ``flash_decode``: a bf16 or f32 cache, no window (``_kernel`` with
  every flag off, through ``flash_decode_stacked``);
- K6, ``flash_decode_split``: an int8 cache (``k_scale``/``v_scale``) and/or
  a sliding window (``flash_decode_stacked`` with those arguments);
  ``flash_decode`` sends such calls there;
- K8, ``flash_decode_append``: the current token's k/v as operands, folded
  in after the cached rows (``flash_decode_stacked_append``);
- K9, ``flash_decode_append_write``: K8, and the current row stored into
  the cache at ``cached_lens[b]``, in place
  (``flash_decode_stacked_append_write``, whose output cache aliases its
  input).

Each wrapper sends a CPU tensor to its plain PyTorch version (``*_plain``)
and a CUDA tensor to its kernel, which either launches or raises; each has
its own ``.launches`` count of kernel launches.  The plain versions repeat
their kernel's f32 operations in its order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from tmac_tpu_torch.ops.cuda.qgemm_kernel import act_scale
from tmac_tpu_torch.utils import cdiv, round_up

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


GROUPS = 16  # half-warps of a block (kGroups in csrc/flash_decode.cu)
# cache rows a block of K6, K8 and K9 reads (read at each call, so a test
# can make it smaller)
CHUNK = 256


def quantize_kv(kv: torch.Tensor):
    """kv (..., D) float -> (int8 codes (..., D), scales (...,) f32): one
    absmax/127 scale per vector (the int8 cache's convention), as the JAX
    package's ``_quantize_kv`` compiles: the scale times the f32 reciprocal
    of 127, the codes a true division, rint and a clamp to +-127."""
    f = kv.float()
    sc = act_scale(f.abs().amax(-1))
    # a true division, by a tensor (a Python-scalar divisor becomes a
    # reciprocal multiply on CUDA)
    codes = torch.clamp(torch.round(f / sc[..., None]), -127, 127)
    return codes.to(torch.int8), sc


def _lane_scores(qf: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qf (B, KV, rep, Dp) . k (B, KV, R, Dp) -> (B, KV, rep, R) in a row's
    order in the kernels: each of 16 lanes sums its Dp/16 columns from 0,
    then an xor butterfly over the lanes."""
    B, KV, rep, Dp = qf.shape
    prod = (qf[:, :, :, None, :] * k[:, :, None, :, :]).reshape(
        B, KV, rep, -1, GROUPS, Dp // GROUPS)
    sc = torch.zeros_like(prod[..., 0])
    for i in range(Dp // GROUPS):
        sc = sc + prod[..., i]
    while sc.shape[-1] > 1:
        h = sc.shape[-1] // 2
        sc = sc[..., :h] + sc[..., h:]
    return sc[..., 0]


def flash_decode_plain(q: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, kv_lens: torch.Tensor, layer,
                       scale: float | None = None, k_scale=None, v_scale=None,
                       window: int = 0) -> torch.Tensor:
    """The function K2 computes, in plain PyTorch, in the kernel's order
    (with k_scale/v_scale or a window: K6's, flash_decode_split_plain).

    q (B, KV, rep, Dl); k_all/v_all (L, B, KV, S, Dp); kv_lens (B,) valid
    rows (the current token already written); layer: int or (1,) int
    tensor.  -> (B, KV, rep, Dl) in q's dtype; a row with no valid entry
    gives zeros.

    f32 throughout, each step rounded on its own as the kernel rounds it:
    scores summed 8 dims at a time per lane then over 16 lanes by an xor
    butterfly; 16 position groups (rows g, g+16, ...) each keep an online
    softmax; the groups merge in group order.  That is K6's order with one
    chunk holding every row.  So kernel and plain version agree bit for
    bit, and a model run through either gives the same tokens."""
    if k_scale is not None or window:
        return flash_decode_split_plain(q, k_all, v_all, kv_lens, layer,
                                        scale, k_scale, v_scale, window)
    return _split_plain(q, k_all, v_all, kv_lens, layer, scale, None, None,
                        0, round_up(k_all.shape[3], GROUPS))


def n_chunks(S: int, window: int, chunk: int) -> int:
    """Blocks a head of K6, K8 and K9 takes: enough chunks of `chunk` rows
    for the rows a window (or, without one, the cache) can hold."""
    return cdiv(min(S, window) if window > 0 else S, chunk)


def _merge(m, l, acc):
    """Partial online-softmax states (..., n), (..., n), (..., n, Dp)
    merged in order into one (..., ), (..., ), (..., Dp); a state that saw no
    row (m = -inf) counts 0."""
    mx = m.amax(-1, keepdim=True)
    e = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - mx))
    a, lt = torch.zeros_like(acc[..., 0, :]), torch.zeros_like(m[..., 0])
    for i in range(m.shape[-1]):
        a = a + acc[..., i, :] * e[..., i, None]
        lt = lt + l[..., i] * e[..., i]
    return mx[..., 0], lt, a


def _split_plain(q, k_all, v_all, lens, layer, scale, k_scale, v_scale,
                 window, chunk, cur_k=None, cur_v=None):
    """The attention of K6 (cur_k None) and K8/K9, in their kernels' order:
    chunk c holds rows lo + c*chunk + 16j + g (lo the window's lower edge),
    group g of it keeps an online softmax over its rows, the groups merge
    in group order, the chunks in chunk order, then the current token
    comes in as a last online step."""
    B, KV, rep, Dl = q.shape
    S, Dp = k_all.shape[3], k_all.shape[4]
    G, dev = GROUPS, k_all.device
    append = cur_k is not None
    quant = k_scale is not None
    scale = 1.0 / math.sqrt(Dl) if scale is None else scale
    li = torch.as_tensor(layer, device=dev).reshape(1).long()
    # the window's edge from the length as given, the rows read below S:
    # past S (a slot held at pos == S) the reference masks the same rows
    raw = lens.to(dev).long().clamp_min(0)
    lens = raw.clamp_max(S)
    lo = (raw - window + int(append)).clamp_min(0) if window > 0 \
        else torch.zeros_like(lens)
    nchunk, J = n_chunks(S, window, chunk), cdiv(chunk, G)
    within = (torch.arange(J, device=dev)[:, None] * G
              + torch.arange(G, device=dev))                  # (J, G)
    rows = (lo[:, None, None, None] + within
            + torch.arange(nchunk, device=dev)[:, None, None] * chunk)
    valid = (within < chunk) & (rows < lens[:, None, None, None])
    idx = rows.clamp_max(S - 1).reshape(B, -1)
    bi = torch.arange(B, device=dev)[:, None]

    def gather(buf):                                          # (B, KV, R, ...)
        return buf.index_select(0, li)[0][bi, :, idx].transpose(1, 2)

    qf = F.pad(q.float() * scale, (0, Dp - Dl))
    sc = _lane_scores(qf, gather(k_all).float())
    v = gather(v_all).float().reshape(B, KV, 1, nchunk, J, G, Dp)
    if quant:
        sc = sc * gather(k_scale)[:, :, None, :]
        vsc = gather(v_scale).reshape(B, KV, 1, nchunk, J, G)
    sc = sc.reshape(B, KV, rep, nchunk, J, G)
    ok = valid[:, None, None]
    m = torch.full((B, KV, rep, nchunk, G), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, rep, nchunk, G, Dp), device=dev)
    for j in range(J):
        s, okj = sc[..., j, :], ok[..., j, :]
        m_new = torch.maximum(m, s)
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = torch.where(okj, l * corr + p, l)
        pv = p * vsc[..., j, :] if quant else p
        acc = torch.where(okj[..., None], acc * corr[..., None]
                          + pv[..., None] * v[..., j, :, :], acc)
        m = torch.where(okj, m_new, m)
    m, l, acc = _merge(*_merge(m, l, acc))        # groups, then chunks
    if append:
        ck = F.pad(cur_k.float(), (0, Dp - Dl))
        cv = F.pad(cur_v.float(), (0, Dp - Dl))
        s_c = _lane_scores(qf, ck[:, :, None, :])[..., 0]     # (B, KV, rep)
        m_new = torch.maximum(m, s_c)
        p, corr = torch.exp(s_c - m_new), torch.exp(m - m_new)
        l = l * corr + p
        acc = acc * corr[..., None] + p[..., None] * cv[:, :, None, :]
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o[..., :Dl].to(q.dtype)


def flash_decode_split_plain(q, k_all, v_all, kv_lens, layer, scale=None,
                             k_scale=None, v_scale=None,
                             window: int = 0) -> torch.Tensor:
    """The function K6 computes, in its order: flash_decode_plain's over
    the rows [max(kv_lens - window, 0), kv_lens) (all rows below kv_lens
    when window is 0); on an int8 cache (k_scale/v_scale (L, B, KV, S)
    f32) each row's score times its k scale, its probability times its v
    scale before the PV product."""
    return _split_plain(q, k_all, v_all, kv_lens, layer, scale, k_scale,
                        v_scale, window, CHUNK)


def flash_decode_append_plain(q, k_all, v_all, cached_lens, layer, cur_k,
                              cur_v, scale=None, k_scale=None, v_scale=None,
                              window: int = 0) -> torch.Tensor:
    """The function K8 computes, in its order: K6's over the cached rows
    [max(cached_lens - window + 1, 0), cached_lens), then the current
    token's cur_k/cur_v (B, KV, Dl), exact floats, as a last online step.
    A fresh sequence (cached_lens 0) reads no row."""
    return _split_plain(q, k_all, v_all, cached_lens, layer, scale, k_scale,
                        v_scale, window, CHUNK, cur_k, cur_v)


def _store_row_plain(buf, sbuf, cur, lens, layer):
    """Store cur (B, KV, Dl) at row lens[b] of layer `layer` of buf, in
    place, zero-padded to Dp (quantized, with its scale into sbuf, on an
    int8 cache).  The row is clamped to [0, S - 1], where the reference's
    store lands in interpret mode (a slot at cached_lens == S rewrites
    row S - 1)."""
    B, KV, Dl = cur.shape
    S, Dp = buf.shape[3], buf.shape[4]
    li = torch.as_tensor(layer, device=buf.device).reshape(1).long()
    bi = torch.arange(B, device=buf.device)
    row = lens.to(buf.device).long().clamp(0, S - 1)
    if sbuf is not None:
        codes, sc = quantize_kv(cur)
        new = F.pad(codes, (0, Dp - Dl))
        sbuf[li, bi, :, row] = sc
    else:
        new = F.pad(cur.float(), (0, Dp - Dl)).to(buf.dtype)
    buf[li, bi, :, row] = new


def flash_decode_append_write_plain(q, k_all, v_all, cached_lens, layer,
                                    cur_k, cur_v, scale=None, k_scale=None,
                                    v_scale=None,
                                    window: int = 0) -> torch.Tensor:
    """The function K9 computes: K8's output, and cur_k/cur_v stored at row
    cached_lens[b] of the cache (k_all, v_all and, on an int8 cache,
    k_scale, v_scale), in place, after the attention has read it."""
    out = _split_plain(q, k_all, v_all, cached_lens, layer, scale, k_scale,
                       v_scale, window, CHUNK, cur_k, cur_v)
    _store_row_plain(k_all, k_scale, cur_k, cached_lens, layer)
    _store_row_plain(v_all, v_scale, cur_v, cached_lens, layer)
    return out


@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("flash_decode")
    lib.tmac_flash_decode.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_int, _c_int, _c_float, _c_int, _c_ptr]
    lib.tmac_flash_decode.restype = _c_int
    lib.tmac_flash_decode_split.argtypes = (
        [_c_ptr] * 13 + [_c_int] * 12 + [_c_float, _c_int, _c_int, _c_ptr])
    lib.tmac_flash_decode_split.restype = _c_int
    return lib


def flash_decode(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 kv_lens: torch.Tensor, layer: torch.Tensor,
                 scale: float | None = None, k_scale=None, v_scale=None,
                 window: int = 0) -> torch.Tensor:
    """Attention of one query token per (batch row, head) over layer
    `layer` of the stacked cache; shapes as in flash_decode_plain.  With
    k_scale/v_scale (an int8 cache) or a window, this is K6
    (flash_decode_split); otherwise K2.

    On CUDA: q, k_all, v_all all bf16 or all f32 and contiguous, Dp == 128,
    rep <= 8, kv_lens (B,) and layer (1,) int32 on the same device (read by
    the kernel; the host never waits for them)."""
    if k_scale is not None or window:
        return flash_decode_split(q, k_all, v_all, kv_lens, layer, scale,
                                  k_scale, v_scale, window)
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
    _check_int32(kv_lens, layer, B, q.device, "K2")
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


def _check_int32(lens, layer, B, device, name):
    for what, t, shape in (("lengths", lens, (B,)), ("layer", layer, (1,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous int32 "
                             f"{shape} on {device}")


def _launch_split(name, q, k_all, v_all, lens, layer, scale, k_scale,
                  v_scale, window, cur_k=None, cur_v=None,
                  write=False) -> torch.Tensor:
    """Check the arguments of K6, K8 or K9 (`name`) and launch it."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {q.device}")
    B, KV, rep, Dl = q.shape
    L, _, _, S, Dp = k_all.shape
    quant = k_scale is not None
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes a bf16 or f32 q, not {q.dtype}")
    cdt = torch.int8 if quant else q.dtype
    tensors = [("k_all", k_all, cdt, (L, B, KV, S, Dp)),
               ("v_all", v_all, cdt, (L, B, KV, S, Dp))]
    if quant or v_scale is not None:
        tensors += [("k_scale", k_scale, torch.float32, (L, B, KV, S)),
                    ("v_scale", v_scale, torch.float32, (L, B, KV, S))]
    if cur_k is not None or cur_v is not None:
        tensors += [("cur_k", cur_k, q.dtype, (B, KV, Dl)),
                    ("cur_v", cur_v, q.dtype, (B, KV, Dl))]
    for what, t, dt, shape in tensors:
        if t is None or t.dtype != dt or tuple(t.shape) != shape \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous {dt} "
                             f"{shape} on {q.device}")
    _check_int32(lens, layer, B, q.device, name)
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if Dp != 128 or not 1 <= rep <= 8 or Dl > Dp:
        raise ValueError(f"{name} takes Dp == 128, rep <= 8, Dl <= Dp; got "
                         f"Dp={Dp} rep={rep} Dl={Dl}")
    if window < 0:
        raise ValueError(f"{name}: window {window}")
    if any(t.data_ptr() % 16 for t in (k_all, v_all)):
        raise ValueError(f"{name}: the cache must be 16-byte aligned")
    scale = 1.0 / math.sqrt(Dl) if scale is None else scale
    nchunk = n_chunks(S, window, CHUNK)
    part_ml = torch.empty((2, B, KV, rep, nchunk), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, KV, rep, nchunk, Dp), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(q)

    def ptr(t):
        return t.data_ptr() if t is not None else None
    err = _lib().tmac_flash_decode_split(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), ptr(k_scale),
        ptr(v_scale), lens.data_ptr(), layer.data_ptr(), ptr(cur_k),
        ptr(cur_v), out.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), part_acc.data_ptr(), L, B, KV, rep, Dl, Dp, S,
        int(window), int(cur_k is not None), int(write), CHUNK, nchunk,
        float(scale), int(q.dtype == torch.bfloat16), int(quant),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return out


def flash_decode_split(q, k_all, v_all, kv_lens, layer, scale=None,
                       k_scale=None, v_scale=None,
                       window: int = 0) -> torch.Tensor:
    """K6: flash_decode_split_plain's function.  On CUDA: q bf16 or f32;
    the cache of q's type, or int8 with k_scale/v_scale (L, B, KV, S) f32;
    otherwise as flash_decode."""
    if q.device.type == "cpu":
        return flash_decode_split_plain(q, k_all, v_all, kv_lens, layer,
                                        scale, k_scale, v_scale, window)
    out = _launch_split("K6", q, k_all, v_all, kv_lens, layer, scale,
                        k_scale, v_scale, window)
    flash_decode_split.launches += 1
    return out


def flash_decode_append(q, k_all, v_all, cached_lens, layer, cur_k, cur_v,
                        scale=None, k_scale=None, v_scale=None,
                        window: int = 0) -> torch.Tensor:
    """K8: flash_decode_append_plain's function; cur_k/cur_v (B, KV, Dl) of
    q's type, the rest as flash_decode_split."""
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k_all, v_all, cached_lens, layer,
                                         cur_k, cur_v, scale, k_scale,
                                         v_scale, window)
    out = _launch_split("K8", q, k_all, v_all, cached_lens, layer, scale,
                        k_scale, v_scale, window, cur_k, cur_v)
    flash_decode_append.launches += 1
    return out


def flash_decode_append_write(q, k_all, v_all, cached_lens, layer, cur_k,
                              cur_v, scale=None, k_scale=None, v_scale=None,
                              window: int = 0) -> torch.Tensor:
    """K9: flash_decode_append_write_plain's function (the cache updated in
    place); arguments as flash_decode_append."""
    if q.device.type == "cpu":
        return flash_decode_append_write_plain(
            q, k_all, v_all, cached_lens, layer, cur_k, cur_v, scale,
            k_scale, v_scale, window)
    out = _launch_split("K9", q, k_all, v_all, cached_lens, layer, scale,
                        k_scale, v_scale, window, cur_k, cur_v, write=True)
    flash_decode_append_write.launches += 1
    return out


flash_decode.launches = 0
flash_decode_split.launches = 0
flash_decode_append.launches = 0
flash_decode_append_write.launches = 0
