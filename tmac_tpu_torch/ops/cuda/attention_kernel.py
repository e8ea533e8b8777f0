"""Kernels K2, K6, K8 and K9: single-token attention over the stacked KV
cache.

All four replace ``tmac_tpu/ops/pallas/attention_kernel.py::_kernel``, as
one CUDA C++ kernel for Hopper in ``csrc/flash_decode.cu`` (one launch a
call: a cluster of ``nsplit`` blocks per KV head, rows streamed through a
shared-memory ring, the blocks' states merged in distributed shared
memory), which says what bounds them on the card (device-memory bytes of
the valid cache rows) and how the design answers it.  It takes a cache
head_dim Dp of 128, 256, 384 or 512 and any number of query heads per KV
head (rep), the latter in tiles of at most ``rep_max(Dp)`` heads:

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
and a CUDA tensor to the kernel, which either launches or raises; each has
its own ``.launches`` count of kernel launches.  The plain versions repeat
the kernel's f32 operations in its order, with the same split of the rows
(``split_plan``, ``split_spans``), so the two agree bit for bit.
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


LANES = 16   # lanes of a half-warp, over which a row's columns split (kLanes)
GROUPS = 16  # half-warps of a block at Dp 128 (kGroups in csrc/flash_decode.cu)
TILE = 4     # rows of a half-warp's row tile (kTile)
STAGE_ROWS = GROUPS * TILE  # rows of a ring stage at Dp 128 (kStageRows)
MAX_SPLIT = 8               # largest portable cluster
DPS = (128, 256, 384, 512)  # cache head_dims the kernel is built for
RING_MAX = 128 * 1024       # the ring's most bytes (kRingMax)
SPLITS = range(1, 17)       # cluster sizes the kernel takes (9-16 non-portable)
# SMs the plan assumes for CPU tensors (an H100 SXM's), so the plain version
# on the CPU splits the rows as the kernel does on that card
DEFAULT_SMS = 132


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


def ring_groups(Dp: int, itemsize: int) -> int:
    """The half-warps of a block for a cache of Dp columns of itemsize bytes
    (kGroups): the largest of 16, 8 and 4 whose ring (3 stages of int8
    rows and their scales, else 2) fits RING_MAX bytes."""
    stages = 3 if itemsize == 1 else 2
    for g in (16, 8):
        if stages * (2 * g * TILE * Dp * itemsize + (2 * g * TILE * 4 if itemsize == 1 else 0)) \
                <= RING_MAX:
            return g
    return 4


def rep_max(Dp: int) -> int:
    """The query heads a tile holds at most (kRepMax): 8 at Dp 128, 4 at
    256, 2 at 384, 1 at 512."""
    return 8 if Dp <= 128 else 4 if Dp <= 256 else 2 if Dp <= 384 else 1


def rep_tiles(rep: int, Dp: int) -> int:
    """The tiles a kv head's rep query heads take: rep rounded up to 1, 2,
    4 or 8, at most rep_max(Dp), heads a tile (tile_rep)."""
    tr = min(1 << max(rep - 1, 0).bit_length(), 8, rep_max(Dp))
    return cdiv(rep, tr)


def _lane_scores(qf: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """qf (B, KV, rep, Dp) . k (B, KV, R, Dp) -> (B, KV, rep, R) in a row's
    order in the kernel: each of 16 lanes sums its Dp/16 columns from 0,
    then an xor butterfly over the lanes."""
    B, KV, rep, Dp = qf.shape
    prod = (qf[:, :, :, None, :] * k[:, :, None, :, :]).reshape(
        B, KV, rep, -1, LANES, Dp // LANES)
    sc = torch.zeros_like(prod[..., 0])
    for i in range(Dp // LANES):
        sc = sc + prod[..., i]
    while sc.shape[-1] > 1:
        h = sc.shape[-1] // 2
        sc = sc[..., :h] + sc[..., h:]
    return sc[..., 0]


def max_rows(S: int, window: int) -> int:
    """The most cache rows a call can read: the window's, or the cache's."""
    return min(S, window) if window > 0 else S


def split_plan(B: int, KV: int, rows: int, sms: int = DEFAULT_SMS,
               tiles: int = 1) -> int:
    """The blocks (one cluster) the kernel gives each (KV head, rep tile,
    batch row), from static quantities only, so a CUDA graph can capture
    the call: about 1.5 blocks an SM over the B * KV * tiles clusters, at
    most MAX_SPLIT, and no more than give each block half a (Dp 128) ring
    stage of the `rows` a call can read.  (Measured on an H100, PERF.md: at
    2047 rows 32 heads split 6 ways beat 4 by 16% and 8 by 6%.)"""
    n = min(MAX_SPLIT, max(1, round(1.5 * sms / (B * KV * tiles))))
    return max(1, min(n, rows // (STAGE_ROWS // 2)))


def split_spans(lens: torch.Tensor, S: int, window: int, append: bool,
                nsplit: int):
    """The rows each block of a cluster reads, as the kernel divides them
    from the live lengths: lens (B,) -> (start, end), each (B, nsplit)
    int64.  The rows [lo, len) (len = min(lens, S); lo = max(lens - window
    + append, 0) with a window, else 0) in nsplit contiguous spans of
    cdiv(len - lo, nsplit) rows rounded up to TILE, in rank order; the
    spans past len are empty (start == end == len)."""
    raw = lens.long().clamp_min(0)
    length = raw.clamp_max(S)
    lo = (raw - window + int(append)).clamp_min(0) if window > 0 \
        else torch.zeros_like(raw)
    n = (length - lo).clamp_min(0)
    span = round_up(cdiv(n, nsplit), TILE)[:, None]
    rank = torch.arange(nsplit, device=lens.device)
    start = torch.minimum(lo[:, None] + rank * span, length[:, None])
    return start, torch.minimum(start + span, length[:, None])


@functools.cache
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA tensor's card; DEFAULT_SMS for any other device."""
    if device.type != "cuda":
        return DEFAULT_SMS
    return _cuda_sms(device.index if device.index is not None
                     else torch.cuda.current_device())


def _nsplit(nsplit, B, KV, S, window, device, tiles: int = 1) -> int:
    if nsplit is None:
        return split_plan(B, KV, max_rows(S, window), sm_count(device), tiles)
    if nsplit not in SPLITS:
        raise ValueError(f"nsplit must be in 1 .. {SPLITS[-1]}, not {nsplit}")
    return nsplit


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


def _attend_plain(q, k_all, v_all, lens, layer, scale, k_scale, v_scale,
                  window, nsplit, cur_k=None, cur_v=None):
    """The attention of K2/K6 (cur_k None) and K8/K9, in the kernel's
    order: block `rank` of a cluster of nsplit reads the span
    split_spans gives it, in stages of G * TILE rows (G = ring_groups:
    16 half-warps a block at Dp 128); half-warp g takes rows 4g .. 4g+3 of
    each stage (a row tile) and keeps an online softmax over its tiles,
    rescaled once a tile by the tile's maximum; the half-warps merge in
    group order, the blocks in rank order, then the current token comes in
    as a last online step.  Each query head's sums are the same in any
    tiling of the rep heads; the tiles only set the plan's nsplit."""
    B, KV, rep, Dl = q.shape
    S, Dp = k_all.shape[3], k_all.shape[4]
    G, dev = ring_groups(Dp, k_all.element_size()), k_all.device
    append = cur_k is not None
    quant = k_scale is not None
    scale = 1.0 / math.sqrt(Dl) if scale is None else scale
    P = _nsplit(nsplit, B, KV, S, window, dev, rep_tiles(rep, Dp))
    li = torch.as_tensor(layer, device=dev).reshape(1).long()
    start, end = split_spans(lens.to(dev), S, window, append, P)  # (B, P)
    # stages of the longest span a call can give
    T = cdiv(round_up(cdiv(max_rows(S, window), P), TILE), G * TILE)
    within = torch.arange(T * G * TILE, device=dev).reshape(T, G, TILE)
    rows = start[:, :, None, None, None] + within       # (B, P, T, G, TILE)
    ok = (rows < end[:, :, None, None, None])[:, None, None]
    idx = rows.clamp_max(S - 1).reshape(B, -1)
    bi = torch.arange(B, device=dev)[:, None]

    def gather(buf):                                    # (B, KV, R, ...)
        return buf.index_select(0, li)[0][bi, :, idx].transpose(1, 2)

    qf = F.pad(q.float() * scale, (0, Dp - Dl))
    sc = _lane_scores(qf, gather(k_all).float())
    v = gather(v_all).float().reshape(B, KV, 1, P, T, G, TILE, Dp)
    if quant:
        sc = sc * gather(k_scale)[:, :, None, :]
        vsc = gather(v_scale).reshape(B, KV, 1, P, T, G, TILE)
    sc = sc.reshape(B, KV, rep, P, T, G, TILE)
    m = torch.full((B, KV, rep, P, G), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KV, rep, P, G, Dp), device=dev)
    for t in range(T):
        s, okt = sc[:, :, :, :, t], ok[:, :, :, :, t]
        m_new = torch.maximum(m, torch.where(okt, s, float("-inf")).amax(-1))
        corr = torch.exp(m - m_new)
        lt, at = l * corr, acc * corr[..., None]
        for i in range(TILE):
            oki = okt[..., i]
            p = torch.exp(s[..., i] - m_new)
            lt = torch.where(oki, lt + p, lt)
            pv = p * vsc[:, :, :, :, t, :, i] if quant else p
            at = torch.where(oki[..., None], at + pv[..., None]
                             * v[:, :, :, :, t, :, i], at)
        # a tile with no valid row leaves the state as it was
        seen = okt.any(-1)
        m = torch.where(seen, m_new, m)
        l = torch.where(seen, lt, l)
        acc = torch.where(seen[..., None], at, acc)
    m, l, acc = _merge(*_merge(m, l, acc))        # half-warps, then blocks
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


def flash_decode_plain(q: torch.Tensor, k_all: torch.Tensor,
                       v_all: torch.Tensor, kv_lens: torch.Tensor, layer,
                       scale: float | None = None, k_scale=None, v_scale=None,
                       window: int = 0, nsplit: int | None = None) -> torch.Tensor:
    """The function K2 computes (with k_scale/v_scale or a window, K6's),
    in plain PyTorch, in the kernel's order.

    q (B, KV, rep, Dl); k_all/v_all (L, B, KV, S, Dp); kv_lens (B,) valid
    rows (the current token already written); layer: int or (1,) int
    tensor; nsplit: the blocks a head is split over (None: split_plan's
    choice for the tensors' device).  -> (B, KV, rep, Dl) in q's dtype; a
    row with no valid entry gives zeros.

    f32 throughout, each step rounded on its own as the kernel rounds it
    (_attend_plain), so kernel and plain version agree bit for bit, and a
    model run through either gives the same tokens."""
    return _attend_plain(q, k_all, v_all, kv_lens, layer, scale, k_scale,
                         v_scale, window, nsplit)


def flash_decode_split_plain(q, k_all, v_all, kv_lens, layer, scale=None,
                             k_scale=None, v_scale=None, window: int = 0,
                             nsplit: int | None = None) -> torch.Tensor:
    """The function K6 computes, in its order: flash_decode_plain's over
    the rows [max(kv_lens - window, 0), kv_lens) (all rows below kv_lens
    when window is 0); on an int8 cache (k_scale/v_scale (L, B, KV, S)
    f32) each row's score times its k scale, its probability times its v
    scale before the PV product."""
    return _attend_plain(q, k_all, v_all, kv_lens, layer, scale, k_scale,
                         v_scale, window, nsplit)


def flash_decode_append_plain(q, k_all, v_all, cached_lens, layer, cur_k,
                              cur_v, scale=None, k_scale=None, v_scale=None,
                              window: int = 0,
                              nsplit: int | None = None) -> torch.Tensor:
    """The function K8 computes, in its order: K6's over the cached rows
    [max(cached_lens - window + 1, 0), cached_lens), then the current
    token's cur_k/cur_v (B, KV, Dl), exact floats, as a last online step.
    A fresh sequence (cached_lens 0) reads no row."""
    return _attend_plain(q, k_all, v_all, cached_lens, layer, scale, k_scale,
                         v_scale, window, nsplit, cur_k, cur_v)


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
                                    v_scale=None, window: int = 0,
                                    nsplit: int | None = None) -> torch.Tensor:
    """The function K9 computes: K8's output, and cur_k/cur_v stored at row
    cached_lens[b] of the cache (k_all, v_all and, on an int8 cache,
    k_scale, v_scale), in place, after the attention has read it."""
    out = _attend_plain(q, k_all, v_all, cached_lens, layer, scale, k_scale,
                        v_scale, window, nsplit, cur_k, cur_v)
    _store_row_plain(k_all, k_scale, cur_k, cached_lens, layer)
    _store_row_plain(v_all, v_scale, cur_v, cached_lens, layer)
    return out


@functools.cache
def _lib():
    from tmac_tpu_torch.ops.cuda import build
    lib = build.load("flash_decode")
    lib.tmac_decode_attention.argtypes = (
        [_c_ptr] * 11 + [_c_int] * 11 + [_c_float, _c_int, _c_int, _c_ptr])
    lib.tmac_decode_attention.restype = _c_int
    return lib


def _check_int32(lens, layer, B, device, name):
    for what, t, shape in (("lengths", lens, (B,)), ("layer", layer, (1,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous int32 "
                             f"{shape} on {device}")


def check_form(name: str, Dl: int, Dp: int) -> None:
    """Raise for a head shape the kernel does not take: Dl > Dp or a Dp
    that is not a multiple of 128 (the reference's asserts), or a Dp above
    512 (no instance is built for it)."""
    if Dl > Dp or Dp % 128:
        raise ValueError(f"{name} takes Dl <= Dp and Dp a multiple of 128; got "
                         f"Dp={Dp} Dl={Dl}")
    if Dp not in DPS:
        raise ValueError(f"{name} is built for a cache head_dim Dp of {DPS}, not {Dp}")


# every K9 counter buffer made on a device, the newest last.  None is ever
# freed: a CUDA graph captured over a launch keeps its buffer's address and
# replays on it after a larger launch has made a newer one
_done: dict = {}


def _done_counts(device, n: int) -> torch.Tensor:
    """The card's K9 counters (one int32 a (batch row, kv head), zero
    between launches: the last rep tile's cluster sets its back), at least
    n of them: the newest buffer, or a larger new one beside the old.  One
    stream at a time: two K9 launches running at once on one device (two
    streams, or a graph replayed beside an eager call) would share the
    counters."""
    bufs = _done.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 256), dtype=torch.int32, device=device))
    return bufs[-1]


def _launch(name, q, k_all, v_all, lens, layer, scale, k_scale, v_scale,
            window, nsplit, cur_k=None, cur_v=None,
            write=False) -> torch.Tensor:
    """Check the arguments of K2, K6, K8 or K9 (`name`) and launch the
    kernel."""
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
    check_form(name, Dl, Dp)
    if window < 0:
        raise ValueError(f"{name}: window {window}")
    if any(t.data_ptr() % 16 for t in (k_all, v_all)):
        raise ValueError(f"{name}: the cache must be 16-byte aligned")
    tiles = rep_tiles(rep, Dp)
    nsplit = _nsplit(nsplit, B, KV, S, window, q.device, tiles)
    scale = 1.0 / math.sqrt(Dl) if scale is None else scale
    out = torch.empty_like(q)
    done = _done_counts(q.device, B * KV) if write and tiles > 1 else None

    def ptr(t):
        return t.data_ptr() if t is not None else None
    err = _lib().tmac_decode_attention(
        q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(), ptr(k_scale),
        ptr(v_scale), lens.data_ptr(), layer.data_ptr(), ptr(cur_k),
        ptr(cur_v), out.data_ptr(), ptr(done), L, B, KV, rep, Dl, Dp, S, int(window),
        int(cur_k is not None), int(write), nsplit, float(scale),
        int(q.dtype == torch.bfloat16), int(quant),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} "
                           f"(nsplit {nsplit})")
    return out


def flash_decode(q: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                 kv_lens: torch.Tensor, layer: torch.Tensor,
                 scale: float | None = None, k_scale=None, v_scale=None,
                 window: int = 0, nsplit: int | None = None) -> torch.Tensor:
    """Attention of one query token per (batch row, head) over layer
    `layer` of the stacked cache; shapes as in flash_decode_plain.  With
    k_scale/v_scale (an int8 cache) or a window, this is K6
    (flash_decode_split); otherwise K2.

    On CUDA: q, k_all, v_all all bf16 or all f32 and contiguous, Dp one
    of DPS, kv_lens (B,) and layer (1,) int32 on the same device (read by
    the kernel; the host never waits for them); nsplit one of SPLITS or
    None (split_plan's)."""
    if k_scale is not None or window:
        return flash_decode_split(q, k_all, v_all, kv_lens, layer, scale,
                                  k_scale, v_scale, window, nsplit)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_all, v_all, kv_lens, layer, scale,
                                  nsplit=nsplit)
    out = _launch("K2", q, k_all, v_all, kv_lens, layer, scale, None, None,
                  0, nsplit)
    flash_decode.launches += 1
    return out


def flash_decode_split(q, k_all, v_all, kv_lens, layer, scale=None,
                       k_scale=None, v_scale=None, window: int = 0,
                       nsplit: int | None = None) -> torch.Tensor:
    """K6: flash_decode_split_plain's function.  On CUDA: q bf16 or f32;
    the cache of q's type, or int8 with k_scale/v_scale (L, B, KV, S) f32;
    otherwise as flash_decode."""
    if q.device.type == "cpu":
        return flash_decode_split_plain(q, k_all, v_all, kv_lens, layer,
                                        scale, k_scale, v_scale, window,
                                        nsplit)
    out = _launch("K6", q, k_all, v_all, kv_lens, layer, scale, k_scale,
                  v_scale, window, nsplit)
    flash_decode_split.launches += 1
    return out


def flash_decode_append(q, k_all, v_all, cached_lens, layer, cur_k, cur_v,
                        scale=None, k_scale=None, v_scale=None,
                        window: int = 0,
                        nsplit: int | None = None) -> torch.Tensor:
    """K8: flash_decode_append_plain's function; cur_k/cur_v (B, KV, Dl) of
    q's type, the rest as flash_decode_split."""
    if q.device.type == "cpu":
        return flash_decode_append_plain(q, k_all, v_all, cached_lens, layer,
                                         cur_k, cur_v, scale, k_scale,
                                         v_scale, window, nsplit)
    out = _launch("K8", q, k_all, v_all, cached_lens, layer, scale, k_scale,
                  v_scale, window, nsplit, cur_k, cur_v)
    flash_decode_append.launches += 1
    return out


def flash_decode_append_write(q, k_all, v_all, cached_lens, layer, cur_k,
                              cur_v, scale=None, k_scale=None, v_scale=None,
                              window: int = 0,
                              nsplit: int | None = None) -> torch.Tensor:
    """K9: flash_decode_append_write_plain's function (the cache updated in
    place); arguments as flash_decode_append."""
    if q.device.type == "cpu":
        return flash_decode_append_write_plain(
            q, k_all, v_all, cached_lens, layer, cur_k, cur_v, scale,
            k_scale, v_scale, window, nsplit)
    out = _launch("K9", q, k_all, v_all, cached_lens, layer, scale, k_scale,
                  v_scale, window, nsplit, cur_k, cur_v, write=True)
    flash_decode_append_write.launches += 1
    return out


flash_decode.launches = 0
flash_decode_split.launches = 0
flash_decode_append.launches = 0
flash_decode_append_write.launches = 0
