"""Llama-family transformer in PyTorch.

The port of ``tmac_tpu/models/llama.py``: RoPE with any of the JAX
package's long-context scalings (linear, per-dim factors, llama3, YaRN),
an optional sliding window (Phi-3-mini), optional q/k/v biases (Qwen2),
an int8, bf16 or tied head, and a bf16 or int8 KV cache; w_a8 (BitNet
W1.58A8, per-tensor scales; its weights are bits-2 ternary ones at any
configured bits, as the JAX package builds them) and w_fp at bits 1 to 4,
with grouped scales (e.g. Llama-2-7B W2A16 / W4A16 g128, Llama-3.1-8B
W3A16, Qwen2-7B W4A16), optionally with activation groups finer than the
weight groups (``act_group_size``, K4's and K4L's ags form), or per
channel (``group_size=-1``: one f32 scale and zero point a column, the
activations int8 per token, e.g. Llama-3.1-8B W4A8, through K1 and K3),
dense or MoE
(Mixtral-8x7B: the MLP is models/moe.py's moe_mlp, whose decode form runs
kernel K7, grouped or, at w_a8, per-tensor).  ``_check_slice`` names
what is not ported yet.
Every quantized linear goes through the kernel that the JAX package's
pallas path runs for its weights and rows (ops.qgemm.route): for
per-tensor scales K1 (ops/cuda/qgemm_kernel.py) below 64 rows and K3 from
64, for grouped ones K4 (ops/cuda/qgemm_grouped_kernel.py) and, from
3 * group_size rows (a prefill chunk of 384 or more at g128), K5, with
rms_norm folded into wqkv and gate_up, the residual into wo and down, and
SwiGLU into down where down's K is unpadded (elsewhere silu(g) * u runs in
bf16 torch ops before down, as in JAX).  With TMAC_BLOCK_KERNEL=1 a
BitNet decode step runs each layer's wo + residual -> rms_norm -> gate_up
-> SwiGLU -> down + residual in one program, K10
(ops/cuda/block_kernel.py), as JAX does then.  Decode attention goes
through ops/cuda/attention_kernel.py:
K2 on a bf16 cache without a window, K6 on an int8 cache or with a window,
or, in the deferred and in-kernel KV-write modes (``Llama``), K8 and K9;
prefill attention is a masked softmax in f32 torch ops, as the JAX package
leaves it to XLA.  The int8 lm head is K1 (K3 from 64 rows) with bits=8
and no folds, after a separate bf16 rms_norm.

Parameters are a plain dict tree (``init_params``, or
``convert.from_jax.params_from_numpy``) that ``Llama`` holds as buffers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.models.moe import moe_mlp, stack_experts
from tmac_tpu_torch.ops.cuda.attention_kernel import (
    flash_decode, flash_decode_append, flash_decode_append_plain,
    flash_decode_append_write, flash_decode_append_write_plain,
    flash_decode_plain, quantize_kv)
from tmac_tpu_torch.ops.cuda.block_kernel import (wo_mlp_block,
                                                  wo_mlp_block_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m, kernel_for, qgemm_torch
from tmac_tpu_torch.utils import round_up


def quantize_activations_int8(x: torch.Tensor):
    """Per-token absmax int8 quantization (1e-20 clamp, rint, +-127), as
    the JAX package's function computes it when compiled: XLA turns its
    `amax / 127.0` into a multiply by the f32 reciprocal.  The int8 KV
    cache's convention too (quantize_kv), with the scale kept as (..., 1)."""
    q, scale = quantize_kv(x)
    return q, scale[..., None]


def apply_qlinear(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None, plain: bool = False,
                  act_gs: int = 0, mode: Optional[str] = None):
    """x (..., K) @ Wdq (K, M) -> (..., M) in x's dtype, with the JAX
    package's pallas semantics on its route for the rows of x
    (ops.qgemm.kernel_for; plain=True takes the kernel's plain version):
    int8 activations quantized inside the kernel (per token, or per token
    and scale group, or with act_gs per token and activation group; after
    the optional norm or SwiGLU fold) and exact int32 dots, or, for
    grouped scales from 3 * group_size rows, bf16 activations times bf16
    dequantized weights; the optional residual added in the epilogue.

    A tensor packed for tensor parallelism's row split (k_shards > 1: wo
    and down of init_params(tp=)) run whole on one device takes no kernel,
    as JAX's qgemm_pallas takes none (it asserts k_shards == 1): it takes
    the JAX package's XLA route (its apply_qlinear at impl="xla"), one
    fold over every shard's groups (ops.qgemm.qgemm_torch) -- at mode
    "w_a8" on activations quantized per token, else on x as it is -- the
    SwiGLU applied first in bf16 and the residual added in f32."""
    if qt.k_shards > 1:
        return _xla_linear(x, qt, mode, norm, glu, residual)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    res2 = residual.reshape(-1, residual.shape[-1]) \
        if residual is not None else None
    out = kernel_for(qt, x2.shape[0], plain, act_gs=act_gs)(
        x2, qt, norm=norm, glu=glu, residual=res2)
    return out.reshape(*shape[:-1], qt.mdim).to(x.dtype)


def _xla_linear(x: torch.Tensor, qt: QuantizedTensor, mode: Optional[str], norm,
                glu: bool, residual) -> torch.Tensor:
    """apply_qlinear's route for a k-sharded tensor on one device: the JAX
    package's apply_qlinear with use_pallas off (mode "w_a8": x quantized
    per token over the whole row, the exact int dot times its scale; else
    the float dot), qgemm_xla's one fold over all shards."""
    if mode not in ("w_fp", "w_a8"):
        raise ValueError(f"a k-sharded tensor needs the quantization mode, not {mode!r}")
    if norm is not None:
        raise ValueError("a k-sharded tensor takes no norm fold (its rows are split)")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if glu:
        x2 = silu_mul(x2[:, :qt.kdim], x2[:, qt.kdim:])
    if mode == "w_a8":
        xq, xscale = quantize_activations_int8(x2)
        out = qgemm_torch(xq, qt, torch.float32) * xscale
    else:
        out = qgemm_torch(x2, qt, torch.float32)
    if residual is not None:
        out = out + residual.reshape(-1, residual.shape[-1]).float()
    # contiguous: the einsum's output may come permuted, and the kernels
    # that read this next take contiguous rows
    return out.reshape(*shape[:-1], qt.mdim).to(x.dtype).contiguous()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """silu(g) * u with silu in f32 rounded to u's dtype, as JAX computes
    `jax.nn.silu(g.astype(f32)).astype(g.dtype) * u` before a down
    projection whose K is padded."""
    gf = g.float()
    return (gf * (1.0 / (1.0 + torch.exp(-gf)))).to(u.dtype) * u


def rope_freqs(head_dim: int, theta: float, scaling=None):
    """Per-dim inverse frequencies with the optional long-context scaling
    of ModelConfig.rope_scaling, in float64 numpy as the JAX package
    computes them (so bit for bit its values): -> (inv_freqs (half,) f32,
    table_scale, the factor YaRN multiplies into cos and sin, else 1.0).
    Forms: ("linear", factor), ("factors", per-dim divisors), ("llama3",
    factor, original max positions, low and high frequency factors: the
    piecewise rule), ("yarn", factor, original max positions: the ramp,
    beta_fast 32 and beta_slow 1, and 0.1 ln(factor) + 1 on the tables)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    if scaling is None:
        return freqs.astype(np.float32), 1.0
    kind = scaling[0]
    if kind == "linear":
        return (freqs / float(scaling[1])).astype(np.float32), 1.0
    if kind == "factors":
        f = np.asarray(scaling[1], np.float64)
        if f.shape != (half,):
            raise ValueError(f"rope factors of shape {f.shape}, not ({half},)")
        return (freqs / f).astype(np.float32), 1.0
    if kind == "llama3":
        _, factor, orig, lo, hi = scaling
        wavelen = 2.0 * np.pi / freqs
        low_wl, high_wl = orig / lo, orig / hi
        smooth = np.clip((orig / wavelen - lo) / (hi - lo), 0.0, 1.0)
        scaled = freqs / factor
        out = np.where(wavelen < high_wl, freqs,
                       np.where(wavelen > low_wl, scaled,
                                (1.0 - smooth) * scaled + smooth * freqs))
        return out.astype(np.float32), 1.0
    if kind == "yarn":
        _, factor, orig = scaling

        def corr_dim(n_rot):
            return half * np.log(orig / (n_rot * 2 * np.pi)) / np.log(theta)
        low = max(np.floor(corr_dim(32.0)), 0.0)
        high = min(np.ceil(corr_dim(1.0)), half - 1.0)
        ramp = np.clip((np.arange(half) - low) / max(high - low, 1e-3), 0.0, 1.0)
        mask = 1.0 - ramp  # 1: keep (extrapolate), 0: interpolate
        out = (freqs / factor) * (1.0 - mask) + freqs * mask
        return out.astype(np.float32), float(0.1 * np.log(factor) + 1.0)
    raise ValueError(f"rope_scaling kind {kind!r}")


def rope_tables(positions: torch.Tensor, freqs: torch.Tensor,
                table_scale: float = 1.0):
    """positions (B, T) -> (cos, sin) each (B, T, 1, head_dim) f32 in the
    duplicated-half layout; freqs and table_scale from rope_freqs, freqs on
    positions' device."""
    angles = positions[:, :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    if table_scale != 1.0:
        cos, sin = cos * table_scale, sin * table_scale
    return torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)


def rope(x: torch.Tensor, tables) -> torch.Tensor:
    """Apply rotary embedding. x (B, T, H, D); tables from rope_tables."""
    cos, sin = tables
    half = x.shape[-1] // 2
    xf = x.float()
    rot = torch.cat([-xf[..., half:], xf[..., :half]], -1)
    return (xf * cos + rot * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """k/v: (L, B, KV_heads, S_max, Dp); pos: (B,) int32 write indices.

    Dp is head_dim rounded up to 128 and S_max is rounded up to 128, as in
    the JAX package, so caches keep its layout.  Unlike the JAX package's
    functional cache, ``Llama.forward`` updates this one IN PLACE: it
    writes the new rows and advances ``pos``.  A write that would run past
    the last row starts at S - T instead, as JAX's dynamic_update_slice
    clamps its start (``_write_rows``): a slot held at ``pos == S``
    rewrites row S - 1, and ``pos`` still advances.

    Quantized mode (``create(..., quant=True)``): k/v hold int8 codes and
    k_scale/v_scale (L, B, KV, S) f32 one absmax/127 scale per written row
    vector (``attention_kernel.quantize_kv``), half the bytes a decode step
    reads; K6, K8 and K9 fold the scales into the scores and
    probabilities."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", quant: bool = False) -> "KVCache":
        dp = round_up(cfg.head_dim, 128)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads,
                 round_up(max_len, 128), dp)
        dtype = torch.int8 if quant else torch.bfloat16
        scales = dict(k_scale=torch.zeros(shape[:4], device=device),
                      v_scale=torch.zeros(shape[:4], device=device)) \
            if quant else {}
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device),
                   **scales)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


# ---------------------------------------------------------------------------
# Parameter initialization (synthetic weights, same numpy draws as JAX)
# ---------------------------------------------------------------------------

def _check_slice(cfg: ModelConfig) -> None:
    """The model family this port covers so far: w_a8 with per-tensor
    scales (BitNet), dense or MoE, at any of JAX's bits 1 to 4 (whose
    init_params, converters and tools build bits-2 ternary weights
    whatever the config says, as _rand_qt does); w_fp at bits 1 to 4,
    dense or MoE, with grouped scales, with an act_group_size or without
    (one that does not divide the group size is ignored, as the JAX
    package ignores it), or per channel (group_size -1, with or without
    zero points); attention bias, tied, bf16 or int8 heads and every rope
    scaling.  A tensor's own form (bf16 or f32 scales, group size 16 or a
    multiple of 32, grouped bits 8, as a gguf file gives them) is the
    kernels' wrappers' to check.  What it refuses names the missing
    form."""
    q = cfg.quant
    if q.mode == "w_a8":
        if q.group_size != -1 or q.bits not in (1, 2, 3, 4):
            raise NotImplementedError(
                "w_a8 is ported for per-tensor scales at bits 1 to 4")
    elif (q.group_size <= 0 and q.group_size != -1) or q.bits not in (1, 2, 3, 4):
        raise NotImplementedError(
            "w_fp is ported for grouped or per-channel scales at bits 1 to 4")


def _rand_qt(rng: np.random.Generator, K: int, M: int, cfg: ModelConfig,
             device, k_shards: int = 1, m_shards: int = 1) -> QuantizedTensor:
    """Synthetic quantized weights, the JAX package's numpy draws in its
    order: w_a8 ternary {-1,0,1} stored as {1,2,3} with one scale per
    tensor (a row per k-shard); w_fp random codes with per-group scales and
    zero points (bf16 scales and sub when grouped, f32 per channel:
    group_size -1), the zero points on each group's mean code, jittered by
    -2..2.  k_shards / m_shards: packed for a row- / column-parallel split."""
    q = cfg.quant
    gs = K if q.group_size == -1 else q.group_size
    std = 1.0 / np.sqrt(K)
    shards = dict(k_shards=k_shards, m_shards=m_shards, device=device)
    if q.mode == "w_a8":
        wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
        scales = np.full((1, M), std, np.float32)
        if k_shards > 1:
            # one scale row per k-shard: each rank holds a (1, M) slice
            scales = np.repeat(scales, k_shards, 0)
        return QuantizedTensor.from_quantized(wq, scales, 2 * scales, bits=2,
                                              group_size=K // k_shards, **shards)
    qmax = (1 << q.bits) - 1
    mid = 1 << (q.bits - 1)
    G = K // gs
    wq = rng.integers(0, qmax + 1, (K, M), dtype=np.int64).astype(np.uint8)
    scales = ((0.5 + rng.random((G, M))) * (2.0 * std / mid)).astype(np.float32)
    if q.zero_point:
        # zero points on each group's mean code, jittered by -2..2
        gmean = wq.reshape(G, gs, M).astype(np.float32).mean(1).round()
        zq = np.clip(gmean + rng.integers(-2, 3, (G, M)), 0, qmax) \
            .astype(np.float32)
        sub = scales * zq
    else:
        sub = mid * scales
    sd = torch.bfloat16 if gs < K else torch.float32
    return QuantizedTensor.from_quantized(wq, scales, sub, q.bits, gs,
                                          scale_dtype=sd, **shards)


def _padded_ffn_width(size: int, cfg: ModelConfig, tp: int = 1) -> int:
    """An FFN width padded so the whole MLP keeps one 128-aligned layout
    (e.g. bitnet-3b 8640 -> 8704), and tp gate/up m-shards and down
    k-shards align with the scale groups."""
    gs = cfg.quant.group_size
    return round_up(size, int(np.lcm(tp * max(gs, 1), 128)))


def padded_intermediate(cfg: ModelConfig, tp: int = 1) -> int:
    return _padded_ffn_width(cfg.intermediate_size, cfg, tp)


def padded_moe_intermediate(cfg: ModelConfig, tp: int = 1) -> int:
    """padded_intermediate for the per-expert FFN width (MoE models)."""
    return _padded_ffn_width(cfg.moe_intermediate_size, cfg, tp)


def make_head(head_km: np.ndarray, cfg: ModelConfig, device="cuda"):
    """lm_head (H, V) float -> a bf16 (H, V) tensor (head_bits >= 16) or an
    int8 QuantizedTensor (per-column scale; head_bits 8)."""
    if cfg.head_bits >= 16:
        return torch.from_numpy(head_km).to(torch.bfloat16).to(device)
    if cfg.head_bits != 8:
        raise ValueError(f"head_bits {cfg.head_bits}: 8 or 16 and up")
    return QuantizedTensor.from_float(head_km, bits=8,
                                      group_size=head_km.shape[0],
                                      device=device)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                tp: int = 1) -> Dict[str, Any]:
    """Random-but-realistic quantized parameters at the model's shapes,
    byte for byte those of the JAX package's init_params(cfg, seed, tp=tp):
    tp > 1 packs the row-parallel linears (wo, down, the experts' and the
    shared expert's down) with k_shards=tp and the column-parallel ones
    with m_shards=tp, the FFN widths padded so each shard keeps whole
    scale groups (parallel/tp.py slices them)."""
    _check_slice(cfg)
    rng = np.random.default_rng(seed)
    H, I = cfg.hidden_size, padded_intermediate(cfg, tp)
    col = functools.partial(_rand_qt, rng, cfg=cfg, device=device, m_shards=tp)
    row = functools.partial(_rand_qt, rng, cfg=cfg, device=device, k_shards=tp)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=device)

    def normal_bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape) * 0.02).to(
            torch.bfloat16).to(device)

    def gate_up(width):
        return fuse_m([col(H, width), col(H, width)])

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "attn_norm": ones(H),
            "mlp_norm": ones(H),
            "wqkv": fuse_m([col(H, cfg.q_dim), col(H, cfg.kv_dim),
                            col(H, cfg.kv_dim)]),
            "wo": row(cfg.q_dim, H),
        }
        if cfg.num_experts:
            # router, then every expert's fused gate_up, then every down,
            # then the shared expert: the JAX package's order of draws
            Ie, E = padded_moe_intermediate(cfg, tp), cfg.num_experts
            layer["moe_router"] = normal_bf16((H, E))
            layer["experts_gate_up"] = stack_experts(
                [gate_up(Ie) for _ in range(E)])
            layer["experts_down"] = stack_experts([row(Ie, H) for _ in range(E)])
            if cfg.moe_shared_intermediate_size:
                Is = _padded_ffn_width(cfg.moe_shared_intermediate_size, cfg, tp)
                layer["shared_gate_up"] = gate_up(Is)
                layer["shared_down"] = row(Is, H)
                if cfg.moe_shared_gate:
                    layer["shared_gate"] = normal_bf16((H,))
        else:
            layer["gate_up"] = gate_up(I)
            layer["down"] = row(I, H)
        if cfg.attention_bias:
            # zeros, as the JAX package draws them (a checkpoint brings its own)
            for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                                ("bv", cfg.kv_dim)):
                layer[name] = torch.zeros((width,), dtype=torch.bfloat16,
                                          device=device)
        layers.append(layer)
    params = {
        "embed": normal_bf16((cfg.vocab_size, H)),
        "layers": layers,
        "final_norm": ones(H),
    }
    if not cfg.tie_word_embeddings:
        head = (rng.standard_normal((H, cfg.vocab_size)) * 0.02).astype(np.float32)
        params["lm_head"] = make_head(head, cfg, device)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _write_rows(positions: torch.Tensor, S: int) -> torch.Tensor:
    """The cache rows (B, T) that a write of T rows at positions (B, T)
    lands on: each slot's start clamped to [0, S - T], as JAX's
    dynamic_update_slice clamps it, so a write that would run past the
    last row ends at row S - 1."""
    T = positions.shape[1]
    start = positions[:, :1].long().clamp(0, S - T)
    return start + torch.arange(T, device=positions.device)


def _write_kv_stacked(buf: torch.Tensor, li: int, kv: torch.Tensor,
                      positions: torch.Tensor) -> None:
    """Write kv (B, T, KV, D) into the stacked cache buf (L, B, KV, S, Dp)
    at layer li, rows _write_rows(positions) (B, T), in place.  The
    padding columns D..Dp stay as the cache was created: zero."""
    rows = torch.arange(kv.shape[0], device=kv.device)[:, None]
    cols = _write_rows(positions, buf.shape[3])
    buf[li, ..., :kv.shape[-1]][rows, :, cols] = kv.to(buf.dtype)


def _write_scale_stacked(sbuf: torch.Tensor, li: int, sc: torch.Tensor,
                         positions: torch.Tensor) -> None:
    """Write per-vector scales sc (B, T, KV) into the stacked scale buffer
    (L, B, KV, S) at layer li, rows _write_rows(positions), in place."""
    rows = torch.arange(sc.shape[0], device=sc.device)[:, None]
    sbuf[li][rows, :, _write_rows(positions, sbuf.shape[3])] = sc


def _write_kv_all_layers(buf: torch.Tensor, per_layer: torch.Tensor,
                         pos: torch.Tensor) -> None:
    """The deferred mode's commit: every layer's decode-step rows
    per_layer (L, B, 1, KV, D) into buf (L, B, KV, S, Dp) at rows
    _write_rows(pos) (B, 1), in place, in one write."""
    rows = torch.arange(per_layer.shape[1], device=buf.device)[:, None]
    cols = _write_rows(pos[:, None], buf.shape[3])
    buf[..., :per_layer.shape[-1]][:, rows, :, cols] = \
        per_layer.permute(1, 2, 0, 3, 4).to(buf.dtype)


def _write_scale_all_layers(sbuf: torch.Tensor, per_layer: torch.Tensor,
                            pos: torch.Tensor) -> None:
    """_write_kv_all_layers for the scales: per_layer (L, B, 1, KV) into
    sbuf (L, B, KV, S)."""
    rows = torch.arange(per_layer.shape[1], device=sbuf.device)[:, None]
    sbuf[:, rows, :, _write_rows(pos[:, None], sbuf.shape[3])] = \
        per_layer.permute(1, 2, 0, 3)


def _tp_sum(out: torch.Tensor, x: Optional[torch.Tensor], group) -> torch.Tensor:
    """A row-parallel linear's output: without a group the epilogue has
    added the residual already; with one the partial outputs (bf16) are
    summed over the group in place (all_reduce, JAX's psum) and x, where
    given, is added after, in bf16."""
    if group is None:
        return out
    torch.distributed.all_reduce(out, group=group)
    return out if x is None else x + out


def layer_qkv_rope(blk, cfg: ModelConfig, x: torch.Tensor, tables, lin):
    """A layer's prologue (the forward's, and parallel/sp.py's and pp.py's):
    the norm folded into wqkv, the optional biases (in bf16), rotary.  x
    (B, T, H); lin: apply_qlinear with the model's options -> q (B, T,
    heads, D), k and v (B, T, KV, D)."""
    B, T = x.shape[:2]
    qd, kvd = cfg.q_dim, cfg.kv_dim
    qkv = lin(x, blk.wqkv.qt, norm=(blk.attn_norm, cfg.rms_norm_eps))
    q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
    if hasattr(blk, "bq"):
        # attention bias, added in the activations' dtype (bf16)
        q, k, v = q + blk.bq, k + blk.bk, v + blk.bv
    q = rope(q.reshape(B, T, cfg.num_heads, cfg.head_dim), tables)
    k = rope(k.reshape(B, T, cfg.num_kv_heads, cfg.head_dim), tables)
    return q, k, v.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)


def attn_out(blk, x: torch.Tensor, attn: torch.Tensor, lin, group) -> torch.Tensor:
    """wo and the residual: folded into wo's epilogue only where no sum
    over the tp group follows (it must see the partial sums)."""
    res = x if group is None else None
    return _tp_sum(lin(attn, blk.wo.qt, residual=res), x, group)


def dense_mlp(blk, cfg: ModelConfig, x: torch.Tensor, lin, group) -> torch.Tensor:
    """The dense MLP and the residual: the norm folded into gate_up, SwiGLU
    into down where its K is unpadded (else silu(g) * u in bf16 before
    it, as in JAX), the residual in down's epilogue unless a tp sum
    follows."""
    gu = lin(x, blk.gate_up.qt, norm=(blk.mlp_norm, cfg.rms_norm_eps))
    down = blk.down.qt
    res = x if group is None else None
    if down.kdim_padded == down.kdim:
        d = lin(gu, down, glu=True, residual=res)
    else:
        d = lin(silu_mul(gu[..., :down.kdim], gu[..., down.kdim:]), down, residual=res)
    return _tp_sum(d, x, group)


class QLinear(nn.Module):
    """A QuantizedTensor's arrays held as module buffers."""

    def __init__(self, qt: QuantizedTensor):
        super().__init__()
        self.register_buffer("packed", qt.packed)
        self.register_buffer("packed_hi", qt.packed_hi)
        self.register_buffer("scales", qt.scales)
        self.register_buffer("sub", qt.sub)
        self.meta = dict(bits=qt.bits, group_size=qt.group_size,
                         k_shards=qt.k_shards, m_shards=qt.m_shards,
                         shape=qt.shape, m_segments=qt.m_segments)

    @property
    def qt(self) -> QuantizedTensor:
        return QuantizedTensor(self.packed, self.packed_hi, self.scales,
                               self.sub, **self.meta)


_MOE_VECTORS = ("mlp_norm", "moe_router", "shared_gate")
_BIASES = ("bq", "bk", "bv")
_MOE_LINEARS = ("experts_gate_up", "experts_down", "shared_gate_up",
                "shared_down")


class Block(nn.Module):
    """One layer's parameters: norms, the attention linears, and a dense
    MLP (gate_up, down) or an MoE one (router, stacked experts, optional
    shared expert)."""

    def __init__(self, layer: Dict[str, Any]):
        super().__init__()
        for name in ("attn_norm",) + _MOE_VECTORS + _BIASES:
            if name in layer:
                self.register_buffer(name, layer[name])
        for name in ("wqkv", "wo", "gate_up", "down") + _MOE_LINEARS:
            if name in layer:
                setattr(self, name, QLinear(layer[name]))

    def moe_layer(self) -> Dict[str, Any]:
        """The MoE MLP's parameters as moe_mlp takes them."""
        out = {n: getattr(self, n) for n in _MOE_VECTORS if hasattr(self, n)}
        out.update({n: getattr(self, n).qt for n in _MOE_LINEARS
                    if hasattr(self, n)})
        return out


def kv_write_mode(deferred_kv: Optional[bool] = None) -> str:
    """The decode step's KV-write mode, from the JAX package's switches
    (its forward's `deferred_kv` argument and environment variables, all
    off by default):
      "inkernel"  K9 attends and stores the current row itself, when
                  TMAC_KV_INKERNEL=1 and deferred_kv is not True;
      "deferred"  K8 attends with the current k/v as operands and one write
                  after the layer loop commits every layer's row, when
                  deferred_kv is True, or None with TMAC_DEFERRED_KV=1;
      "explicit"  a write per layer, then K2 or K6 over the cache (which on
                  an int8 cache reads the current row back quantized, where
                  the other two modes keep it float)."""
    if deferred_kv is not True \
            and os.environ.get("TMAC_KV_INKERNEL", "0") == "1":
        return "inkernel"
    if deferred_kv or (deferred_kv is None and
                       os.environ.get("TMAC_DEFERRED_KV", "0") == "1"):
        return "deferred"
    return "explicit"


def block_kernel_gate(cfg: ModelConfig, blk: Block) -> bool:
    """Whether a one-token, one-sequence step runs the layer's residual
    block as K10 in block mode: the JAX package's gate (w_a8, no experts,
    per-tensor wo, gate_up and down at bits 1, 2 or 4, unpadded as the
    kernel needs).  As there, wo's K is not checked here, and the kernel
    raises where the reference's asserts fail."""
    wo, gu, down = blk.wo.qt, blk.gate_up.qt, blk.down.qt
    hidden = cfg.hidden_size
    return (cfg.quant.mode == "w_a8" and not cfg.num_experts
            and all(t.scales.shape[0] == 1 for t in (wo, gu, down))
            and wo.bits in (1, 2, 4) and wo.kdim_padded == wo.kdim
            and wo.mdim_padded == wo.mdim == hidden
            and down.kdim_padded == down.kdim
            and down.mdim_padded == down.mdim == hidden
            and gu.mdim_padded == 2 * down.kdim)


class Llama(nn.Module):
    """The transformer over a params tree (dense or MoE MLPs).

    forward(tokens (B, T), cache) -> (logits (B, T, V) f32, cache): the
    JAX package's forward contract, except that the cache is updated in
    place (see KVCache).  The residual stream stays bf16, as in JAX.

    plain=True runs the kernels' plain PyTorch versions instead of K1, K4,
    K7 and the attention kernels on whatever device the weights are on.  It
    exists so that the kernel path can be held against a reference on the
    card; the default path never falls back to it.

    tp_group: a torch.distributed process group of tensor parallelism
    (parallel/tp.py), the counterpart of the JAX package's tp_axis: cfg is
    then the rank's local config and params its shards; the partial
    outputs of wo and down (the MoE MLP's too) are summed over the group
    in the stream's bf16, as JAX's psum, and the residual is added after
    the sum (never in the kernel's epilogue); K10's block mode is off, as
    in JAX.  Every rank runs the replicated parts (embedding, final norm,
    head).

    ep, moe_group: expert parallelism (parallel/ep.py), the counterpart of
    the JAX package's ep_axis: ep = (index, size), this rank's place on the
    ep axis (its MoE stacks hold E / size experts, models/moe.py's
    moe_mlp(ep_axis=)); the MoE MLP's output is summed once over moe_group
    (the ep x tp ranks; by default the tp group), attention's wo over the
    tp group only.
    deferred_kv and the environment choose the decode step's KV-write mode
    once, here (kv_write_mode), so that a captured CUDA graph holds one
    mode; a prefill (T > 1) always writes explicitly, as in JAX.  So is
    the block mode (TMAC_BLOCK_KERNEL=1 while the model is made, off by
    default, as the JAX package reads it): a step of one token and one
    sequence then runs each layer that block_kernel_gate admits through
    K10."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 plain: bool = False, deferred_kv: Optional[bool] = None,
                 tp_group=None, ep=None, moe_group=None):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        self.plain = plain
        self.tp_group = tp_group
        self.ep = ep
        self.moe_group = moe_group if moe_group is not None else tp_group
        self.kv_mode = kv_write_mode(deferred_kv)
        self.block_mode = os.environ.get("TMAC_BLOCK_KERNEL", "0") == "1"
        self.attend = {
            "explicit": (flash_decode_plain, flash_decode),
            "deferred": (flash_decode_append_plain, flash_decode_append),
            "inkernel": (flash_decode_append_write_plain,
                         flash_decode_append_write),
        }[self.kv_mode][0 if plain else 1]
        self.register_buffer("embed", params["embed"])
        self.register_buffer("final_norm", params["final_norm"])
        self.layers = nn.ModuleList(Block(l) for l in params["layers"])
        # the head: an int8 QuantizedTensor (K1/K3), a bf16 (H, V) tensor,
        # or none (tie_word_embeddings: the embedding's transpose)
        head = params.get("lm_head")
        self.lm_head = QLinear(head) if isinstance(head, QuantizedTensor) else None
        self.register_buffer("head_w", head if torch.is_tensor(head) else None)
        dev = params["embed"].device
        self.register_buffer("layer_ids", torch.arange(
            cfg.num_layers, dtype=torch.int32, device=dev))
        freqs, self.table_scale = rope_freqs(cfg.head_dim, cfg.rope_theta,
                                             cfg.rope_scaling)
        self.register_buffer("freqs", torch.from_numpy(freqs).to(dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def linear(self):
        """apply_qlinear with the model's options (its plain flag, the
        config's activation group size and mode), as its layers call it."""
        return functools.partial(apply_qlinear, plain=self.plain,
                                 act_gs=self.cfg.quant.act_group_size,
                                 mode=self.cfg.quant.mode)

    def _decode_attention(self, q, k, v, cache: KVCache, li: int, lens):
        """q (B, 1, H, D), this step's k/v (B, 1, KV, D) -> (B, 1, H*D)
        through the mode's kernel over `lens` (B,) rows of the stacked
        cache."""
        B, _, H, D = q.shape
        KV = cache.k.shape[2]
        kw = dict(scale=1.0 / math.sqrt(D), k_scale=cache.k_scale,
                  v_scale=cache.v_scale, window=self.cfg.sliding_window)
        args = (q.reshape(B, KV, H // KV, D), cache.k, cache.v, lens,
                self.layer_ids[li:li + 1])
        if self.kv_mode == "explicit":
            o = self.attend(*args, **kw)
        else:
            o = self.attend(*args, k.reshape(B, KV, D), v.reshape(B, KV, D),
                            **kw)
        return o.reshape(B, 1, H * D)

    def _prefill_attention(self, q, cache: KVCache, li: int, positions,
                           kv_len_mask):
        """q (B, T, H, D) -> (B, T, H*D): a masked softmax in f32 over the
        valid rows at or before each position (and inside the window), an
        int8 cache dequantized in f32 as JAX does off the TPU."""
        cfg = self.cfg
        B, T, H, D = q.shape
        KV, S, Dp = cache.k.shape[2], cache.k.shape[3], cache.k.shape[4]
        qr = F.pad(q.reshape(B, T, KV, H // KV, D).float(), (0, Dp - D))
        k, v = cache.k[li].float(), cache.v[li].float()
        if cache.quantized:
            k = k * cache.k_scale[li][..., None]
            v = v * cache.v_scale[li][..., None]
        scores = torch.einsum("btkrd,bksd->btkrs", qr, k) / math.sqrt(D)
        s_idx = torch.arange(S, device=q.device)[None, None, :]
        valid = (s_idx <= positions[:, :, None]) & kv_len_mask[:, None, :]
        if cfg.sliding_window > 0:
            valid &= s_idx > positions[:, :, None] - cfg.sliding_window
        scores = torch.where(valid[:, :, None, None, :], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, -1)
        out = torch.einsum("btkrs,bksd->btkrd", probs, v)
        return out[..., :D].reshape(B, T, H * D).to(q.dtype)

    @staticmethod
    def _write_kv(cache: KVCache, li: int, k, v, positions) -> None:
        """Write k/v (B, T, KV, D) at layer li, rows positions, quantized
        on an int8 cache."""
        for buf, sbuf, kv in ((cache.k, cache.k_scale, k),
                              (cache.v, cache.v_scale, v)):
            if sbuf is not None:
                kv, sc = quantize_kv(kv)
                _write_scale_stacked(sbuf, li, sc, positions)
            _write_kv_stacked(buf, li, kv, positions)

    @staticmethod
    def _commit_kv(cache: KVCache, ks, vs) -> None:
        """The deferred mode's one write of every layer's row, ks/vs
        (L, B, 1, KV, D), at rows cache.pos."""
        for buf, sbuf, kv in ((cache.k, cache.k_scale, ks),
                              (cache.v, cache.v_scale, vs)):
            if sbuf is not None:
                kv, sc = quantize_kv(kv)
                _write_scale_all_layers(sbuf, sc, cache.pos)
            _write_kv_all_layers(buf, kv, cache.pos)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final-normed x (B, T, H) -> logits (B, T, V) f32: the int8 head
        through K1 (K3 from 64 rows); a bf16 head, or the tied embedding's
        transpose, as one matmul of the bf16 operands summed in f32 (JAX's
        preferred_element_type=f32 dot, which it leaves to XLA)."""
        B, T, H = x.shape
        if self.lm_head is not None:
            head = self.lm_head.qt
            logits = kernel_for(head, B * T, self.plain)(x.reshape(B * T, H), head)
            return logits.reshape(B, T, head.mdim)
        w = self.embed.t() if self.head_w is None else self.head_w
        return torch.matmul(x.float(), w.float())

    def forward(self, tokens: torch.Tensor, cache: KVCache,
                active: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                embeds: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        """tokens (B, T) -> (logits (B, T, V) f32, cache), the JAX
        package's forward options: active (B,) bool freezes the slots that
        are False (their pos does not advance; their rows are still written
        at the frozen pos, as JAX writes them); valid (B, T) bool marks the
        real tokens for the MoE dispatch; embeds (B, T, H) replaces the
        embedding lookup (cast to the embedding's dtype; tokens still give
        the shapes); return_hidden returns the hidden states (B, T, H)
        before the final norm instead of logits."""
        cfg = self.cfg
        group = self.tp_group
        B, T = tokens.shape
        dev = tokens.device
        x = F.embedding(tokens, self.embed) if embeds is None \
            else embeds.to(self.embed.dtype)                      # (B, T, H)
        positions = (cache.pos[:, None].long()
                     + torch.arange(T, device=dev)[None, :])      # (B, T)
        mode = self.kv_mode if T == 1 else "explicit"
        if T == 1:
            # the cached rows to attend over, the current one among them
            # once it is written
            lens = cache.pos + 1 if mode == "explicit" else cache.pos
            kv_len_mask = None
        else:
            lens, kv_len_mask = None, (
                torch.arange(cache.max_len, device=dev)[None, :]
                < positions[:, -1:] + 1)                          # (B, S)
        pending = []
        tables = rope_tables(positions, self.freqs, self.table_scale)
        eps = cfg.rms_norm_eps
        plain = self.plain
        # every quantized linear of a layer, with the config's activation
        # group size (K4's and K4L's ags form; the other kernels ignore it)
        lin = self.linear()
        for li, blk in enumerate(self.layers):
            q, k, v = layer_qkv_rope(blk, cfg, x, tables, lin)
            if mode == "explicit":
                self._write_kv(cache, li, k, v, positions)
            elif mode == "deferred":
                pending.append((k, v))
            if T == 1:
                attn = self._decode_attention(q, k, v, cache, li, lens)
            else:
                attn = self._prefill_attention(q, cache, li, positions,
                                               kv_len_mask)
            if B == 1 and T == 1 and self.block_mode and group is None and \
                    block_kernel_gate(cfg, blk):
                # wo + residual, norm, gate_up, SwiGLU, down + residual in
                # one program (K10), its f32 output cast to the stream's bf16
                block = wo_mlp_block_plain if plain else wo_mlp_block
                x = block(attn.reshape(1, -1), x.reshape(1, -1), blk.mlp_norm,
                          blk.wo.qt, blk.gate_up.qt, blk.down.qt,
                          eps).reshape(B, T, -1).to(x.dtype)
                continue
            x = attn_out(blk, x, attn, lin, group)
            if cfg.num_experts:
                # MoE MLP (models/moe.py): norm, routing and the experts;
                # the residual is added here, in bf16, after the one sum
                # over the ep x tp ranks
                d = moe_mlp(x, blk.moe_layer(), cfg, cfg.quant.mode,
                            act_gs=cfg.quant.act_group_size, ep_axis=self.ep,
                            valid=valid, plain=plain)
                x = x + _tp_sum(d, None, self.moe_group)
                continue
            x = dense_mlp(blk, cfg, x, lin, group)
        if pending:
            self._commit_kv(cache, *(torch.stack(t) for t in zip(*pending)))
        cache.pos += T if active is None else T * active.to(cache.pos.dtype)
        if return_hidden:
            return x, cache
        return self._head(rms_norm(x, self.final_norm, eps)), cache
