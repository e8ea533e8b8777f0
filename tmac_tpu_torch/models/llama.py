"""Llama-family transformer in PyTorch: the main-path subset.

The port of ``tmac_tpu/models/llama.py`` for dense models with plain RoPE
and a bf16 KV cache: w_a8 (BitNet W1.58A8, per-tensor scales) and w_fp
with grouped scales (e.g. Llama-2-7B W2A16 / W4A16 g128, bits 2 and 4).
Every quantized linear goes through a kernel with the JAX package's pallas
semantics: K1 (ops/cuda/qgemm_kernel.py) for per-tensor scales, K4
(ops/cuda/qgemm_grouped_kernel.py) for grouped ones, with activations
quantized to int8 inside the kernel, rms_norm folded into wqkv and
gate_up, the residual into wo and down, and SwiGLU into down where down's
K is unpadded (elsewhere silu(g) * u runs in bf16 torch ops before down,
as in JAX).  Decode attention goes through kernel K2
(ops/cuda/attention_kernel.py); prefill attention is a masked softmax in
f32 torch ops, as the JAX package leaves it to XLA.  The int8 lm head is K1
with bits=8 and no folds, after a separate bf16 rms_norm.

Parameters are a plain dict tree (``init_params``, or
``convert.from_jax.params_from_numpy``) that ``Llama`` holds as buffers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.ops.cuda.attention_kernel import (flash_decode,
                                                      flash_decode_plain)
from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (qgemm_grouped,
                                                          qgemm_grouped_plain)
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (act_scale, qgemm_fused,
                                                  qgemm_fused_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
from tmac_tpu_torch.utils import round_up


def quantize_activations_int8(x: torch.Tensor):
    """Per-token absmax int8 quantization (1e-20 clamp, rint, +-127), as
    the JAX package's function computes it when compiled: XLA turns its
    `amax / 127.0` into a multiply by the f32 reciprocal."""
    scale = act_scale(x.abs().amax(-1, keepdim=True).float())
    # true division, by a tensor (a Python-scalar divisor becomes a
    # reciprocal multiply on CUDA)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def linear_kernel(qt: QuantizedTensor, plain: bool = False):
    """The kernel wrapper for a quantized linear: K4 for grouped scales, K1
    for per-tensor ones; with plain=True, its plain PyTorch version."""
    if qt.scales.shape[0] > 1:
        return qgemm_grouped_plain if plain else qgemm_grouped
    return qgemm_fused_plain if plain else qgemm_fused


def apply_qlinear(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None, plain: bool = False):
    """x (..., K) @ Wdq (K, M) -> (..., M) in x's dtype, with the JAX
    package's pallas semantics: int8 activations quantized inside the
    kernel (per token, or per token and scale group; after the optional
    norm or SwiGLU fold), exact int32 dots, optional residual added in the
    epilogue."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    res2 = residual.reshape(-1, residual.shape[-1]) \
        if residual is not None else None
    out = linear_kernel(qt, plain)(x2, qt, norm=norm, glu=glu, residual=res2)
    return out.reshape(*shape[:-1], qt.mdim).to(x.dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, scaling=None) -> np.ndarray:
    """Per-dim inverse frequencies (half,) f32 of plain RoPE."""
    if scaling is not None:
        raise NotImplementedError("rope_scaling is not ported yet")
    half = head_dim // 2
    freqs = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    return freqs.astype(np.float32)


def rope_tables(positions: torch.Tensor, freqs: torch.Tensor):
    """positions (B, T) -> (cos, sin) each (B, T, 1, head_dim) f32 in the
    duplicated-half layout; freqs from rope_freqs, on positions' device."""
    angles = positions[:, :, None, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
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
    writes the new rows and advances ``pos``.  Rows past max_len are an
    indexing error here, where JAX's dynamic_update_slice would clamp them
    (``generate`` checks the lengths).  (The int8 cache mode is not ported
    yet.)"""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @classmethod
    def create(cls, cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> "KVCache":
        dp = round_up(cfg.head_dim, 128)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads,
                 round_up(max_len, 128), dp)
        return cls(k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   v=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                   pos=torch.zeros((batch,), dtype=torch.int32, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


# ---------------------------------------------------------------------------
# Parameter initialization (synthetic weights, same numpy draws as JAX)
# ---------------------------------------------------------------------------

def _check_slice(cfg: ModelConfig) -> None:
    """The model family this port covers so far: dense w_a8 with
    per-tensor scales, or dense w_fp with grouped scales at bits 2 or 4
    and activations quantized per weight group."""
    q = cfg.quant
    if q.mode == "w_a8":
        if q.group_size != -1:
            raise NotImplementedError("only per-tensor w_a8 is ported")
    elif q.group_size <= 0 or q.bits not in (2, 4) or q.act_group_size:
        raise NotImplementedError(
            "w_fp is ported for grouped scales at bits 2 and 4, with "
            "activation groups equal to the weight groups")
    if cfg.num_experts or cfg.attention_bias or cfg.tie_word_embeddings \
            or cfg.head_bits != 8 or cfg.sliding_window or cfg.rope_scaling:
        raise NotImplementedError(
            "MoE, attention bias, tied or bf16 heads, sliding windows and "
            "rope scaling are not ported yet")


def _rand_qt(rng: np.random.Generator, K: int, M: int, cfg: ModelConfig,
             device) -> QuantizedTensor:
    """Synthetic quantized weights, the JAX package's numpy draws in its
    order: w_a8 ternary {-1,0,1} stored as {1,2,3} with one scale per
    tensor; w_fp random codes with per-group scales and zero points (bf16
    scales and sub when grouped)."""
    q = cfg.quant
    gs = K if q.group_size == -1 else q.group_size
    std = 1.0 / np.sqrt(K)
    if q.mode == "w_a8":
        wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
        scales = np.full((1, M), std, np.float32)
        return QuantizedTensor.from_quantized(wq, scales, 2 * scales, bits=2,
                                              group_size=K, device=device)
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
                                          scale_dtype=sd, device=device)


def padded_intermediate(cfg: ModelConfig) -> int:
    """The FFN width padded so the whole MLP keeps one 128-aligned layout
    (e.g. bitnet-3b 8640 -> 8704)."""
    gs = cfg.quant.group_size
    return round_up(cfg.intermediate_size, int(np.lcm(max(gs, 1), 128)))


def make_head(head_km: np.ndarray, cfg: ModelConfig, device="cuda"):
    """lm_head (H, V) float -> int8 QuantizedTensor (per-column scale)."""
    if cfg.head_bits != 8:
        raise NotImplementedError("only the int8 head is ported")
    return QuantizedTensor.from_float(head_km, bits=8,
                                      group_size=head_km.shape[0],
                                      device=device)


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random-but-realistic quantized parameters at the model's shapes,
    byte for byte those of the JAX package's init_params(cfg, seed)."""
    _check_slice(cfg)
    rng = np.random.default_rng(seed)
    H, I = cfg.hidden_size, padded_intermediate(cfg)

    def ones(n):
        return torch.ones((n,), dtype=torch.bfloat16, device=device)

    layers = []
    for _ in range(cfg.num_layers):
        layer = {
            "attn_norm": ones(H),
            "mlp_norm": ones(H),
            "wqkv": fuse_m([_rand_qt(rng, H, cfg.q_dim, cfg, device),
                            _rand_qt(rng, H, cfg.kv_dim, cfg, device),
                            _rand_qt(rng, H, cfg.kv_dim, cfg, device)]),
            "wo": _rand_qt(rng, cfg.q_dim, H, cfg, device),
        }
        layer["gate_up"] = fuse_m([_rand_qt(rng, H, I, cfg, device),
                                   _rand_qt(rng, H, I, cfg, device)])
        layer["down"] = _rand_qt(rng, I, H, cfg, device)
        layers.append(layer)
    embed = torch.from_numpy(rng.standard_normal((cfg.vocab_size, H)) * 0.02)
    head = (rng.standard_normal((H, cfg.vocab_size)) * 0.02).astype(np.float32)
    return {
        "embed": embed.to(torch.bfloat16).to(device),
        "layers": layers,
        "final_norm": ones(H),
        "lm_head": make_head(head, cfg, device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _write_kv_stacked(buf: torch.Tensor, li: int, kv: torch.Tensor,
                      positions: torch.Tensor) -> None:
    """Write kv (B, T, KV, D) into the stacked cache buf (L, B, KV, S, Dp)
    at layer li, rows positions (B, T) (int64), in place.  The padding
    columns D..Dp stay as the cache was created: zero."""
    B = kv.shape[0]
    rows = torch.arange(B, device=kv.device)[:, None]
    buf[li, ..., :kv.shape[-1]][rows, :, positions] = kv.to(buf.dtype)


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


class Block(nn.Module):
    def __init__(self, layer: Dict[str, Any]):
        super().__init__()
        self.register_buffer("attn_norm", layer["attn_norm"])
        self.register_buffer("mlp_norm", layer["mlp_norm"])
        for name in ("wqkv", "wo", "gate_up", "down"):
            setattr(self, name, QLinear(layer[name]))


class Llama(nn.Module):
    """The dense transformer over a params tree.

    forward(tokens (B, T), cache) -> (logits (B, T, V) f32, cache): the
    JAX package's forward contract, except that the cache is updated in
    place (see KVCache).  The residual stream stays bf16, as in JAX.

    plain=True runs the kernels' plain PyTorch versions instead of K1, K4
    and K2 on whatever device the weights are on.  It exists so that the
    kernel path can be held against a reference on the card; the default
    path never falls back to it."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 plain: bool = False):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        self.plain = plain
        self.attend = flash_decode_plain if plain else flash_decode
        self.register_buffer("embed", params["embed"])
        self.register_buffer("final_norm", params["final_norm"])
        self.layers = nn.ModuleList(Block(l) for l in params["layers"])
        self.lm_head = QLinear(params["lm_head"])
        dev = params["embed"].device
        self.register_buffer("layer_ids", torch.arange(
            cfg.num_layers, dtype=torch.int32, device=dev))
        self.register_buffer("freqs", torch.from_numpy(rope_freqs(
            cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(dev))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _attention(self, q, cache: KVCache, li: int, positions, kv_lens,
                   kv_len_mask):
        """q (B, T, H, D) -> (B, T, H*D); causal within the valid rows.
        Decode (T == 1) runs K2 on the stacked cache; prefill a masked
        softmax in f32."""
        cfg = self.cfg
        B, T, H, D = q.shape
        KV, S, Dp = cache.k.shape[2], cache.k.shape[3], cache.k.shape[4]
        rep = H // KV
        if T == 1:
            o = self.attend(q.reshape(B, KV, rep, D), cache.k, cache.v,
                            kv_lens,
                            self.layer_ids[li:li + 1],
                            scale=1.0 / math.sqrt(D))
            return o.reshape(B, T, H * D)
        qr = F.pad(q.reshape(B, T, KV, rep, D).float(), (0, Dp - D))
        k, v = cache.k[li].float(), cache.v[li].float()
        scores = torch.einsum("btkrd,bksd->btkrs", qr, k) / math.sqrt(D)
        s_idx = torch.arange(S, device=q.device)[None, None, :]
        valid = (s_idx <= positions[:, :, None]) & kv_len_mask[:, None, :]
        scores = torch.where(valid[:, :, None, None, :], scores,
                             torch.full_like(scores, -1e30))
        probs = torch.softmax(scores, -1)
        out = torch.einsum("btkrs,bksd->btkrd", probs, v)
        return out[..., :D].reshape(B, T, H * D).to(q.dtype)

    def forward(self, tokens: torch.Tensor, cache: KVCache):
        cfg = self.cfg
        B, T = tokens.shape
        dev = tokens.device
        x = F.embedding(tokens, self.embed)                       # (B, T, H)
        positions = (cache.pos[:, None].long()
                     + torch.arange(T, device=dev)[None, :])      # (B, T)
        if T == 1:
            kv_lens, kv_len_mask = cache.pos + 1, None  # rows incl. current
        else:
            kv_lens, kv_len_mask = None, (
                torch.arange(cache.max_len, device=dev)[None, :]
                < positions[:, -1:] + 1)                          # (B, S)
        tables = rope_tables(positions, self.freqs)
        eps = cfg.rms_norm_eps
        qd, kvd = cfg.q_dim, cfg.kv_dim
        plain = self.plain
        for li, blk in enumerate(self.layers):
            qkv = apply_qlinear(x, blk.wqkv.qt, norm=(blk.attn_norm, eps),
                                plain=plain)
            q = rope(qkv[..., :qd].reshape(B, T, cfg.num_heads, cfg.head_dim),
                     tables)
            k = rope(qkv[..., qd:qd + kvd].reshape(B, T, cfg.num_kv_heads,
                                                   cfg.head_dim), tables)
            v = qkv[..., qd + kvd:].reshape(B, T, cfg.num_kv_heads,
                                            cfg.head_dim)
            _write_kv_stacked(cache.k, li, k, positions)
            _write_kv_stacked(cache.v, li, v, positions)
            attn = self._attention(q, cache, li, positions, kv_lens,
                                   kv_len_mask)
            x = apply_qlinear(attn, blk.wo.qt, residual=x, plain=plain)
            gu = apply_qlinear(x, blk.gate_up.qt, norm=(blk.mlp_norm, eps),
                               plain=plain)
            down = blk.down.qt
            if down.kdim_padded == down.kdim:
                # SwiGLU folded into down's prologue
                x = apply_qlinear(gu, down, glu=True, residual=x, plain=plain)
            else:
                # down's K is padded (e.g. W2 at group size 128): JAX runs
                # silu(g) * u in bf16 before the kernel, and so does the port
                g, u = gu[..., :down.kdim].float(), gu[..., down.kdim:]
                h = (g * (1.0 / (1.0 + torch.exp(-g)))).to(u.dtype) * u
                x = apply_qlinear(h, down, residual=x, plain=plain)
        x = rms_norm(x, self.final_norm, eps)
        head = self.lm_head.qt
        logits = linear_kernel(head, plain)(x.reshape(B * T, -1), head)
        cache.pos += T
        return logits.reshape(B, T, head.mdim), cache
