"""Llama-family transformer in PyTorch: the main-path subset.

The port of ``tmac_tpu/models/llama.py`` for dense w_a8 (BitNet W1.58A8)
models with plain RoPE and a bf16 KV cache.  Every quantized linear goes
through kernel K1 (ops/cuda/qgemm_kernel.py) with the JAX package's fused
semantics: rms_norm folded into wqkv and gate_up, the residual into wo and
down, SwiGLU into down.  Decode attention goes through kernel K2
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
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (qgemm_fused,
                                                  qgemm_fused_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
from tmac_tpu_torch.utils import round_up


def quantize_activations_int8(x: torch.Tensor):
    """Per-token absmax int8 quantization (1e-20 clamp, rint, +-127), as
    the JAX package's function computes it when compiled: XLA turns its
    `amax / 127.0` into a multiply by the f32 reciprocal."""
    amax = x.abs().amax(-1, keepdim=True).float()
    scale = torch.clamp_min(amax, 1e-20) * torch.full_like(amax, 1.0 / 127.0)
    # true division, by a tensor (a Python-scalar divisor becomes a
    # reciprocal multiply on CUDA)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def apply_qlinear(x: torch.Tensor, qt: QuantizedTensor, norm=None,
                  glu: bool = False, residual=None, qgemm=qgemm_fused):
    """x (..., K) @ Wdq (K, M) -> (..., M) in x's dtype, with the JAX
    package's fused w_a8 semantics: per-token int8 activations quantized
    inside K1 (after the optional norm or SwiGLU fold), exact int32
    accumulation, optional residual added in the epilogue."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    res2 = residual.reshape(-1, residual.shape[-1]) \
        if residual is not None else None
    out = qgemm(x2, qt, norm=norm, glu=glu, residual=res2)
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
    """The model family this port covers so far."""
    if cfg.quant.mode != "w_a8" or cfg.quant.group_size != -1:
        raise NotImplementedError("only w_a8 per-tensor models are ported")
    if cfg.num_experts or cfg.attention_bias or cfg.tie_word_embeddings \
            or cfg.head_bits != 8 or cfg.sliding_window:
        raise NotImplementedError(
            "MoE, attention bias, tied or bf16 heads and sliding windows "
            "are not ported yet")


def _rand_qt(rng: np.random.Generator, K: int, M: int,
             device) -> QuantizedTensor:
    """Ternary weights {-1,0,1} stored as {1,2,3}, one scale per tensor."""
    wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
    scales = np.full((1, M), 1.0 / np.sqrt(K), np.float32)
    return QuantizedTensor.from_quantized(wq, scales, 2 * scales, bits=2,
                                          group_size=K, device=device)


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
            "wqkv": fuse_m([_rand_qt(rng, H, cfg.q_dim, device),
                            _rand_qt(rng, H, cfg.kv_dim, device),
                            _rand_qt(rng, H, cfg.kv_dim, device)]),
            "wo": _rand_qt(rng, cfg.q_dim, H, device),
        }
        layer["gate_up"] = fuse_m([_rand_qt(rng, H, I, device),
                                   _rand_qt(rng, H, I, device)])
        layer["down"] = _rand_qt(rng, I, H, device)
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
    """The dense w_a8 transformer over a params tree.

    forward(tokens (B, T), cache) -> (logits (B, T, V) f32, cache): the
    JAX package's forward contract, except that the cache is updated in
    place (see KVCache).  The residual stream stays bf16, as in JAX.

    plain=True runs the kernels' plain PyTorch versions instead of K1 and
    K2 on whatever device the weights are on.  It exists so that the
    kernel path can be held against a reference on the card; the default
    path never falls back to it."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any],
                 plain: bool = False):
        super().__init__()
        _check_slice(cfg)
        self.cfg = cfg
        self.qgemm = qgemm_fused_plain if plain else qgemm_fused
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
        for li, blk in enumerate(self.layers):
            qkv = apply_qlinear(x, blk.wqkv.qt, norm=(blk.attn_norm, eps),
                                qgemm=self.qgemm)
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
            x = apply_qlinear(attn, blk.wo.qt, residual=x, qgemm=self.qgemm)
            gu = apply_qlinear(x, blk.gate_up.qt, norm=(blk.mlp_norm, eps),
                               qgemm=self.qgemm)
            x = apply_qlinear(gu, blk.down.qt, glu=True, residual=x,
                              qgemm=self.qgemm)
        x = rms_norm(x, self.final_norm, eps)
        head = self.lm_head.qt
        logits = self.qgemm(x.reshape(B * T, -1), head)
        cache.pos += T
        return logits.reshape(B, T, head.mdim), cache
