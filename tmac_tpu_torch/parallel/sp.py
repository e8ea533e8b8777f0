"""Sequence-parallel prefill: the prompt sharded over ranks.

The port of ``tmac_tpu/parallel/sp.py``.  Each rank of the sp axis embeds
and projects its T / sp tokens of the prompt through the port's kernels
(the rank's rows: K5 for a grouped model's 512-row shard, K4L below 3 *
group_size rows, K3 for per-tensor scales), K/V are gathered over the sp
ranks every layer, and attention runs locally as a chunked online softmax,
causal by GLOBAL position, reading the cache only up to the shard's last
position (``chunked_causal_attention``: score memory O(Tl * chunk)).
Everything but attention is per token, so the body needs no other
communication.  The last shard's last-row logits reach every rank.

The mesh is an sp x tp grid of ranks, rank = s * tp + t (tp the minor
axis, as JAX's make_sp_tp_mesh): parallel/tp.py's Mesh with dp as the sp
axis.  Under tp each rank holds its Megatron shards (tp.shard_params) and
its KV heads of the cache; wo and down sum over the tp group, K/V gather
over the sp group.  The cache it leaves is replicated over sp and sharded
over KV heads: the one tp.make_tp_step's decode reads on the same mesh,
and with tp = 1 the one the single-device decode_loop reads.

Collectives on one card (gloo ranks) or CPU ranks: the K/V gather is an
all_reduce sum of each rank's chunk placed in zeros (adding zeros is
exact), as tp.py writes its gathers; the last logits likewise.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.models.llama import (KVCache, Llama, _write_kv_stacked, attn_out,
                                         dense_mlp, layer_qkv_rope, rms_norm, rope_tables)
from tmac_tpu_torch.parallel import tp as tpmod


def chunked_causal_attention(q: torch.Tensor, k_buf: torch.Tensor, v_buf: torch.Tensor,
                             positions: torch.Tensor, kv_len: int, D: int, chunk: int,
                             window: int = 0) -> torch.Tensor:
    """The JAX package's _chunked_causal_attention, in f32 as it runs off
    the TPU: q (B, Tl, KV, rep, D) against the cache buffers (B, KV, S, Dp)
    in chunks of `chunk` rows (halved until it divides S), reading only the
    cdiv(kv_len, chunk) chunks that hold rows below kv_len; row s visible to
    query t iff s <= positions[b, t] (and, with a window, s > positions -
    window).  An online softmax over the chunks; -> (B, Tl, KV * rep * D)
    f32."""
    B, Tl, KV, rep, _ = q.shape
    S = k_buf.shape[2]
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    dev = q.device
    m = torch.full((B, Tl, KV, rep), float("-inf"), device=dev)
    l = torch.zeros((B, Tl, KV, rep), device=dev)
    acc = torch.zeros((B, Tl, KV, rep, D), device=dev)
    pos = positions[:, :, None]
    for c0 in range(0, math.ceil(kv_len / chunk) * chunk, chunk):
        ks = k_buf[:, :, c0:c0 + chunk, :D].float()
        vs = v_buf[:, :, c0:c0 + chunk, :D].float()
        s = torch.einsum("btkrd,bksd->btkrs", qf, ks) * scale
        kv_idx = c0 + torch.arange(chunk, device=dev)
        ok = (kv_idx <= pos) & (kv_idx < kv_len)                   # (B, Tl, chunk)
        if window > 0:
            ok &= kv_idx > pos - window
        s = torch.where(ok[:, :, None, None, :], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        # rows with no visible key yet keep m = -inf: their weights are 0
        corr = torch.exp(torch.where(torch.isfinite(m), m - m_new, float("-inf")))
        p = torch.exp(torch.where(torch.isfinite(s), s - m_new[..., None], float("-inf")))
        p = torch.where(torch.isfinite(p), p, 0.0)
        corr = torch.where(torch.isfinite(corr), corr, 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkrs,bksd->btkrd", p, vs)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, Tl, KV * rep * D)


def layer_out_mlp(blk, cfg: ModelConfig, x, attn, lin, tp_group=None):
    """The JAX package's layer_out_mlp: wo and the residual, then the dense
    MLP and the residual, each residual folded into the kernel's epilogue
    only where no sum over the tp group follows (models/llama.py's
    attn_out and dense_mlp, the forward's own)."""
    return dense_mlp(blk, cfg, attn_out(blk, x, attn, lin, tp_group), lin, tp_group)


def make_sp_mesh(sp: int, device=None) -> tpmod.Mesh:
    """The sp mesh over sp joined ranks (an sp x 1 grid)."""
    return make_sp_tp_mesh(sp, 1, device)


def make_sp_tp_mesh(sp: int, tp: int, device=None) -> tpmod.Mesh:
    """The sp x tp mesh, tp the minor axis (rank = s * tp + t): tp.Mesh with
    dp as the sp axis (dp_group: this rank's sp group)."""
    return tpmod.make_mesh(tp=tp, dp=sp, device=device)


def shard_cache_sp_tp(cache: KVCache, mesh: tpmod.Mesh) -> KVCache:
    """The rank's KV heads of a global bf16 cache, every slot (replicated
    over sp); an int8 cache is refused, as in JAX."""
    if cache.quantized:
        raise ValueError("int8 KV cache: supported on the tp/dp mesh path only (parallel/tp.py)")
    kv = (None, None, "tp", None, None)
    return KVCache(k=tpmod._shard(cache.k, kv, mesh), v=tpmod._shard(cache.v, kv, mesh),
                   pos=tpmod._shard(cache.pos, (), mesh))


def _gather_seq(t: torch.Tensor, mesh: tpmod.Mesh) -> torch.Tensor:
    """(B, Tl, ...) of every sp rank -> (B, sp * Tl, ...), shard i at
    [i * Tl, (i + 1) * Tl): an all_reduce sum of each rank's rows placed in
    zeros (exact)."""
    if mesh.dp_group is None:
        return t
    Tl = t.shape[1]
    out = torch.zeros((t.shape[0], mesh.dp * Tl) + tuple(t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    out[:, mesh.dp_rank * Tl:(mesh.dp_rank + 1) * Tl] = t
    dist.all_reduce(out, group=mesh.dp_group)
    return out


@torch.no_grad()
def _sp_forward(model: Llama, tokens: torch.Tensor, cache: KVCache, start: int,
                mesh: tpmod.Mesh, attn_chunk: int):
    """The rank's shard of a span of T = Tl * sp tokens beginning at cache
    row `start`: tokens (B, Tl) its chunk.  -> the last shard's last-row
    logits (B, V) f32 on every rank; the cache (every layer's K/V of the
    whole span written at [start, start + T), pos = start + T), in place."""
    cfg = model.cfg
    B, Tl = tokens.shape
    T = Tl * mesh.dp
    offset = start + mesh.dp_rank * Tl
    dev = tokens.device
    x = model.embed[tokens]                                            # (B, Tl, H)
    positions = (offset + torch.arange(Tl, device=dev))[None, :].expand(B, Tl)
    tables = rope_tables(positions, model.freqs, model.table_scale)
    span = (start + torch.arange(T, device=dev))[None, :].expand(B, T)
    lin = model.linear()
    KV, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    for li, blk in enumerate(model.layers):
        q, k, v = layer_qkv_rope(blk, cfg, x, tables, lin)
        # this layer's K/V of the whole span (B, T, KV, D), written at
        # [start, start + T), then attended over with the cached prefix
        _write_kv_stacked(cache.k, li, _gather_seq(k, mesh), span)
        _write_kv_stacked(cache.v, li, _gather_seq(v, mesh), span)
        attn = chunked_causal_attention(
            q.reshape(B, Tl, KV, rep, cfg.head_dim), cache.k[li], cache.v[li], positions,
            kv_len=offset + Tl, D=cfg.head_dim, chunk=attn_chunk,
            window=cfg.sliding_window).to(x.dtype)
        x = layer_out_mlp(blk, cfg, x, attn, lin, model.tp_group)
    # (contiguous: the head's columns may be a slice of its padded ones,
    # and a collective needs its tensor whole)
    last = model._head(rms_norm(x[:, -1:], model.final_norm,
                                cfg.rms_norm_eps))[:, 0].float().contiguous()
    if mesh.dp_group is not None:
        # the last shard's rows reach every rank (the others give zeros)
        if mesh.dp_rank != mesh.dp - 1:
            last.zero_()
        dist.all_reduce(last, group=mesh.dp_group)
    cache.pos.fill_(start + T)
    return last, cache


def make_sp_prefill(cfg: ModelConfig, mesh: tpmod.Mesh, params, attn_chunk: int = 512,
                    plain: bool = False):
    """prefill_fn(tokens (B, T), cache, start=0) -> (last logits (B, V) f32,
    cache), sharded over the mesh's sp axis (with tp > 1 Megatron weight
    parallelism over its tp axis: params then tp.shard_params' output and
    the cache shard_cache_sp_tp's), with the rank's model as ``.model``.
    tokens: the whole span on every rank (each runs its T / sp); start: the
    cache row the span begins at (0 for a fresh prompt, or the running
    offset of a chunked prefill: attention then covers the cached prefix).
    T % sp == 0.  MoE models are refused (their stacks would replicate;
    parallel/ep.py shards them)."""
    if cfg.num_experts:
        raise ValueError("MoE models are not supported under sp (shard their experts over "
                         "ep: parallel/ep.py)")
    model = tpmod.tp_model(cfg, mesh, params, plain)

    def prefill_fn(tokens: torch.Tensor, cache: KVCache, start: int = 0):
        B, T = tokens.shape
        if T % mesh.dp:
            raise ValueError(f"prompt length {T} must divide sp={mesh.dp}")
        Tl = T // mesh.dp
        mine = tokens[:, mesh.dp_rank * Tl:(mesh.dp_rank + 1) * Tl].to(mesh.device)
        return _sp_forward(model, mine, cache, int(start), mesh, attn_chunk)

    prefill_fn.model = model
    return prefill_fn


def sp_prefill_chunked(prefill_fn, tokens: torch.Tensor, cache: KVCache, chunk: int):
    """SP composed with chunked prefill: tokens (B, T) through prefill_fn in
    spans of `chunk` tokens (each sharded over sp) at their offsets.  T %
    chunk == 0 and chunk % sp == 0.  -> (last logits, cache)."""
    B, T = tokens.shape
    if T % chunk:
        raise ValueError(f"prompt length {T} must divide the chunk {chunk}")
    last = None
    for off in range(0, T, chunk):
        last, cache = prefill_fn(tokens[:, off:off + chunk], cache, start=off)
    return last, cache
