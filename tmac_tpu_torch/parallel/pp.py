"""Pipeline parallelism: the layers split into stages over ranks.

The port of ``tmac_tpu/parallel/pp.py``.  A rank of the pp axis holds only
its stage's L / pp layers (``stack_params_pp``'s stage trees, sharded by
``shard_params_pp``) and those layers' KV cache (``shard_cache_pp``: the
cache's layer axis over pp), so a model whose weights and cache exceed one
card fits on pp of them; with tp > 1 each stage is also Megatron-sharded
over its tp ranks (``make_pp_tp_mesh``).

Prefill pipelines the prompt in M microbatches of Tc tokens: at step t
stage s runs chunk t - s, whose earlier chunks' K/V its cache already
holds, and hands its output to stage s + 1.  JAX runs every stage on every
step inside one program (an invalid step's results where-selected away);
here a rank runs a stage only when its chunk has arrived, under host
control flow, and the results are the same: the last logits, each stage's
cache rows and pos.  A decode step passes one token through the stages in
turn (pp hand-offs); attention in both is the JAX package's chunked online
softmax (parallel/sp.py's chunked_causal_attention), as its pp.py runs it.

The hand-off between stages is an all_reduce over the pp group of a
(pp, B, Tc, H) buffer in which each stage fills its own slot (a stage
reads its predecessor's; every other slot is zeros, so the sum is exact):
every rank joins it at every step, as JAX's ppermute, and gloo takes it on
CUDA tensors (two ranks on one card) as on CPU ones.  The mesh is a pp x
tp grid, rank = s * tp + t: parallel/tp.py's Mesh with dp as the pp axis.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.models.llama import (KVCache, Llama, _write_kv_stacked, layer_qkv_rope,
                                         rms_norm, rope_tables)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.parallel import tp as tpmod
from tmac_tpu_torch.parallel.sp import chunked_causal_attention, layer_out_mlp

REP = tpmod.REP
# the stacked stage leaves' specs: (pp, Lp, ...) with the stage axis over
# pp and, under tp, the Megatron axis of each (tp.param_specs' geometry
# behind the two stage axes)
COL4, ROW4 = ("pp", None, None, "tp"), ("pp", None, "tp", None)
_TP_SPECS = {"attn_norm": ("pp",), "mlp_norm": ("pp",), "wqkv": COL4, "gate_up": COL4,
             "wo": ROW4, "down": ROW4, "bq": ("pp", None, "tp"), "bk": ("pp", None, "tp"),
             "bv": ("pp", None, "tp")}


def make_pp_mesh(pp: int, device=None) -> tpmod.Mesh:
    """The pp mesh over pp joined ranks (a pp x 1 grid)."""
    return make_pp_tp_mesh(pp, 1, device)


def make_pp_tp_mesh(pp: int, tp: int, device=None) -> tpmod.Mesh:
    """The pp x tp mesh, tp the minor axis (rank = s * tp + t): tp.Mesh with
    dp as the pp axis (dp_group: this rank's pp group, dp_rank its
    stage)."""
    return tpmod.make_mesh(tp=tp, dp=pp, device=device)


def _stack(leaves, pp: int, Lp: int):
    """Per-layer leaves (L of them) -> one (pp, Lp, ...) leaf (a
    QuantizedTensor's arrays stacked alike, its meta one layer's)."""
    def st(ts):
        t = torch.stack(ts)
        return t.reshape((pp, Lp) + tuple(t.shape[1:]))
    if isinstance(leaves[0], QuantizedTensor):
        hi = st([q.packed_hi for q in leaves]) if leaves[0].packed_hi is not None else None
        return dataclasses.replace(leaves[0], packed=st([q.packed for q in leaves]),
                                   packed_hi=hi, scales=st([q.scales for q in leaves]),
                                   sub=st([q.sub for q in leaves]))
    return st(leaves)


def stack_params_pp(params, pp: int, tp: int = 1):
    """init_params' tree -> (the stage tree, its specs): every layer leaf
    stacked to (pp, Lp, ...) under "stages" (stage-sharded on axis 0; under
    tp also on its Megatron axis: pass tp-packed params, init_params(...,
    tp=tp)); embed, final_norm and lm_head replicated.  MoE models are
    refused, as in JAX."""
    L = len(params["layers"])
    if L % pp:
        raise ValueError(f"num_layers {L} must divide pp={pp}")
    if "experts_gate_up" in params["layers"][0]:
        raise ValueError("MoE models are not supported under pp (shard their experts over "
                         "ep: parallel/ep.py)")
    Lp = L // pp
    stages = {n: _stack([layer[n] for layer in params["layers"]], pp, Lp)
              for n in params["layers"][0]}
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stages"] = stages
    specs = {k: REP for k in out}
    specs["stages"] = {n: ("pp",) if tp == 1 else _TP_SPECS[n] for n in stages}
    return out, specs


def shard_params_pp(params_pp, specs, mesh: tpmod.Mesh):
    """The rank's stage (its (1, Lp, ...) slice of every stage leaf, and its
    tp slices) and the replicated leaves, on its device."""
    return tpmod.shard_params(params_pp, mesh, specs=specs)


def shard_cache_pp(cache: KVCache, mesh: tpmod.Mesh) -> KVCache:
    """The rank's layers of a global bf16 cache (the layer axis over pp),
    and under tp its KV heads."""
    if cache.quantized:
        raise ValueError("int8 KV cache: supported on the tp/dp mesh path only (parallel/tp.py)")
    kv = ("pp", None, "tp", None, None)
    return KVCache(k=tpmod._shard(cache.k, kv, mesh), v=tpmod._shard(cache.v, kv, mesh),
                   pos=tpmod._shard(cache.pos, REP, mesh))


def stage_layers(stages, Lp: int, tp: int = 1):
    """The rank's (1, Lp, ...) stage leaves -> Lp per-layer dicts, each
    QuantizedTensor's meta made the tp shard's."""
    out = []
    for i in range(Lp):
        layer = {}
        for n, leaf in stages.items():
            if isinstance(leaf, QuantizedTensor):
                hi = leaf.packed_hi[0, i] if leaf.packed_hi is not None else None
                lt = dataclasses.replace(leaf, packed=leaf.packed[0, i], packed_hi=hi,
                                         scales=leaf.scales[0, i], sub=leaf.sub[0, i])
                if tp > 1:
                    lt = lt.localized(tp, axis=0 if n in ("wo", "down") else 1)
            else:
                lt = leaf[0, i]
            layer[n] = lt
        out.append(layer)
    return out


def stage_model(cfg: ModelConfig, mesh: tpmod.Mesh, params_pp, plain: bool = False) -> Llama:
    """The rank's stage as a Llama over its Lp layers (the tp-local config,
    its tp group summing wo and down), with the replicated embedding, final
    norm and head."""
    pp, tp = mesh.dp, mesh.tp
    if tp > 1:
        tpmod.check_cfg(cfg, tp)
    Lp = cfg.num_layers // pp
    lcfg = dataclasses.replace(tpmod.local_cfg(cfg, tp) if tp > 1 else cfg, num_layers=Lp)
    params = {k: v for k, v in params_pp.items() if k != "stages"}
    params["layers"] = stage_layers(params_pp["stages"], Lp, tp)
    return Llama(lcfg, params, plain=plain, tp_group=mesh.tp_group)


def _handoff(xo, mesh: tpmod.Mesh, shape, dtype):
    """Every stage's output one stage on: xo (this stage's, or None where
    it ran nothing) into its slot of a zero (pp, ...) buffer, summed over
    the pp group -> the predecessor's slot (zeros at stage 0)."""
    buf = torch.zeros((mesh.dp,) + tuple(shape), dtype=dtype, device=mesh.device)
    if xo is not None:
        buf[mesh.dp_rank] = xo
    if mesh.dp_group is not None:
        dist.all_reduce(buf, group=mesh.dp_group)
    return buf[mesh.dp_rank - 1] if mesh.dp_rank else None


def _run_stage(model: Llama, x, cache: KVCache, positions, kv_len: int, attn_chunk: int):
    """The stage's layers on x (B, Tc, H) at positions (B, Tc), each row's
    K/V written at its own rows of the stage's cache, then attended over up
    to kv_len rows; -> x."""
    cfg = model.cfg
    B, Tc = positions.shape
    tables = rope_tables(positions, model.freqs, model.table_scale)
    lin = model.linear()
    KV, rep = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    for li, blk in enumerate(model.layers):
        q, k, v = layer_qkv_rope(blk, cfg, x, tables, lin)
        _write_kv_stacked(cache.k, li, k, positions)
        _write_kv_stacked(cache.v, li, v, positions)
        attn = chunked_causal_attention(
            q.reshape(B, Tc, KV, rep, cfg.head_dim), cache.k[li], cache.v[li], positions,
            kv_len=kv_len, D=cfg.head_dim, chunk=attn_chunk,
            window=cfg.sliding_window).to(x.dtype)
        x = layer_out_mlp(blk, cfg, x, attn, lin, model.tp_group)
    return x


def _last_logits(model: Llama, x_last, mesh: tpmod.Mesh, from_stage: int):
    """The head on the final-normed x_last (B, H) at stage from_stage, its
    logits (B, V) f32 summed over the pp group (zeros elsewhere: exact)."""
    V = model.cfg.vocab_size
    if mesh.dp_rank == from_stage:
        lg = model._head(rms_norm(x_last[:, None], model.final_norm,
                                  model.cfg.rms_norm_eps))[:, 0].float().contiguous()
    else:
        lg = torch.zeros((x_last.shape[0], V), device=mesh.device)
    if mesh.dp_group is not None:
        dist.all_reduce(lg, group=mesh.dp_group)
    return lg


def make_pp_prefill(cfg: ModelConfig, mesh: tpmod.Mesh, params_pp, chunk: int = 0,
                    attn_chunk: int = 512, plain: bool = False):
    """prefill_fn(tokens (B, T), cache) -> (last logits (B, V) f32, cache):
    a fresh prompt (cache.pos 0) pipelined over the mesh's pp axis in M = T
    / Tc microbatches of Tc = chunk tokens (T / pp by default, at least 1;
    T % Tc == 0), with stage-internal tp where the mesh has it.  params_pp:
    shard_params_pp's output; cache: shard_cache_pp's.  The rank's stage
    model is ``.model``."""
    model = stage_model(cfg, mesh, params_pp, plain)
    pp, s = mesh.dp, mesh.dp_rank

    @torch.no_grad()
    def prefill_fn(tokens: torch.Tensor, cache: KVCache):
        B, T = tokens.shape
        Tc = chunk or max(T // pp, 1)
        if T % Tc:
            raise ValueError(f"prompt length {T} must divide the microbatch {Tc}")
        M = T // Tc
        tokens = tokens.to(mesh.device)
        H = cfg.hidden_size
        x_in, last_x = None, None
        for t in range(M + pp - 1):
            c = t - s                                  # the chunk at this stage now
            xo = None
            if 0 <= c < M:
                x = model.embed[tokens[:, c * Tc:(c + 1) * Tc]] if s == 0 else x_in
                positions = (c * Tc + torch.arange(Tc, device=mesh.device))[None].expand(B, Tc)
                xo = _run_stage(model, x, cache, positions, c * Tc + Tc, attn_chunk)
                if s == pp - 1 and c == M - 1:
                    last_x = xo[:, -1]
            x_in = _handoff(xo, mesh, (B, Tc, H), model.embed.dtype)
        if last_x is None:
            last_x = torch.zeros((B, H), dtype=model.embed.dtype, device=mesh.device)
        logits = _last_logits(model, last_x, mesh, pp - 1)
        cache.pos.fill_(T)
        return logits, cache

    prefill_fn.model = model
    return prefill_fn


def make_pp_decode_step(cfg: ModelConfig, mesh: tpmod.Mesh, params_pp, attn_chunk: int = 512,
                        plain: bool = False):
    """decode_fn(last (B,), cache) -> (logits (B, V) f32, cache): one token
    through the stages in turn (stage 0 embeds; pp hand-offs), each
    attending over its layers' cache up to max(pos) + 1 rows; pos + 1.  The
    rank's stage model is ``.model``."""
    model = stage_model(cfg, mesh, params_pp, plain)
    pp, s = mesh.dp, mesh.dp_rank

    @torch.no_grad()
    def decode_fn(last: torch.Tensor, cache: KVCache):
        B = last.shape[0]
        H = cfg.hidden_size
        positions = cache.pos[:, None].long()
        kv_len = int(cache.pos.max()) + 1
        x = model.embed[last.to(mesh.device)[:, None]] if s == 0 else None
        for t in range(pp):
            xo = _run_stage(model, x, cache, positions, kv_len, attn_chunk) if s == t else None
            if t < pp - 1:
                x_in = _handoff(xo, mesh, (B, 1, H), model.embed.dtype)
                if s == t + 1:
                    x = x_in
            elif s == t:
                x = xo
        x_last = x[:, -1] if s == pp - 1 else torch.zeros((B, H), dtype=model.embed.dtype,
                                                          device=mesh.device)
        logits = _last_logits(model, x_last, mesh, pp - 1)
        cache.pos += 1
        return logits, cache

    decode_fn.model = model
    return decode_fn

