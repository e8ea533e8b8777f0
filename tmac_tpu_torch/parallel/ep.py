"""Expert parallelism: MoE expert stacks sharded over an ep axis of ranks.

The port of ``tmac_tpu/parallel/ep.py``.  The JAX package shards the
stacked experts' leading E axis over the mesh axis 'ep' of an (ep, tp)
mesh and runs the forward in one ``shard_map``; here each rank is a
process (parallel/launch.py) holding E / ep experts of every stack (and,
under tp, its Megatron slice of each), the attention's heads of its tp
group, and the whole batch:

  * tokens and attention replicate over ep (the MoE MLP dominates the
    weight bytes: Mixtral-8x7B is ~87% expert weights); each rank runs
    only its local experts on the token block (models/moe.py's
    ``moe_mlp(ep_axis=)``: the combine weights sliced to them, dense or
    dispatch, never the select form, so kernel K7 is not on this path);
  * one all_reduce over every rank of the mesh (``MoeMesh.moe_group``)
    merges the weighted expert partials a layer (the top-k combine is
    linear); the shared expert, which every ep rank computes, is divided
    by the ep size first;
  * attention's wo sums over the tp group only, as in parallel/tp.py.

The mesh is an ep x tp grid of ranks, rank = e * tp + t (tp the minor
axis, as JAX's make_moe_mesh): parallel/tp.py's Mesh with dp = ep, plus
the group of all its ranks.  Collectives run over the backend the ranks
were joined with (gloo: several ranks on one card, or CPU ranks).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch.distributed as dist

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.parallel import tp as tpmod
from tmac_tpu_torch.runtime.sampling import SamplerConfig

REP, COL, ROW = tpmod.REP, tpmod.COL, tpmod.ROW


@dataclasses.dataclass
class MoeMesh(tpmod.Mesh):
    """This rank's place in an ep x tp grid: tp.Mesh with dp as the ep
    axis (dp_group: this rank's ep group), and moe_group, every rank of the
    grid (None for a grid of one rank)."""

    moe_group: Any = None

    @property
    def ep(self) -> int:
        return self.dp

    @property
    def ep_rank(self) -> int:
        return self.dp_rank


def make_moe_mesh(ep: int, tp: int = 1, device=None) -> MoeMesh:
    """The ep x tp mesh over the joined ranks, every rank calling it."""
    base = tpmod.make_mesh(tp=tp, dp=ep, device=device)
    mesh = MoeMesh(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})
    if ep * tp > 1:
        mesh.moe_group = dist.new_group(list(range(ep * tp)))
    return mesh


def check_moe_cfg(cfg: ModelConfig, ep: int, tp: int = 1) -> None:
    """Raise where the mesh does not split the model (JAX's asserts): an
    MoE model, E divisible by ep, and tp.check_cfg."""
    if cfg.num_experts <= 0:
        raise ValueError("ep sharding needs an MoE model")
    if cfg.num_experts % ep:
        raise ValueError(f"ep {ep} must divide num_experts {cfg.num_experts}")
    tpmod.check_cfg(cfg, tp)


def param_specs_moe(params) -> dict:
    """The spec tree over the ep x tp mesh: the expert stacks shard their
    leading E axis over ep and their Megatron axis over tp; attention as
    tp.param_specs; the shared expert over tp (replicated over ep); the
    rest replicated."""
    def layer_spec(layer):
        s = {"attn_norm": REP, "mlp_norm": REP, "wqkv": COL, "wo": ROW,
             "moe_router": REP, "experts_gate_up": ("ep", None, "tp"),
             "experts_down": ("ep", "tp", None)}
        if "shared_gate_up" in layer:
            s["shared_gate_up"] = COL
            s["shared_down"] = ROW
        if "shared_gate" in layer:
            s["shared_gate"] = REP
        for b in ("bq", "bk", "bv"):
            if b in layer:
                s[b] = ("tp",)
        return s

    specs = {"embed": REP, "layers": [layer_spec(l) for l in params["layers"]],
             "final_norm": REP}
    if "lm_head" in params:
        specs["lm_head"] = REP
    return specs


def cache_specs_moe() -> dict:
    """(L, B, KV, S, D): KV heads over tp, replicated over ep."""
    kv = (None, None, "tp", None, None)
    return {"k": kv, "v": kv, "pos": REP}


def shard_params_moe(params, mesh: MoeMesh):
    """The rank's experts and tp slices of every parameter, on its device."""
    return tpmod.shard_params(params, mesh, specs=param_specs_moe(params))


def shard_cache_moe(cache: KVCache, mesh: MoeMesh) -> KVCache:
    """The rank's KV heads of a global bf16 cache (an int8 cache, as in
    JAX, only on the tp/dp mesh path)."""
    if cache.quantized:
        raise ValueError("int8 KV cache: supported on the tp/dp mesh path only (parallel/tp.py)")
    cs = cache_specs_moe()
    return KVCache(k=tpmod._shard(cache.k, cs["k"], mesh),
                   v=tpmod._shard(cache.v, cs["v"], mesh),
                   pos=tpmod._shard(cache.pos, cs["pos"], mesh))


def ep_model(cfg: ModelConfig, mesh: MoeMesh, params, plain: bool = False) -> Llama:
    """The rank's model: the tp-local config, its shards (shard_params_moe's
    output) localized, wo summed over the tp group, the MoE MLP over every
    rank."""
    check_moe_cfg(cfg, mesh.ep, mesh.tp)
    return Llama(tpmod.local_cfg(cfg, mesh.tp), tpmod._localize_params(params, mesh.tp),
                 plain=plain, tp_group=mesh.tp_group, ep=(mesh.ep_rank, mesh.ep),
                 moe_group=mesh.moe_group)


def make_ep_step(cfg: ModelConfig, mesh: MoeMesh, params,
                 sampler: SamplerConfig = SamplerConfig(), plain: bool = False):
    """(prefill_fn, decode_fn) of the rank's model (ep_model of params,
    shard_params_moe's output), the MoE counterpart of tp.make_tp_step
    (its signatures; the batch replicated over ep):

    prefill_fn(tokens (B, T), cache) -> (last logits (B, V), cache)
    decode_fn(last (B,), cache, seed, steps) -> (tokens (B, steps), cache)"""
    return tpmod.step_fns(ep_model(cfg, mesh, params, plain), tpmod.tp_view(mesh), sampler)


def make_moe_engine_fns(cfg: ModelConfig, mesh: MoeMesh,
                        sampler: SamplerConfig = SamplerConfig()):
    """(prefill_fn, decode_fn) for runtime/engine.InferenceEngine over an ep
    x tp mesh: tp.make_engine_fns's wrapper, the batch slots replicated
    over both axes (every rank prefills and decodes every slot).  The
    engine is given the rank's model (ep_model) and its local cache
    (shard_cache_moe, or KVCache.create(tp.local_cfg(cfg, tp), B, S)).

        mesh = make_moe_mesh(ep=2, tp=2)
        model = ep_model(cfg, mesh, shard_params_moe(params, mesh))
        eng = InferenceEngine(model, max_batch=B, max_len=S,
                              step_fns=make_moe_engine_fns(cfg, mesh),
                              cache=shard_cache_moe(KVCache.create(cfg, B, S), mesh))
    """
    check_moe_cfg(cfg, mesh.ep, mesh.tp)
    return tpmod.make_engine_fns(cfg, tpmod.tp_view(mesh), sampler)
