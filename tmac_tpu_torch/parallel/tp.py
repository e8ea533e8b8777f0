"""Tensor and data parallelism over torch.distributed process groups.

The port of ``tmac_tpu/parallel/tp.py``.  The JAX package shards every
layer Megatron-style over a (dp, tp) ``jax.sharding.Mesh`` and runs the
forward inside one ``shard_map``; here each rank is a process (parallel/
launch.py) that holds only its own shards and runs the model's forward on
them, the tp group summing the row-parallel partial outputs:

  * column-parallel (M sharded over tp): wq, wk, wv, gate, up (and the
    experts' gate_up, the shared expert's): a rank holds its heads and
    its slice of the FFN;
  * row-parallel (K sharded over tp): wo, down (the experts' down, the
    shared expert's): packed with k_shards=tp, so a rank's packed rows are
    the packing of its K-chunk, padded on their own;
  * an all_reduce over the tp group after wo and after down (two a layer,
    models/llama.py's ``_tp_sum``);
  * the KV cache sharded over KV heads (tp) and batch slots (dp).

A mesh is a dp x tp grid of ranks, rank = d * tp + t, with one tp group
for each d and one dp group for each t.  Every rank runs the replicated
parts (embedding, final norm, head, sampling), as shard_map does.

Collectives go through the backend the ranks were joined with: gloo for
CPU ranks and for several ranks on one card (gloo's all_reduce takes CUDA
tensors; NCCL takes one rank a device), nccl for one card a rank.  The
data-parallel gathers are written as all_reduce sums (gloo has no CUDA
all_gather).  Decode under a group runs eagerly: a CUDA graph cannot
capture a gloo collective (its copies through the host), and an NCCL
collective's capture is not tried here, so the step's launch cost stays
with the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
import torch.distributed as dist

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.runtime.sampling import CounterStreams, SamplerConfig, sample

COL = (None, "tp")   # shard M (output features)
ROW = ("tp", None)   # shard K (packed rows, scale groups)
REP = ()


@dataclasses.dataclass
class Mesh:
    """This rank's place in a dp x tp grid: its device and the groups it
    belongs to (None where that axis has one rank)."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    tp_group: Any = None
    dp_group: Any = None

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp


def make_mesh(tp: int, dp: int = 1, device=None) -> Mesh:
    """The dp x tp mesh over the joined ranks (launch.init), every rank
    calling it (new_group is collective).  device: this rank's device
    (launch.device() when None).  A world of one rank needs no group."""
    from tmac_tpu_torch.parallel import launch
    device = torch.device(device) if device is not None else launch.device()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != dp * tp:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks, not {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = Mesh(dp=dp, tp=tp, rank=rank, device=device)
    if world == 1:
        return mesh
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)])
        if d == mesh.dp_rank and tp > 1:
            mesh.tp_group = g
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if t == mesh.tp_rank and dp > 1:
            mesh.dp_group = g
    return mesh


def check_cfg(cfg: ModelConfig, tp: int) -> None:
    """Raise where tp does not split the model: heads, KV heads and widths
    divisible by tp; row-parallel scale groups whole on each shard."""
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(f"tp {tp} must divide num_heads {cfg.num_heads} and "
                         f"num_kv_heads {cfg.num_kv_heads}")
    if cfg.q_dim % tp or cfg.kv_dim % tp or cfg.hidden_size % tp:
        raise ValueError(f"tp {tp} must divide q_dim, kv_dim and hidden_size")
    gs = cfg.quant.group_size
    if gs != -1:
        if (cfg.q_dim // tp) % gs:
            raise ValueError(f"q_dim/tp ({cfg.q_dim}/{tp}) must be a multiple of "
                             f"group_size {gs}")
        if cfg.num_experts > 0 and tp > 1 and (cfg.moe_intermediate_size // tp) % gs:
            raise ValueError(f"moe_intermediate/tp ({cfg.moe_intermediate_size}/{tp}) "
                             f"must be a multiple of group_size {gs}")


def local_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The per-rank model config under tp-way tensor parallelism."""
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp,
        num_kv_heads=cfg.num_kv_heads // tp,
        intermediate_size=cfg.intermediate_size // tp,
        moe_intermediate_size=cfg.moe_intermediate_size // tp,
        moe_shared_intermediate_size=cfg.moe_shared_intermediate_size // tp,
    )


def param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The partition spec tree (prefix form, one spec a QuantizedTensor)
    of an init_params tree: for each array axis "tp" where it is split
    over the tp group, None where not; () replicated."""
    def layer_spec(layer):
        s = {"attn_norm": REP, "mlp_norm": REP, "wqkv": COL, "wo": ROW}
        if "experts_gate_up" in layer:
            # the stacks carry a leading E axis; tp splits each expert as
            # the dense MLP (parallel/ep.py's specs shard E too)
            s["moe_router"] = REP
            s["experts_gate_up"] = (None, None, "tp")
            s["experts_down"] = (None, "tp", None)
            if "shared_gate_up" in layer:
                s["shared_gate_up"] = COL
                s["shared_down"] = ROW
            if "shared_gate" in layer:
                s["shared_gate"] = REP
        else:
            s["gate_up"] = COL
            s["down"] = ROW
        for b in ("bq", "bk", "bv"):
            if b in layer:
                s[b] = ("tp",)
        return s

    specs = {"embed": REP, "layers": [layer_spec(l) for l in params["layers"]],
             "final_norm": REP}
    if "lm_head" in params:
        specs["lm_head"] = REP
    return specs


def cache_specs(kv_quant: bool = False) -> Dict[str, Any]:
    """The cache's specs: (L, B, KV, S, D) with batch slots over dp and KV
    heads over tp; the int8 cache's scales (L, B, KV, S) alike."""
    kv = (None, "dp", "tp", None, None)
    sc = (None, "dp", "tp", None) if kv_quant else None
    return {"k": kv, "v": kv, "pos": ("dp",), "k_scale": sc, "v_scale": sc}


def _localize_params(params, tp: int):
    """The shards' QuantizedTensor meta made local (k_shards or m_shards
    1, the shard's shape): the arrays already are the rank's."""
    if tp == 1:
        return params

    def fix_layer(layer):
        out = dict(layer)
        for name in ("wqkv", "gate_up", "experts_gate_up", "shared_gate_up"):
            if name in layer:
                out[name] = layer[name].localized(tp, axis=1)
        for name in ("wo", "down", "experts_down", "shared_down"):
            if name in layer:
                out[name] = layer[name].localized(tp, axis=0)
        return out

    return {**params, "layers": [fix_layer(l) for l in params["layers"]]}


def _shard(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's part of t under spec, copied to the mesh's device (a
    copy of its own, so the whole can be freed).  "ep", "sp" and "pp" name
    the outer axis of an ep, sp or pp x tp mesh (parallel/ep.py, sp.py,
    pp.py), which is the grid's dp."""
    for axis, name in enumerate(spec):
        if name in ("ep", "sp", "pp"):
            name = "dp"
        if name in ("tp", "dp"):
            n = mesh.tp if name == "tp" else mesh.dp
            r = mesh.tp_rank if name == "tp" else mesh.dp_rank
            if t.shape[axis] % n:
                raise ValueError(f"axis {axis} of {tuple(t.shape)} does not split {n} ways")
            w = t.shape[axis] // n
            t = t.narrow(axis, r * w, w)
    return t.to(mesh.device, copy=True).contiguous()


def shard_params(params, mesh: Mesh, specs=None):
    """The rank's slice of every parameter under param_specs (or an
    explicit spec tree), on the mesh's device; a QuantizedTensor keeps its
    global meta (tp_model localizes it), as NamedSharding leaves it."""
    if specs is None:
        specs = param_specs(params)

    def put(tree, spec):
        if isinstance(tree, QuantizedTensor):
            hi = _shard(tree.packed_hi, spec, mesh) if tree.packed_hi is not None else None
            return dataclasses.replace(
                tree, packed=_shard(tree.packed, spec, mesh), packed_hi=hi,
                scales=_shard(tree.scales, spec, mesh), sub=_shard(tree.sub, spec, mesh))
        if isinstance(tree, dict):
            return {k: put(v, spec[k] if isinstance(spec, dict) else spec)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [put(v, s) for v, s in zip(tree, spec)]
        return _shard(tree, spec, mesh)

    return put(params, specs)


def shard_cache(cache: KVCache, mesh: Mesh) -> KVCache:
    """The rank's slots and KV heads of a global cache."""
    cs = cache_specs(kv_quant=cache.quantized)
    put = lambda a, sp: _shard(a, sp, mesh) if a is not None else None  # noqa: E731
    return KVCache(k=put(cache.k, cs["k"]), v=put(cache.v, cs["v"]),
                   pos=put(cache.pos, cs["pos"]), k_scale=put(cache.k_scale, cs["k_scale"]),
                   v_scale=put(cache.v_scale, cs["v_scale"]))


def tp_view(mesh: Mesh) -> Mesh:
    """The mesh as one of its tp groups sees it: dp 1, this rank's tp
    group and tp rank (an ep, sp or pp grid's tp groups each run the whole
    batch)."""
    return Mesh(dp=1, tp=mesh.tp, rank=mesh.tp_rank, device=mesh.device,
                tp_group=mesh.tp_group)


def tp_model(cfg: ModelConfig, mesh: Mesh, params, plain: bool = False) -> Llama:
    """The rank's model: the local config, its shards (shard_params'
    output) localized, the mesh's tp group summing wo's and down's
    outputs."""
    check_cfg(cfg, mesh.tp)
    return Llama(local_cfg(cfg, mesh.tp), _localize_params(params, mesh.tp), plain=plain,
                 tp_group=mesh.tp_group)


def dp_gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows (b, ...) of every dp group, in group order -> (dp * b, ...) on
    every rank: an all_reduce sum of each group's rows placed in zeros
    (exact: one nonzero term a row)."""
    if mesh.dp_group is None:
        return t
    out = torch.zeros((mesh.dp * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    out[mesh.dp_rank * t.shape[0]:(mesh.dp_rank + 1) * t.shape[0]] = t
    dist.all_reduce(out, group=mesh.dp_group)
    return out


def _rows(t, mesh: Mesh, bl: int):
    """This dp group's rows [d * bl, (d + 1) * bl) of a (B, ...) tensor."""
    return None if t is None else t[mesh.dp_rank * bl:(mesh.dp_rank + 1) * bl]


def make_tp_step(cfg: ModelConfig, mesh: Mesh, params,
                 sampler: SamplerConfig = SamplerConfig(), plain: bool = False):
    """(prefill_fn, decode_fn) of the rank's model (tp_model of params,
    shard_params' output), each with it as ``.model``:

    prefill_fn(tokens (B, T), cache) -> (last logits (B, V), cache)
    decode_fn(last (B,), cache, seed, steps) -> (tokens (B, steps), cache),
        with return_logits=True also the logits (B, steps, V) each token
        was drawn from

    tokens, last, logits and the output tokens are the global batch on
    every rank (a dp group takes its B / dp rows); cache is the rank's
    (shard_cache).  decode draws row b's step i from CounterStreams(seed +
    b, i) (greedy by default)."""
    return step_fns(tp_model(cfg, mesh, params, plain), mesh, sampler)


def step_fns(model: Llama, mesh: Mesh, sampler: SamplerConfig = SamplerConfig()):
    """make_tp_step's (prefill_fn, decode_fn) around a rank's model: the
    global batch in and out, each dp group's B / dp rows run by its ranks
    (every row by every rank where mesh.dp is 1)."""

    @torch.no_grad()
    def prefill_fn(tokens: torch.Tensor, cache: KVCache):
        bl = tokens.shape[0] // mesh.dp
        logits, cache = model(_rows(tokens, mesh, bl).to(mesh.device), cache)
        return dp_gather(logits[:, -1, :].contiguous(), mesh), cache

    @torch.no_grad()
    def decode_fn(last: torch.Tensor, cache: KVCache, seed: int, steps: int,
                  return_logits: bool = False):
        bl = last.shape[0] // mesh.dp
        tok = _rows(last, mesh, bl).to(mesh.device)
        rows = torch.arange(bl, device=mesh.device) + mesh.dp_rank * bl
        out, seen = [], []
        for i in range(steps):
            logits, cache = model(tok[:, None], cache)
            streams = CounterStreams(rows + seed, torch.full_like(rows, i))
            tok = sample(logits[:, -1, :], streams, sampler)
            out.append(tok)
            if return_logits:
                seen.append(logits[:, -1, :])
        toks = dp_gather(torch.stack(out, 1).contiguous(), mesh)
        if return_logits:
            return toks, cache, dp_gather(torch.stack(seen, 1).contiguous(), mesh)
        return toks, cache

    prefill_fn.model = decode_fn.model = model
    return prefill_fn, decode_fn


def make_engine_fns(cfg: ModelConfig, mesh: Mesh,
                    sampler: SamplerConfig = SamplerConfig()):
    """(prefill_fn, decode_fn) for runtime/engine.InferenceEngine's
    step_fns over a dp x tp mesh; the engine is given the rank's model
    (tp_model) and its local cache (B / dp slots: shard_cache, or
    KVCache.create(local_cfg(cfg, tp), B // dp, S)), every rank running
    the same engine program on the same requests.

    tp shards every layer; dp > 1 shards the batch slots: dp group d owns
    slots [d * B / dp, (d + 1) * B / dp) and decodes them locally, its
    tokens gathered over dp after each chunk.  Slot prefill is addressed
    globally: only the owning group runs it and commits its cache rows,
    and its last logits reach every group through one sum over dp (the
    others give zeros).  A slot's draws are its own CounterStreams row, so
    the dp groups' draws differ as their slots do."""
    from tmac_tpu_torch.runtime.engine import decode_chunk, prefill_slot
    check_cfg(cfg, mesh.tp)

    @torch.no_grad()
    def prefill_fn(model, tokens, true_len, cache, slot, start_pos):
        bl = cache.k.shape[1]
        ls = slot - mesh.dp_rank * bl
        if 0 <= ls < bl:
            last, cache = prefill_slot(model, tokens, true_len, cache, ls, start_pos)
            last = last.float().contiguous()
        else:
            last = torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=mesh.device)
        if mesh.dp_group is not None:
            dist.all_reduce(last, group=mesh.dp_group)
        return last, cache

    @torch.no_grad()
    def decode_fn(model, last, cache, steps, streams, active, eos_ids, remaining,
                  state=None, counts=None):
        bl = cache.k.shape[1]
        part = functools.partial(_rows, mesh=mesh, bl=bl)
        st = None if state is None else type(state)(
            **{f.name: part(getattr(state, f.name)) for f in dataclasses.fields(state)})
        r = decode_chunk(model, part(last), cache, steps,
                         CounterStreams(part(streams.seed), part(streams.index)),
                         part(active), part(eos_ids), part(remaining), state=st,
                         counts=None if counts is None else part(counts).contiguous(),
                         sampler=sampler)
        toks = dp_gather(r[0].contiguous(), mesh)
        if counts is None:
            return toks, r[1]
        return toks, r[1], dp_gather(r[2], mesh)

    return prefill_fn, decode_fn

