"""Pipeline parallelism of the port (tmac_tpu_torch/parallel/pp.py) on the
CPU, against the JAX package's make_pp_prefill / make_pp_decode_step and
the single device.

The ranks are CPU processes joined by gloo (tests/torch_ranks.py): a set of
2 (pp 2) and a set of 4 (pp 2 x tp 2), started once for the module; JAX's
pp runs meanwhile in this process on the virtual mesh (impl="pallas").  The
cases mirror tests/test_pp.py: prefill at pp 2 on llama-2-7b and bitnet-3b
scaled(8) (one layer a stage, microbatches of 4 tokens), pp x tp at 2 x 2
(llama-2-7b scaled(4), tp-packed) with a decode step, and the prefill then
4 greedy decode steps at pp 2.

Gates, JAX's own: the last logits within rtol 3e-2, atol 3e-2 (pp x tp:
5e-2 and 0.1) of JAX's pp prefill and of the port's single device (its
prefill in chunks of the microbatch, so that both take the same kernels);
each stage's cache rows (gathered from the ranks) the single device's
layers: layer 0 exactly, layer 1 within the gate but where an int8
activation code flips (tests/test_torch_sp.py's recorded deviation); pos
T, then T + 1; the pp chain's greedy tokens the single-device
decode_loop's (JAX's test holds them equal)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_sp import _close_but_flips
from torch_ranks import Ranks
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.parallel import launch
from tmac_tpu_torch.parallel import pp as ppmod

torch.set_num_threads(2)

RTOL, ATOL = 3e-2, 3e-2
TP_RTOL, TP_ATOL = 5e-2, 0.1
RANK_TIMEOUT = 300
# (preset, scaled, seed, pp, tp, B, T, S, microbatch, decode steps)
RUNS = {
    "llama_pp2": ("llama-2-7b", 8, 0, 2, 1, 2, 16, 32, 4, 0),
    "bitnet_pp2": ("bitnet-3b", 8, 0, 2, 1, 2, 16, 32, 4, 0),
    "chain_pp2": ("llama-2-7b", 8, 1, 2, 1, 1, 8, 32, 4, 4),
    "pp_tp_2x2": ("llama-2-7b", 4, 2, 2, 2, 1, 8, 32, 4, 1),
}
SETS = {2: ("llama_pp2", "bitnet_pp2", "chain_pp2"), 4: ("pp_tp_2x2",)}


def _cfg(preset, scale):
    return get_preset(preset).scaled(scale)


def _tokens(cfg, seed, B, T):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T)))


def _gather_stages(t, mesh):
    """A stage's (Lp, ...) cache rows from every pp rank of this tp slot
    -> (L, ...) on each, in stage order."""
    if mesh.dp_group is None:
        return t
    parts = [torch.zeros_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t.contiguous(), group=mesh.dp_group)
    return torch.cat(parts)


@torch.no_grad()
def rank_main(rank, world, d):
    launch.init("gloo", "cpu", init_method=f"file://{d}/rendezvous", world_size=world,
                rank=rank)
    out = {}
    for name in SETS[world]:
        preset, scale, seed, pp, tp, B, T, S, mb, steps = RUNS[name]
        cfg = _cfg(preset, scale)
        params = init_params(cfg, seed=seed, device="cpu", tp=tp)
        mesh = ppmod.make_pp_tp_mesh(pp, tp, device="cpu")
        tree, specs = ppmod.stack_params_pp(params, pp, tp=tp)
        sparams = ppmod.shard_params_pp(tree, specs, mesh)
        prefill = ppmod.make_pp_prefill(cfg, mesh, sparams, chunk=mb)
        decode = ppmod.make_pp_decode_step(cfg, mesh, sparams)
        cache = ppmod.shard_cache_pp(KVCache.create(cfg, B, S, device="cpu"), mesh)
        toks = _tokens(cfg, seed, B, T)
        last, cache = prefill(toks, cache)
        rec = {"last": last, "pos": cache.pos.clone(), "stage_layers": len(prefill.model.layers),
               "k": _gather_stages(cache.k[:, :, :, :T].clone(), mesh)}
        got = [torch.argmax(last, -1)]
        step_logits = []
        for _ in range(steps):
            lg, cache = decode(got[-1].to(torch.int32), cache)
            step_logits.append(lg)
            got.append(torch.argmax(lg, -1))
        rec.update(toks=torch.stack(got, 1), step_logits=step_logits, pos_after=cache.pos.clone())
        if rank == 0:
            # the single device at the microbatch's rows
            ref, rc = Llama(cfg, params), KVCache.create(cfg, B, S, device="cpu")
            for off in range(0, T, mb):
                rl, rc = ref(toks[:, off:off + mb], rc)
            rec.update(ref_last=rl[:, -1], ref_k=rc.k[:, :, :, :T].clone())
            if steps and tp == 1:
                from tmac_tpu_torch.runtime.generate import decode_loop
                first = torch.argmax(rl[:, -1], -1).to(torch.int32)
                rec["ref_toks"] = torch.cat([first[:, None].long(),
                                             decode_loop(ref, first, rc, steps)[0].long()], 1)
        out[name] = rec
    launch.shutdown()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks("test_torch_pp", SETS, tmp_path_factory, RANK_TIMEOUT)
    yield r
    r.kill()


def _jax_pp(name):
    """JAX's make_pp_prefill (impl="pallas") on the virtual mesh -> the last
    logits."""
    import jax.numpy as jnp
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import KVCache as JKV
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import pp as jpp
    preset, scale, seed, pp, tp, B, T, S, mb, steps = RUNS[name]
    cfg = jget(preset).scaled(scale)
    params = jinit(cfg, seed=seed, tp=tp)
    mesh = jpp.make_pp_tp_mesh(pp, tp) if tp > 1 else jpp.make_pp_mesh(pp)
    tree, specs = jpp.stack_params_pp(params, pp, tp=tp)
    sparams = jpp.shard_params_pp(tree, specs, mesh)
    cache = jpp.shard_cache_pp(JKV.create(cfg, B, S), mesh)
    pf = jpp.make_pp_prefill(cfg, mesh, impl="pallas", chunk=mb,
                             specs=specs if tp > 1 else None)
    last, _ = pf(sparams, jnp.asarray(_tokens(_cfg(preset, scale), seed, B, T).numpy()), cache)
    return np.asarray(last, np.float32)


@pytest.mark.parametrize("name", ["llama_pp2", "bitnet_pp2"])
def test_pp_prefill_matches_single_device(ranks, name):
    """pp 2, one layer a stage, microbatches of 4: the last logits within
    JAX's gate of JAX's pp prefill and of the single device; the stages'
    cache rows the single device's (layer 0 exactly); pos T."""
    preset, scale, seed, pp, tp, B, T, S, mb, steps = RUNS[name]
    rec = ranks[2][name]
    last = rec["last"].numpy()
    np.testing.assert_allclose(last, _jax_pp(name), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(last, rec["ref_last"].numpy(), rtol=RTOL, atol=ATOL)
    assert rec["stage_layers"] == _cfg(preset, scale).num_layers // pp
    assert torch.equal(rec["k"][0], rec["ref_k"][0])
    _close_but_flips(rec["k"].float().numpy(), rec["ref_k"].float().numpy(), RTOL, ATOL)
    assert (rec["pos"] == T).all()


def test_pp_tp_composition(ranks):
    """pp 2 x tp 2 (stage-internal Megatron shards of tp-packed weights):
    the last logits within JAX's pp x tp gate of JAX's and of the single
    device; a decode step's logits finite, pos T + 1."""
    preset, scale, seed, pp, tp, B, T, S, mb, steps = RUNS["pp_tp_2x2"]
    rec = ranks[4]["pp_tp_2x2"]
    last = rec["last"].numpy()
    np.testing.assert_allclose(last, _jax_pp("pp_tp_2x2"), rtol=TP_RTOL, atol=TP_ATOL)
    np.testing.assert_allclose(last, rec["ref_last"].numpy(), rtol=TP_RTOL, atol=TP_ATOL)
    assert all(bool(torch.isfinite(lg).all()) for lg in rec["step_logits"])
    assert (rec["pos"] == T).all() and (rec["pos_after"] == T + 1).all()


def test_pp_prefill_decode_chain(ranks):
    """pp prefill, then 4 greedy pp decode steps: the single-device
    decode_loop's tokens (JAX's test holds them equal)."""
    rec = ranks[2]["chain_pp2"]
    assert torch.equal(rec["toks"].long(), rec["ref_toks"])


def test_stack_params_pp_matches_jax():
    """stack_params_pp: JAX's specs as tuples (pp, and pp x tp), the stage
    leaves' shapes JAX's; the port's stage tree carried from JAX's numpy
    leaves (convert.from_jax.params_from_numpy's stage form) equals its
    own byte for byte; MoE and a layer count pp does not divide are
    refused."""
    import jax
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import pp as jpp
    from tmac_tpu_torch.convert.from_jax import pp_params_from_numpy
    for tp in (1, 2):
        cfg = _cfg("llama-2-7b", 4)
        jtree, jspecs = jpp.stack_params_pp(jinit(jget("llama-2-7b").scaled(4), seed=0, tp=tp),
                                            2, tp=tp)
        tree, specs = ppmod.stack_params_pp(init_params(cfg, seed=0, device="cpu", tp=tp), 2,
                                            tp=tp)
        assert {n: tuple(v) for n, v in jspecs["stages"].items()} == specs["stages"]
        assert all(specs[k] == () for k in specs if k != "stages")
        carried = pp_params_from_numpy(jax.tree.map(np.asarray, jtree), cfg, device="cpu")
        for n, leaf in tree["stages"].items():
            got = carried["stages"][n]
            if hasattr(leaf, "packed"):
                assert tuple(leaf.packed.shape) == tuple(jtree["stages"][n].packed.shape)
                for f in ("packed", "scales", "sub"):
                    assert torch.equal(getattr(got, f), getattr(leaf, f)), (n, f)
                assert (got.k_shards, got.m_shards, tuple(got.shape)) == \
                    (leaf.k_shards, leaf.m_shards, tuple(leaf.shape))
            else:
                assert torch.equal(got, leaf), n
    with pytest.raises(ValueError, match="MoE"):
        ppmod.stack_params_pp(init_params(_cfg("mixtral-8x7b", 8), seed=0, device="cpu"), 2)
    with pytest.raises(ValueError, match="divide"):
        ppmod.stack_params_pp(init_params(_cfg("llama-2-7b", 8), seed=0, device="cpu"), 3)
    with pytest.raises(ValueError, match="int8"):
        ppmod.shard_cache_pp(KVCache.create(_cfg("llama-2-7b", 8), 1, 8, device="cpu",
                                            quant=True), None)
