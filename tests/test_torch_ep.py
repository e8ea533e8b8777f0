"""Expert parallelism of the port (tmac_tpu_torch/parallel/ep.py,
models/moe.py's moe_mlp(ep_axis=), models/llama.py's sum over the ep x tp
ranks) on the CPU, against the JAX package.

The ranks are CPU processes joined by gloo (tests/torch_ranks.py), one set
of 4 started for the module: the tiny Mixtral of tests/test_moe.py (8
experts, top 2) at ep 4 and at ep 2 x tp 2, the tiny Qwen2-MoE (a gated
shared expert, softmax over all experts) at ep 2 x tp 2, and the engine
over ep 2 x tp 2 (make_moe_engine_fns), as tests/test_moe.py's ep cases do
on 8 devices (ep 8 and ep 4 x tp 2 need 8 ranks; 4 is this module's size).
JAX's make_ep_step runs meanwhile on the virtual mesh (impl="pallas").

Gates, JAX's own (tests/test_moe.py): the prefill's last logits within
rtol 5e-2, atol 0.1 of JAX's make_ep_step and of the single-device
forward; along the ep path's greedy tokens the single device's
teacher-forced argmax at 75% of the steps at least; the engine's requests
complete in range and its slot prefill within rtol 5e-2, atol 0.08 of the
single-device prefill_slot.  moe_mlp(ep_axis=(i, n)) on rank i's experts
equals JAX's moe_mlp under shard_map on device i of an ep mesh, each
device's partial output (dense and dispatch forms, the shared expert's
1 / n share), within the MoE tests' NMSE gate (1e-5)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_ranks import REPO, Ranks
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.parallel import ep as epmod
from tmac_tpu_torch.parallel import launch
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

RTOL, ATOL = 5e-2, 0.1
ENGINE_RTOL, ENGINE_ATOL = 5e-2, 0.08
MOE_NMSE = 1e-5
RANK_TIMEOUT = 300
# (config, seed, ep, tp, B, T, decode steps)
RUNS = {
    "mixtral_ep4": ("moe", 0, 4, 1, 2, 4, 4),
    "mixtral_ep2_tp2": ("moe", 0, 2, 2, 2, 4, 4),
    "qwen2moe_ep2_tp2": ("qwen2moe", 22, 2, 2, 1, 4, 3),
}
SETS = {4: tuple(RUNS)}
ENGINE_PROMPTS, ENGINE_LENS = ([1, 2, 3], [9, 8]), (6, 5)


def _cfg(kind, get=get_preset):
    """tests/test_moe.py's tiny configs (8 experts, top 2), from either
    package's presets."""
    if kind == "moe":
        return dataclasses.replace(get("mixtral-8x7b").scaled(16), num_experts=8,
                                   num_experts_per_tok=2, num_kv_heads=2,
                                   moe_intermediate_size=512)
    return dataclasses.replace(get("qwen2-moe-a14b").scaled(16), num_experts=8,
                               num_experts_per_tok=2, num_kv_heads=2,
                               moe_intermediate_size=512, moe_shared_intermediate_size=512)


def _tokens(cfg, seed, B, T):
    return torch.from_numpy(np.random.default_rng(seed + 10).integers(0, cfg.vocab_size, (B, T)))


def _forced(model, cfg, toks, got, S):
    """model's last logits of the prompt, then along got[:, :-1] a token a
    step -> (B, steps, V)."""
    lg, cache = model(toks, KVCache.create(cfg, toks.shape[0], S, device="cpu"))
    out = [lg[:, -1]]
    for t in range(got.shape[1] - 1):
        lg, cache = model(got[:, t:t + 1].long(), cache)
        out.append(lg[:, -1])
    return torch.stack(out, 1)


@torch.no_grad()
def rank_main(rank, world, d):
    launch.init("gloo", "cpu", init_method=f"file://{d}/rendezvous", world_size=world,
                rank=rank)
    out = {}
    for name, (kind, seed, ep, tp, B, T, steps) in RUNS.items():
        cfg = _cfg(kind)
        params = init_params(cfg, seed=seed, device="cpu", tp=tp)
        mesh = epmod.make_moe_mesh(ep, tp, device="cpu")
        prefill, decode = epmod.make_ep_step(cfg, mesh, epmod.shard_params_moe(params, mesh))
        cache = epmod.shard_cache_moe(KVCache.create(cfg, B, T + steps, device="cpu"), mesh)
        toks = _tokens(cfg, seed, B, T)
        last, cache = prefill(toks, cache)
        first = torch.argmax(last, -1).to(torch.int32)
        rest, _ = decode(first, cache, 0, steps - 1)
        got = torch.cat([first[:, None], rest], 1)
        rec = {"last": last, "toks": got,
               "local_experts": prefill.model.layers[0].experts_gate_up.packed.shape[0]}
        if rank == 0:
            rec["ref"] = _forced(Llama(cfg, params), cfg, toks, got, T + steps)
        out[name] = rec
    # the engine over ep 2 x tp 2
    cfg = _cfg("moe")
    params = init_params(cfg, seed=0, device="cpu", tp=2)
    mesh = epmod.make_moe_mesh(2, 2, device="cpu")
    model = epmod.ep_model(cfg, mesh, epmod.shard_params_moe(params, mesh))
    fns = epmod.make_moe_engine_fns(cfg, mesh)
    from tmac_tpu_torch.runtime.engine import InferenceEngine, prefill_slot
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4, step_fns=fns,
                          cache=epmod.shard_cache_moe(KVCache.create(cfg, 2, 64, device="cpu"),
                                                      mesh))
    uids = [eng.submit(p, max_new_tokens=n) for p, n in zip(ENGINE_PROMPTS, ENGINE_LENS)]
    res = eng.run()
    toks = torch.zeros((1, 16), dtype=torch.int64)
    toks[0, :3] = torch.tensor(ENGINE_PROMPTS[0])
    out["engine"] = [res[u] for u in uids]
    out["engine_prefill"] = fns[0](
        model, toks, 3, epmod.shard_cache_moe(KVCache.create(cfg, 2, 64, device="cpu"), mesh),
        0, 0)[0]
    if rank == 0:
        out["engine_prefill_ref"] = prefill_slot(
            Llama(cfg, params), toks, 3, KVCache.create(cfg, 2, 64, device="cpu"), 0, 0)[0]
    launch.shutdown()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks("test_torch_ep", SETS, tmp_path_factory, RANK_TIMEOUT)
    yield r
    r.kill()


def _jax_ep_last(name):
    """JAX's make_ep_step prefill (impl="pallas") on the virtual mesh -> the
    last logits."""
    import jax.numpy as jnp
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import KVCache as JKV
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import ep as jep
    from tmac_tpu.runtime.sampling import SamplerConfig as JSC
    kind, seed, ep, tp, B, T, steps = RUNS[name]
    cfg = _cfg(kind, jget)
    params = jinit(cfg, seed=seed, tp=tp)
    mesh = jep.make_moe_mesh(ep=ep, tp=tp)
    sparams = jep.shard_params_moe(params, mesh)
    cache = jep.shard_cache_moe(JKV.create(cfg, B, T + steps), mesh)
    pf, _ = jep.make_ep_step(cfg, mesh, params, JSC(), impl="pallas")
    last, _ = pf(sparams, jnp.asarray(_tokens(_cfg(kind), seed, B, T).numpy()), cache)
    return np.asarray(last, np.float32)


@pytest.mark.parametrize("name", list(RUNS))
def test_ep_matches_jax_and_single_device(ranks, name):
    """ep (x tp) prefill's last logits within JAX's gate of JAX's make_ep_step
    and of the single-device forward on the same weights; each rank held E /
    ep experts; along the ep path's greedy tokens the single device's
    teacher-forced argmax at 75% of the steps at least (qwen2-moe: the
    shared expert's 1 / ep share survives the sum at every step)."""
    kind, seed, ep, tp, B, T, steps = RUNS[name]
    rec = ranks[4][name]
    last = rec["last"].numpy()
    np.testing.assert_allclose(last, _jax_ep_last(name), rtol=RTOL, atol=ATOL)
    ref = rec["ref"].float().numpy()
    np.testing.assert_allclose(last, ref[:, 0], rtol=RTOL, atol=ATOL)
    assert (ref.argmax(-1) == rec["toks"].numpy()).mean() >= 0.75
    assert rec["local_experts"] == _cfg(kind).num_experts // ep
    assert rec["toks"].shape == (B, steps)


def test_engine_over_ep_mesh(ranks):
    """The engine over ep 2 x tp 2 (make_moe_engine_fns): both requests
    complete with tokens in range; a slot prefill's logits within JAX's
    engine gate of the single-device prefill_slot."""
    rec = ranks[4]
    cfg = _cfg("moe")
    for toks, n in zip(rec["engine"], ENGINE_LENS):
        assert len(toks) == n and all(0 <= t < cfg.vocab_size for t in toks)
    np.testing.assert_allclose(rec["engine_prefill"].numpy(),
                               rec["engine_prefill_ref"].float().numpy(),
                               rtol=ENGINE_RTOL, atol=ENGINE_ATOL)


@pytest.mark.parametrize("kind,T", [("moe", 4), ("qwen2moe", 4), ("qwen2moe", 64)])
def test_moe_mlp_ep_axis_matches_jax(kind, T):
    """moe_mlp(ep_axis=(i, 4)) on rank i's slice of the stacks (the combine
    weights sliced to its 2 experts; T 4 the dense form, 64 dispatch; the
    shared expert divided by 4) against JAX's moe_mlp(ep_axis="ep") under
    shard_map on device i of a 4-device ep mesh (impl="pallas"), each
    device's partial output; their sum the single-device moe_mlp."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.models.moe import moe_mlp as jmoe
    from tmac_tpu.parallel import ep as jep
    from tmac_tpu.parallel.tp import shard_map
    from tmac_tpu_torch.convert.from_jax import params_from_numpy
    from tmac_tpu_torch.models import moe as tm
    n = 4
    jcfg, cfg = dataclasses.replace(_cfg(kind, jget), num_layers=1), \
        dataclasses.replace(_cfg(kind), num_layers=1)
    jparams = jinit(jcfg, seed=5)
    layer = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")["layers"][0]
    x = np.random.default_rng(T).standard_normal((1, T, cfg.hidden_size)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    mesh = jep.make_moe_mesh(ep=n, tp=1)
    spec = {k: P() for k in jparams["layers"][0]}
    spec.update(experts_gate_up=P("ep"), experts_down=P("ep"))
    f = shard_map(lambda lay, xx: jmoe(xx, lay, jcfg, jcfg.quant.mode, "pallas",
                                       ep_axis="ep"),
                  mesh, in_specs=(spec, P()), out_specs=P("ep"))
    want = np.asarray(jax.jit(f)(jparams["layers"][0], xj), np.float32)    # (n, T, H)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    parts = []
    for i in range(n):
        E = cfg.num_experts // n
        mine = dict(layer)
        for name in ("experts_gate_up", "experts_down"):
            qt = layer[name]
            mine[name] = dataclasses.replace(
                qt, packed=qt.packed[i * E:(i + 1) * E], scales=qt.scales[i * E:(i + 1) * E],
                sub=qt.sub[i * E:(i + 1) * E])
        got = tm.moe_mlp(xt, mine, cfg, ep_axis=(i, n))
        parts.append(got.float())
        assert nmse(want[i], got.float().numpy()[0]) <= MOE_NMSE, i
    whole = tm.moe_mlp(xt, layer, cfg, moe_impl="dense" if T < 64 else "dispatch").float()
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), rtol=2e-2, atol=2e-2)


def test_moe_mesh_checks_and_specs_match_jax():
    """check_moe_cfg refuses what JAX's asserts on; param_specs_moe and
    cache_specs_moe are JAX's specs as tuples."""
    from tmac_tpu.models.config import get_preset as jget
    from tmac_tpu.models.llama import init_params as jinit
    from tmac_tpu.parallel import ep as jep
    for kind in ("moe", "qwen2moe"):
        js = jep.param_specs_moe(jinit(dataclasses.replace(_cfg(kind, jget), num_layers=1)))
        ps = epmod.param_specs_moe(init_params(dataclasses.replace(_cfg(kind), num_layers=1),
                                               device="cpu"))
        assert {k: tuple(v) for k, v in js["layers"][0].items()} == ps["layers"][0]
    jc = jep.cache_specs_moe()
    assert tuple(jc.k) == epmod.cache_specs_moe()["k"]
    for cfg, ep, tp in ((get_preset("llama-2-7b"), 1, 1), (_cfg("moe"), 3, 1),
                        (_cfg("moe"), 2, 3)):
        with pytest.raises(ValueError):
            epmod.check_moe_cfg(cfg, ep, tp)
    epmod.check_moe_cfg(_cfg("moe"), 4, 2)


def _chip_smoke():
    import sys
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def _plant(monkeypatch, fault):
    """Plant an ep fault in models/moe.py's moe_mlp under ep_axis: the combine
    weights sliced at rank 0's experts on every rank ("wrong_slice"), or
    the shared expert's whole output on every rank ("shared_undivided":
    the rank's 1 / n share and n - 1 more, each from moe_mlp with no token
    routed)."""
    from tmac_tpu_torch.models import moe as tm
    real = tm.moe_mlp

    def faulty(x, layer, cfg, mode=None, act_gs=0, ep_axis=None, **kw):
        if ep_axis is None:
            return real(x, layer, cfg, mode, act_gs=act_gs, **kw)
        if fault == "wrong_slice":
            return real(x, layer, cfg, mode, act_gs=act_gs, ep_axis=(0, ep_axis[1]), **kw)
        shared = real(x, layer, cfg, mode, act_gs=act_gs, ep_axis=ep_axis,
                      **dict(kw, valid=torch.zeros(x.shape[:2], dtype=torch.bool)))
        out = real(x, layer, cfg, mode, act_gs=act_gs, ep_axis=ep_axis, **kw)
        return out + shared * (ep_axis[1] - 1)
    if fault is not None:
        monkeypatch.setattr(tm, "moe_mlp", faulty)


def _rank_slice(layer, i, n):
    """Rank i's experts of the stacks, of n."""
    mine = dict(layer)
    for name in ("experts_gate_up", "experts_down"):
        qt, E = layer[name], layer[name].packed.shape[0] // n
        mine[name] = dataclasses.replace(
            qt, packed=qt.packed[i * E:(i + 1) * E], scales=qt.scales[i * E:(i + 1) * E],
            sub=qt.sub[i * E:(i + 1) * E])
    return mine


@pytest.mark.parametrize("fault", [None, "shared_undivided", "wrong_slice"])
@pytest.mark.parametrize("T", [1, 64], ids=["dense", "dispatch"])
def test_ep_layer_gate_catches_planted_faults(monkeypatch, fault, T):
    """chip_smoke.py's ep layer check (ep_layer_gate: one MoE layer summed
    over the ranks within 2 bf16 ulps of the single device's moe_mlp) on
    the tiny Qwen2-MoE (a gated shared expert), two ranks' partials in one
    process (moe_mlp(ep_axis=)), the dense form at one row and dispatch at
    64: it holds for the port's ep and fails for each planted fault (the
    combine weights sliced at the wrong index; the shared expert not
    divided by the ep size)."""
    from tmac_tpu_torch.models import moe as tm
    cs = _chip_smoke()
    cfg = dataclasses.replace(_cfg("qwen2moe"), num_layers=1)
    layer = Llama(cfg, init_params(cfg, seed=3, device="cpu")).layers[0].moe_layer()
    x = torch.from_numpy(np.random.default_rng(T).standard_normal(
        (1, T, cfg.hidden_size)).astype(np.float32)).to(torch.bfloat16)
    want = tm.moe_mlp(x, layer, cfg, moe_impl="dense" if T == 1 else "dispatch")
    _plant(monkeypatch, fault)
    parts = [tm.moe_mlp(x, _rank_slice(layer, i, 2), cfg, ep_axis=(i, 2)) for i in range(2)]
    gate = cs.ep_layer_gate(want.float().numpy(), (parts[0] + parts[1]).float().numpy(),
                            [p.float().numpy() for p in parts])
    assert gate["held"] == (fault is None), gate


def test_ep_noise_floor_gate(monkeypatch):
    """chip_smoke.py's gate of ep's logits against the single device
    (single_gate), on the CPU at 4 layers of mixtral-8x7b scaled(8) (the
    expert FFN 512): the two ranks' computation in one process
    (ep_partial_sums, bit for bit to the ranks on the card) teacher-forced
    along its own greedy tokens over a 64-token prompt and 15 steps, against
    the single device; the noise floor the single device's MoE sums split
    into the ranks' two bf16 partials by masked experts (ep_masked_split,
    no ep_axis).  The gate holds."""
    assert _ep_floor_gate(monkeypatch, None)["held"]


def test_ep_noise_floor_gate_fails_with_a_planted_fault(monkeypatch):
    """The same gate fails when ep's combine weights are sliced at rank 0's
    experts on both ranks."""
    assert not _ep_floor_gate(monkeypatch, "wrong_slice")["held"]


def _ep_floor_gate(monkeypatch, fault):
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_preset("mixtral-8x7b").scaled(8), moe_intermediate_size=512,
                              num_layers=4)
    model = Llama(cfg, init_params(cfg, seed=0, device="cpu"))
    dev = torch.device("cpu")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64)))
    with cs.ep_partial_sums(2):
        lg, cache = model(prompt, KVCache.create(cfg, 1, 96, device="cpu"))
        want_toks = [int(lg[0, -1].argmax())]
        for _ in range(15):
            lg, cache = model(torch.tensor([want_toks[-1:]]), cache)
            want_toks.append(int(lg[0, -1].argmax()))
    toks = torch.tensor([want_toks])
    want = cs.forced_logits(model, cfg, prompt, toks, dev).numpy()
    with cs.ep_masked_split(2):
        floor = cs.forced_logits(model, cfg, prompt, toks, dev).numpy()
    _plant(monkeypatch, fault)
    with cs.ep_partial_sums(2):
        got = cs.forced_logits(model, cfg, prompt, toks, dev).numpy()
    return cs.single_gate(want, got, floor, RTOL, ATOL)
