"""The port's models and generation loop against the JAX package.

Configs: bitnet-3b scaled(8) (w_a8, per-tensor scales, kernel K1) with
head_dim put back to 100, so the cache's 100 -> 128 pad is exercised; and
llama-2-7b scaled(8) at bits 2 and 4 (w_fp, g128 bf16 scales and zero
points, kernel K4); and mixtral-8x7b scaled(8) (8 experts, top-2) with the
expert FFN raised to 512, a multiple of 4 * 128, so that the experts' down
K is unpadded and B=1 decode runs the expert kernel on both sides (K7 in
the port; scaled(8)'s own 1792 pads to 2048 at bits 2, where JAX silently
takes its gather route).  At bits 2 down's K pads from 1280 to 1536, as at full
size, so silu(g) * u runs before down; at bits 4 it folds into down.  JAX runs forward(impl="pallas"), whose fused
qgemm kernel runs in interpret mode on the CPU; it is jitted once per
shape and fed the port's own greedy tokens (teacher forcing).

The port follows what XLA compiles the reference to on the CPU: the row
sum of the rms_norm variance in XLA's window order, the activation scale
as a multiply by the f32 reciprocal of 127, and the epilogue's fused
multiply-adds on each of qgemm_pallas's two routes (N < 64 and N >= 64).
What it cannot follow is XLA's CPU rsqrt, a hardware reciprocal-square-
root estimate refined by two Newton steps, which differs from IEEE
1 / sqrt in the last bit of about a third of its inputs (and, on longer
prompts, the bits of XLA's exp in the prefill softmax).  A last-bit
difference in a row's norm factor can move an int8 code at a .5 tie, and
the random layers amplify it, so prompts long enough to hit such a row get
their own, measured gate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.runtime.generate import generate, prefill
from tmac_tpu_torch.utils import argmax_agreement, nmse

torch.set_num_threads(2)

PROMPT, STEPS = 8, 4
# Logits NMSE gate.  The JAX package's own xla and pallas paths differ by
# 7.5e-4 at this config, so the gate separates the two semantics.
LOGITS_NMSE = 1e-4
TIE_MARGIN = 1e-2
# Prefill of LONG_PROMPT tokens (qgemm_pallas's N >= 64 route), gate by
# config.  Measured on the CPU: bitnet-3b 1.4e-4 (1.8e-4 for a 64-token
# prompt), llama-2-7b 5.1e-4 at bits 2 and 6.8e-4 at bits 4 (9.2e-5 and
# 1.3e-4 for another prompt).  All of it but 2.0e-6 (bitnet-3b) and 0.0
# (llama-2-7b) comes from XLA's rsqrt (the module docstring; the
# *_gap_is_xla_rsqrt tests).  The gates leave room for another CPU's
# reciprocal-square-root estimate.
LONG_PROMPT = 72
LONG_PROMPT_NMSE = {"bitnet-3b": 4e-4, "llama-2-7b": 2e-3}
# ... and with XLA's rsqrt values given to the port; the 2.0e-6 left at
# bitnet-3b are the bits of XLA's exp and dot order in the f32 prefill
# softmax
GIVEN_RSQRT_NMSE = 1e-5
# Mixtral scaled(8), measured on the CPU: the prompt of PROMPT tokens (the
# dense-masked MoE form) 9.8e-5, the 4 decode steps (select, through the
# expert kernels) 5.4e-4 to 9.9e-4, LONG_PROMPT tokens (capacity dispatch,
# C = 40) 4.8e-4.  With XLA's rsqrt given to the port: 3.7e-5 (prompt),
# 2.1e-5 to 9.1e-5 (steps), 4.3e-5 (72 tokens) -- the same config without
# experts is then bit-identical, so the rest is the MoE block's f32 ulps
# (router and combine dot orders, XLA's per-shape FMA pairing; see
# tests/test_torch_moe.py) showing through bf16 roundings.  The gates leave
# room for another CPU's rsqrt estimate.
MIXTRAL_NMSE, MIXTRAL_GIVEN_RSQRT_NMSE = 3e-3, 3e-4


def _cfgs():
    cfg = dataclasses.replace(get_preset("bitnet-3b").scaled(8), head_dim=100)
    jcfg = dataclasses.replace(jax_preset("bitnet-3b").scaled(8), head_dim=100)
    return cfg, jcfg


def _wfp_cfgs(bits):
    return (get_preset("llama-2-7b", bits=bits).scaled(8),
            jax_preset("llama-2-7b", bits=bits).scaled(8))


def _mixtral_cfgs():
    return tuple(dataclasses.replace(get("mixtral-8x7b").scaled(8),
                                     moe_intermediate_size=512)
                 for get in (get_preset, jax_preset))


@pytest.fixture(scope="module")
def run():
    return _teacher_forced(*_cfgs())


@pytest.fixture(scope="module", params=[2, 4], ids=["w2", "w4"])
def wfp(request):
    return _teacher_forced(*_wfp_cfgs(request.param))


@pytest.fixture(scope="module")
def mixtral():
    """The teacher-forced run, counting the expert-kernel calls on both
    sides: JAX's qgemm_expert_pallas while its decode step traces, the
    port's K7 (its plain version, on the CPU) in every decode step."""
    import tmac_tpu.ops.pallas.expert_kernel as jek
    import tmac_tpu_torch.ops.cuda.expert_kernel as tek
    calls = {"jax": 0, "port": 0}
    saved = jek.qgemm_expert_pallas, tek.qgemm_expert_plain

    def counting(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped
    jek.qgemm_expert_pallas = counting("jax", saved[0])
    tek.qgemm_expert_plain = counting("port", saved[1])
    try:
        run = _teacher_forced(*_mixtral_cfgs())
    finally:
        jek.qgemm_expert_pallas, tek.qgemm_expert_plain = saved
    return dict(run, expert_calls=calls)


def _teacher_forced(cfg, jcfg, quant=False, deferred_kv=None,
                    prompt_len=PROMPT):
    """The port's prefill + greedy decode, and JAX teacher-forced on the
    port's tokens: logits per step from both.  quant: int8 caches;
    deferred_kv: the decode steps' KV-write mode on both sides."""
    model = Llama(cfg, init_params(cfg, seed=0, device="cpu"),
                  deferred_kv=deferred_kv)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (1, prompt_len))
    cache = KVCache.create(cfg, 1, 64, device="cpu", quant=quant)
    logits, cache = model(torch.from_numpy(prompt), cache)
    port = [logits[0].numpy()]
    toks = [int(logits[0, -1].argmax())]
    for _ in range(STEPS):
        logits, cache = model(torch.tensor([[toks[-1]]]), cache)
        port.append(logits[0].numpy())
        toks.append(int(logits[0, -1].argmax()))

    fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl", "deferred_kv"))
    jparams = jl.init_params(jcfg, seed=0)
    jcache = jl.KVCache.create(jcfg, 1, 64, quant=quant)
    lg, jcache = fwd(jparams, jcfg, jnp.asarray(prompt), jcache, impl="pallas")
    ref = [np.asarray(lg[0])]
    for t in toks[:STEPS]:
        lg, jcache = fwd(jparams, jcfg, jnp.asarray([[t]]), jcache,
                         impl="pallas", deferred_kv=deferred_kv)
        ref.append(np.asarray(lg[0]))
    return dict(cfg=cfg, jcfg=jcfg, model=model, prompt=prompt, toks=toks,
                port=port, ref=ref, jparams=jparams, cache=cache,
                jcache=jcache)


_fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))


def jax_prefill(jparams, jcfg, prompt, max_len=128):
    """JAX forward(impl="pallas") logits (T, V) of a prompt (1, T)."""
    cache = jl.KVCache.create(jcfg, 1, max_len)
    lg, _ = _fwd(jparams, jcfg, jnp.asarray(prompt), cache, impl="pallas")
    return np.asarray(lg[0])


def port_prefill(model, prompt):
    cache = KVCache.create(model.cfg, 1, 128, device="cpu")
    return model(torch.from_numpy(prompt), cache)[0][0].numpy()


def _assert_tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}.{i}")
    elif isinstance(a, QuantizedTensor):
        for f in ("bits", "group_size", "k_shards", "m_shards", "shape",
                  "m_segments"):
            assert getattr(a, f) == getattr(b, f), (path, f)
        for f in ("packed", "packed_hi", "scales", "sub"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (path, f)
            if x is not None:
                _assert_tree_equal(x, y, f"{path}.{f}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == torch.bfloat16:  # compare the bits
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), path


def _init_params_match(run):
    cfg = run["cfg"]
    tree = jax.tree.map(np.asarray, run["jparams"])
    carried = params_from_numpy(tree, cfg, device="cpu")
    _assert_tree_equal(init_params(cfg, seed=0, device="cpu"), carried)
    assert carried["embed"].dtype == torch.bfloat16
    return carried


def _logits_match(run):
    for step, (ref, got) in enumerate(zip(run["ref"], run["port"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= LOGITS_NMSE, step
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step


def test_init_params_match_jax_byte_for_byte(run):
    _init_params_match(run)


def test_logits_match_jax_pallas(run):
    _logits_match(run)


def test_wfp_init_params_match_jax_byte_for_byte(wfp):
    """Including the bf16 scales and sub and down's K padding."""
    layer = _init_params_match(wfp)["layers"][0]
    down, bits = layer["down"], wfp["cfg"].quant.bits
    assert layer["wqkv"].scales.dtype == down.sub.dtype == torch.bfloat16
    assert (down.kdim, down.kdim_padded) == ((1280, 1536) if bits == 2
                                             else (1280, 1280))


def test_wfp_logits_match_jax_pallas(wfp):
    """Prefill of PROMPT tokens and STEPS decode steps, teacher-forced."""
    _logits_match(wfp)


def test_wfp_long_prompt_matches_jax_pallas(wfp):
    """Past qgemm_pallas's N >= 64 route switch, where the reference runs
    the external-int8 form of its grouped kernel (the same function)."""
    T = LONG_PROMPT
    prompt = np.random.default_rng(T).integers(0, wfp["cfg"].vocab_size, (1, T))
    ref = jax_prefill(wfp["jparams"], wfp["jcfg"], prompt)
    got = port_prefill(wfp["model"], prompt)
    assert np.isfinite(got).all()
    assert nmse(ref, got) <= LONG_PROMPT_NMSE["llama-2-7b"]
    assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0


def test_wfp_long_prompt_gap_is_xla_rsqrt(wfp, monkeypatch):
    _given_xla_rsqrt(monkeypatch)
    _long_prompt_within(wfp, GIVEN_RSQRT_NMSE)


# A prefill of 3 * group_size (384) rows in one chunk, where qgemm_pallas
# takes its dequant kernel for every grouped linear (K5 in the port) and
# its single-dot kernel for the int8 head (K3).  Logits NMSE against
# forward(impl="pallas"), measured on the CPU: 7.6e-5 (bits 2) and 1.1e-4
# (bits 4), and the same given XLA's rsqrt values: at this length the gap
# is not XLA's rsqrt but the f32 steps whose order differs and which round
# to bf16 (given XLA's rsqrt and XLA's own dot for K5's sum, 4.6e-5 remains
# at bits 2, from the prefill softmax over up to 384 rows and the other
# exp and sum steps, not separated further).  Tie-aware argmax agreement
# over the 384 positions, measured: 383/384 at bits 2 (one position whose
# top two logits are 0.012 apart moved by 0.008), 1.0 at bits 4.
DEQUANT_PROMPT = 384
DEQUANT_NMSE, DEQUANT_AGREEMENT = 5e-4, 0.99


def _dequant_prefill(run):
    """(JAX's logits, the port's) for a DEQUANT_PROMPT-token prefill; JAX's
    kept in the run."""
    from tmac_tpu_torch.ops.qgemm import route
    T = DEQUANT_PROMPT
    cfg = run["cfg"]
    assert route(run["model"].layers[0].wqkv.qt, T) == "K5"
    prompt = np.random.default_rng(T).integers(0, cfg.vocab_size, (1, T))
    if "dequant_ref" not in run:
        run["dequant_ref"] = jax_prefill(run["jparams"], run["jcfg"], prompt,
                                         max_len=T)
    cache = KVCache.create(cfg, 1, T, device="cpu")
    got = run["model"](torch.from_numpy(prompt), cache)[0][0].numpy()
    assert got.shape == run["dequant_ref"].shape and np.isfinite(got).all()
    return run["dequant_ref"], got


def test_wfp_dequant_prefill_matches_jax_pallas(wfp):
    ref, got = _dequant_prefill(wfp)
    assert nmse(ref, got) <= DEQUANT_NMSE
    assert argmax_agreement(ref, got, TIE_MARGIN) >= DEQUANT_AGREEMENT


def test_wfp_dequant_prefill_gap_is_not_xla_rsqrt(wfp, monkeypatch):
    """Given XLA's rsqrt values the gap stays (see DEQUANT_PROMPT)."""
    ref, got = _dequant_prefill(wfp)
    _given_xla_rsqrt(monkeypatch)
    ref, given = _dequant_prefill(wfp)
    assert nmse(ref, given) <= DEQUANT_NMSE


# Block mode: logits NMSE against JAX's block mode, measured on the CPU:
# 8.4e-5 (prompt) and 1.7e-4 to 2.2e-4 (steps), bit-identical given XLA's
# rsqrt values (the same config without the block mode: 3.5e-4 to 5.3e-4).
BLOCK_NMSE = 1e-3


def _block_mode_run(monkeypatch):
    """TMAC_BLOCK_KERNEL=1 on both sides, set before either is made or
    traced: a BitNet scaled(8) config with q_dim == hidden (head_dim 64),
    whose decode steps run each layer's residual block through the
    one-program kernel (K10 in the port, wo_mlp_block in JAX), teacher
    forced, the block calls counted on both sides.  JAX's caches are
    cleared first: the variable is read while forward traces."""
    import tmac_tpu.ops.pallas.block_kernel as jbk
    import tmac_tpu_torch.models.llama as tl
    calls = {"jax": 0, "port": 0}

    def counting(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jbk, "wo_mlp_block", counting("jax", jbk.wo_mlp_block))
    monkeypatch.setattr(tl, "wo_mlp_block", counting("port", tl.wo_mlp_block))
    monkeypatch.setenv("TMAC_BLOCK_KERNEL", "1")
    jax.clear_caches()
    cfg, jcfg = (dataclasses.replace(get("bitnet-3b").scaled(8), head_dim=64)
                 for get in (get_preset, jax_preset))
    assert cfg.q_dim == cfg.hidden_size
    run = _teacher_forced(cfg, jcfg)
    assert run["model"].block_mode
    # JAX traces one decode step (a call a layer); the port runs each
    assert calls == {"jax": cfg.num_layers, "port": STEPS * cfg.num_layers}
    monkeypatch.delenv("TMAC_BLOCK_KERNEL")
    assert not Llama(cfg, init_params(cfg, 0, "cpu")).block_mode
    return run


def test_block_mode_decode_matches_jax_pallas(monkeypatch):
    run = _block_mode_run(monkeypatch)
    for step, (ref, got) in enumerate(zip(run["ref"], run["port"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= BLOCK_NMSE, step
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step


def test_block_mode_gap_is_xla_rsqrt(monkeypatch):
    """Given XLA's rsqrt values for the norm factors (K10's among them),
    the block mode's logits are JAX's bit for bit."""
    _given_xla_rsqrt(monkeypatch)
    run = _block_mode_run(monkeypatch)
    for ref, got in zip(run["ref"], run["port"]):
        np.testing.assert_array_equal(got, ref)


def test_generate_agrees_with_jax_teacher_forced(run):
    out = generate(run["model"], run["prompt"], STEPS + 1)
    assert out.shape == (1, STEPS + 1) and out.dtype == torch.int32
    ref_top = np.stack([r[-1] for r in run["ref"]])          # (steps+1, V)
    chosen = np.zeros_like(ref_top)
    chosen[np.arange(STEPS + 1), out[0].numpy()] = 1.0
    assert argmax_agreement(ref_top, chosen, TIE_MARGIN) == 1.0
    assert out[0].tolist() == run["toks"]


def test_chunked_prefill_equals_one_shot(run):
    cfg, model = run["cfg"], run["model"]
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)))
    one = KVCache.create(cfg, 2, 32, device="cpu")
    chunked = KVCache.create(cfg, 2, 32, device="cpu")
    lg1, one = prefill(model, toks, one)
    lg2, chunked = prefill(model, toks, chunked, chunk=4)
    assert torch.equal(lg2, lg1)
    assert torch.equal(one.pos, chunked.pos) and one.pos.tolist() == [10, 10]
    assert torch.equal(chunked.k, one.k) and torch.equal(chunked.v, one.v)


def test_forward_updates_cache_in_place(run):
    cfg, cache = run["cfg"], run["cache"]
    n = PROMPT + STEPS
    assert cache.pos.tolist() == [n]
    assert cache.k.shape == (cfg.num_layers, 1, cfg.num_kv_heads, 128, 128)
    written = cache.k[:, :, :, :n, :cfg.head_dim].float()
    assert (written.abs().sum(-1) > 0).all()
    assert not cache.k[:, :, :, n:].any()                    # rows ahead
    assert not cache.k[..., cfg.head_dim:].any()             # Dp padding


@pytest.mark.parametrize("T", [16, LONG_PROMPT])
def test_prefill_logits_match_jax_pallas_at_longer_prompts(run, T):
    """The main path's prompt length, and one past qgemm_pallas's N >= 64
    route switch."""
    prompt = np.random.default_rng(T).integers(0, run["cfg"].vocab_size, (1, T))
    ref = jax_prefill(run["jparams"], run["jcfg"], prompt)
    got = port_prefill(run["model"], prompt)
    assert np.isfinite(got).all()
    assert nmse(ref, got) <= (LOGITS_NMSE if T < 64
                              else LONG_PROMPT_NMSE["bitnet-3b"])
    assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0


def _given_xla_rsqrt(monkeypatch):
    """Give the port's rms_norm steps (the prologues' and K10's) XLA's
    rsqrt values for the norm factors."""
    import tmac_tpu_torch.ops.cuda.qgemm_kernel as k1

    def xla_rsqrt_norm(xf, w, eps, K):
        var = k1.row_sum_xla_order(xf * xf) * (1.0 / K)
        rs = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray((var + eps).numpy())))
        return xf * torch.from_numpy(np.array(rs)) * torch.nn.functional.pad(
            w.float(), (0, xf.shape[1] - K))

    monkeypatch.setattr(k1, "rms_norm_values", xla_rsqrt_norm)


def _long_prompt_within(run, gate):
    T = LONG_PROMPT
    prompt = np.random.default_rng(T).integers(0, run["cfg"].vocab_size, (1, T))
    ref = jax_prefill(run["jparams"], run["jcfg"], prompt)
    got = port_prefill(run["model"], prompt)
    assert nmse(ref, got) <= gate


def test_long_prompt_gap_is_xla_rsqrt(run, monkeypatch):
    """Given XLA's rsqrt values for the norm factors, the port's prefill
    logits at LONG_PROMPT tokens come within GIVEN_RSQRT_NMSE of JAX's."""
    _given_xla_rsqrt(monkeypatch)
    _long_prompt_within(run, GIVEN_RSQRT_NMSE)


def test_mixtral_init_params_match_jax_byte_for_byte(mixtral):
    """Router, stacked experts (leading E axis) and all, in JAX's order of
    draws; the experts' K unpadded, as K7 needs."""
    from tmac_tpu.ops.pallas.expert_kernel import expert_kernel_supported
    layer = _init_params_match(mixtral)["layers"][0]
    cfg = mixtral["cfg"]
    assert layer["experts_gate_up"].packed.shape[0] == cfg.num_experts
    assert layer["experts_down"].kdim == layer["experts_down"].kdim_padded == 512
    for name in ("experts_gate_up", "experts_down"):
        assert expert_kernel_supported(mixtral["jparams"]["layers"][0][name])


def test_mixtral_logits_match_jax_pallas(mixtral):
    """Prefill of PROMPT tokens (dense-masked form) and STEPS decode steps
    (select form), teacher-forced; every decode step went through the
    expert kernel on both sides (2 experts x 2 calls x 2 layers)."""
    for step, (ref, got) in enumerate(zip(mixtral["ref"], mixtral["port"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= MIXTRAL_NMSE, step
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step
    per_step = 2 * 2 * mixtral["cfg"].num_layers
    assert mixtral["expert_calls"] == {"jax": per_step, "port": STEPS * per_step}


def test_mixtral_long_prompt_matches_jax_pallas(mixtral):
    """Capacity dispatch: 72 tokens, C = 40 slots an expert."""
    T = LONG_PROMPT
    prompt = np.random.default_rng(T).integers(0, mixtral["cfg"].vocab_size, (1, T))
    ref = jax_prefill(mixtral["jparams"], mixtral["jcfg"], prompt)
    got = port_prefill(mixtral["model"], prompt)
    assert np.isfinite(got).all()
    assert nmse(ref, got) <= MIXTRAL_NMSE
    assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0


@pytest.mark.parametrize("T", [PROMPT, LONG_PROMPT])
def test_mixtral_gap_is_mostly_xla_rsqrt(mixtral, monkeypatch, T):
    _given_xla_rsqrt(monkeypatch)
    prompt = np.random.default_rng(T).integers(0, mixtral["cfg"].vocab_size, (1, T))
    ref = jax_prefill(mixtral["jparams"], mixtral["jcfg"], prompt)
    got = port_prefill(mixtral["model"], prompt)
    assert nmse(ref, got) <= MIXTRAL_GIVEN_RSQRT_NMSE


def test_mixtral_generate_agrees_with_jax_teacher_forced(mixtral):
    out = generate(mixtral["model"], mixtral["prompt"], STEPS + 1)
    ref_top = np.stack([r[-1] for r in mixtral["ref"]])
    chosen = np.zeros_like(ref_top)
    chosen[np.arange(STEPS + 1), out[0].numpy()] = 1.0
    assert argmax_agreement(ref_top, chosen, TIE_MARGIN) == 1.0
    assert out[0].tolist() == mixtral["toks"]


# Phi-3-mini scaled(8) with head_dim 96 (its cache pads 96 -> 128) and a
# sliding window of 24 rows, which the prompt of 26 tokens and the 4
# decode steps cross.  Logits NMSE against forward(impl="pallas"), measured
# on the CPU: bf16 cache 2.5e-4 to 7.6e-4, int8 cache 4.1e-4 to 8.6e-4,
# deferred mode (forward(deferred_kv=True), K8) 2.8e-4 to 8.6e-4 on either
# cache.  Given XLA's rsqrt values the int8 cache's explicit and deferred
# runs are bit-identical to JAX's; the bf16 cache keeps 6.2e-4 at one
# decode step, where K6's online softmax (its plain version here) adds in
# another order than the reference's masked softmax off the TPU, and a
# last-bit difference in an attention output moves a bf16 rounding.  The
# gate leaves room for another CPU's rsqrt estimate.
PHI3_PROMPT, PHI3_WINDOW = 26, 24
PHI3_NMSE = 3e-3


def _phi3_cfgs():
    return tuple(dataclasses.replace(get("phi-3-mini").scaled(8), head_dim=96,
                                     sliding_window=PHI3_WINDOW)
                 for get in (get_preset, jax_preset))


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def phi3(request):
    return _teacher_forced(*_phi3_cfgs(), quant=request.param,
                           prompt_len=PHI3_PROMPT)


@pytest.fixture(scope="module", params=[False, True], ids=["bf16", "int8"])
def phi3_deferred(request):
    return _teacher_forced(*_phi3_cfgs(), quant=request.param,
                           deferred_kv=True, prompt_len=PHI3_PROMPT)


def _phi3_logits_match(run):
    for step, (ref, got) in enumerate(zip(run["ref"], run["port"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= PHI3_NMSE, step
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step


def test_phi3_init_params_match_jax_byte_for_byte(phi3):
    layer = _init_params_match(phi3)["layers"][0]
    assert layer["down"].kdim == layer["down"].kdim_padded     # SwiGLU folds
    assert phi3["cache"].k.shape[-1] == 128


def test_phi3_logits_match_jax_pallas(phi3):
    """Explicit KV writes: prefill past the window, and 4 decode steps
    through K6 (its plain version) on a bf16 or int8 cache."""
    assert phi3["cache"].quantized == (phi3["cache"].k.dtype == torch.int8)
    _phi3_logits_match(phi3)


def test_phi3_deferred_logits_match_jax_pallas(phi3_deferred):
    """The deferred mode (K8) against forward(deferred_kv=True), whose
    flash_decode_stacked_append runs in interpret mode."""
    assert phi3_deferred["model"].kv_mode == "deferred"
    _phi3_logits_match(phi3_deferred)


@pytest.mark.parametrize("deferred_kv", [None, True],
                         ids=["explicit", "deferred"])
def test_phi3_int8_gap_is_xla_rsqrt(monkeypatch, deferred_kv):
    """Given XLA's rsqrt values for the norm factors, the int8 cache's
    logits are JAX's (measured: bit-identical)."""
    _given_xla_rsqrt(monkeypatch)
    run = _teacher_forced(*_phi3_cfgs(), quant=True, deferred_kv=deferred_kv,
                          prompt_len=PHI3_PROMPT)
    for ref, got in zip(run["ref"], run["port"]):
        assert nmse(ref, got) <= LOGITS_NMSE


def _phi3_steps(model, cfg, prompt, toks, quant):
    cache = KVCache.create(cfg, 1, 64, device="cpu", quant=quant)
    logits, cache = model(torch.from_numpy(prompt), cache)
    out = [logits]
    for t in toks:
        logits, cache = model(torch.tensor([[t]]), cache)
        out.append(logits)
    return out, cache


def test_phi3_inkernel_equals_deferred(phi3_deferred, monkeypatch):
    """TMAC_KV_INKERNEL=1: K9 stores each layer's row itself.  Its logits
    and the cache it leaves equal the deferred mode's (K8, then one commit
    after the layers) bit for bit; the explicit mode differs on an int8
    cache, where it reads the current row back quantized."""
    cfg, params = phi3_deferred["cfg"], init_params(_phi3_cfgs()[0], 0, "cpu")
    prompt, toks = phi3_deferred["prompt"], phi3_deferred["toks"][:STEPS]
    quant = phi3_deferred["cache"].quantized
    deferred = Llama(cfg, params, deferred_kv=True)
    monkeypatch.setenv("TMAC_KV_INKERNEL", "1")
    inkernel = Llama(cfg, params)
    monkeypatch.delenv("TMAC_KV_INKERNEL")
    assert (deferred.kv_mode, inkernel.kv_mode) == ("deferred", "inkernel")
    lg_d, c_d = _phi3_steps(deferred, cfg, prompt, toks, quant)
    lg_i, c_i = _phi3_steps(inkernel, cfg, prompt, toks, quant)
    assert all(torch.equal(a, b) for a, b in zip(lg_d, lg_i))
    for name in ("k", "v", "pos", "k_scale", "v_scale"):
        a, b = getattr(c_d, name), getattr(c_i, name)
        assert (a is None) == (b is None) == (name.endswith("scale")
                                              and not quant), name
        if a is not None:
            assert torch.equal(a, b), name
    assert not c_i.k[..., cfg.head_dim:].any()           # Dp padding
    lg_e, _ = _phi3_steps(Llama(cfg, params), cfg, prompt, toks, quant)
    assert torch.equal(lg_e[0], lg_d[0])                # the same prefill
    assert any(not torch.equal(a, b) for a, b in zip(lg_e, lg_d)) == quant


def test_phi3_generate_agrees_with_jax_teacher_forced(phi3):
    """generate(kv_quant=True) on the int8 run, the bf16 cache otherwise."""
    out = generate(phi3["model"], phi3["prompt"], STEPS + 1,
                   kv_quant=phi3["cache"].quantized)
    ref_top = np.stack([r[-1] for r in phi3["ref"]])
    chosen = np.zeros_like(ref_top)
    chosen[np.arange(STEPS + 1), out[0].numpy()] = 1.0
    assert argmax_agreement(ref_top, chosen, TIE_MARGIN) == 1.0
    assert out[0].tolist() == phi3["toks"]


def test_phi3_cache_from_numpy_round_trips(phi3):
    """The JAX cache (int8 codes and f32 scales, or bf16) carried into the
    port byte for byte; one more decode step from it on both sides."""
    from tmac_tpu_torch.convert.from_jax import cache_from_numpy
    jcache, cfg = phi3["jcache"], phi3["cfg"]
    carried = cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    assert carried.quantized == jcache.quantized
    for name in ("k", "v", "pos", "k_scale", "v_scale"):
        a, b = getattr(jcache, name), getattr(carried, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = np.asarray(a)
            assert str(b.dtype)[6:] == str(a.dtype) and b.shape == a.shape
            b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
            np.testing.assert_array_equal(
                b.numpy(), a.view(np.int16) if a.dtype.name == "bfloat16"
                else a)
    tok = phi3["toks"][STEPS]
    got, _ = phi3["model"](torch.tensor([[tok]]), carried)
    ref, _ = _fwd(phi3["jparams"], phi3["jcfg"], jnp.asarray([[tok]]),
                  jcache, impl="pallas")
    assert nmse(np.asarray(ref[0]), got[0].numpy()) <= PHI3_NMSE


def test_phi3_chunked_prefill_equals_one_shot(phi3):
    """A prefill in chunks of 8 tokens, whose window masks cross the chunk
    boundaries, leaves the one-shot prefill's logits and cache."""
    cfg, model, quant = phi3["cfg"], phi3["model"], phi3["cache"].quantized
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, PHI3_PROMPT + 6)))
    one = KVCache.create(cfg, 2, 64, device="cpu", quant=quant)
    chunked = KVCache.create(cfg, 2, 64, device="cpu", quant=quant)
    lg1, one = prefill(model, toks, one)
    lg2, chunked = prefill(model, toks, chunked, chunk=8)
    assert torch.equal(lg2, lg1)
    for name in ("k", "v", "pos", "k_scale", "v_scale"):
        a, b = getattr(one, name), getattr(chunked, name)
        assert (a is None and b is None) or torch.equal(a, b), name
