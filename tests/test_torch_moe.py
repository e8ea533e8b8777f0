"""The port's MoE MLP (models/moe.py) against the JAX package's moe_mlp
(impl="pallas", compiled as the model runs it; its Pallas kernels in
interpret mode), on the same weights (the JAX init, carried by
params_from_numpy) and the same numpy-seeded inputs.

Config: mixtral-8x7b scaled(8) (hidden 512, E = 8, top-2) with the expert
FFN at 512, a multiple of 4 * 128, so that down's K is unpadded and the
select form runs the expert kernel on both sides (K7 in the port, whose
plain version runs on the CPU); and qwen2-moe-a14b scaled(16) at bits 4
with E = 4, top-2, for the all-expert softmax and the gated shared expert.

Tolerances.  The port's rms_norm uses IEEE rsqrt where XLA's CPU rsqrt is
a hardware estimate refined by Newton steps (ROADMAP Queue 3): a last-bit
difference in a row's norm factor can move one int8 code at a .5 tie.  The
router's f32 dot and softmax, and the dispatch combine, add in other orders
(ulps in f32), and XLA pairs the grouped kernels' FMAs per shape
(tests/test_torch_expert_kernel.py); each output rounds to bf16, so these
show as a few one-ulp bf16 differences.  Measured here (NMSE): select 0.0
(three tokens), select's gather route 0.0 (two tokens), dense 0.0,
dispatch 8.3e-10 (256 tokens) and 1.0e-8 (72), overflow 0.0, Qwen2-MoE
0.0 (dense and select).  MOE_NMSE leaves room for
a code flip and is far below what one wrong expert or weight gives (O(1)
on a token).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmac_tpu.ops.pallas.expert_kernel as jek
import tmac_tpu_torch.ops.cuda.expert_kernel as tek
from tmac_tpu.models import moe as jm
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.models.llama import init_params as jax_init
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models import llama as tl
from tmac_tpu_torch.models import moe as tm
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

MOE_NMSE = 1e-5
# a router logit margin below which either expert is an acceptable pick:
# far above the f32 dot-order noise (~1e-6 of logits of size ~0.1-1)
TIE = 1e-4


def _cfgs(name, factor, **kw):
    """(port, JAX) configs: preset `name` scaled, one layer, overrides."""
    return tuple(dataclasses.replace(get(name).scaled(factor), num_layers=1, **kw)
                 for get in (get_preset, jax_preset))


def _mixtral(**kw):
    return _cfgs("mixtral-8x7b", 8, moe_intermediate_size=512, **kw)


def _qwen():
    return _cfgs("qwen2-moe-a14b", 16, num_experts=4, num_experts_per_tok=2,
                 num_kv_heads=2, moe_intermediate_size=512,
                 moe_shared_intermediate_size=512)


def _layers(cfg, jcfg, seed):
    jlayer = jax_init(jcfg, seed=seed)["layers"][0]
    tree = jax.tree.map(np.asarray, {"layers": [jlayer]})
    return params_from_numpy(tree, cfg, device="cpu")["layers"][0], jlayer


@pytest.fixture(scope="module")
def mixtral():
    cfg, jcfg = _mixtral()
    layer, jlayer = _layers(cfg, jcfg, seed=0)
    assert jek.expert_kernel_supported(jlayer["experts_gate_up"])
    assert jek.expert_kernel_supported(jlayer["experts_down"])
    return cfg, jcfg, layer, jlayer


_jmoe = jax.jit(jm.moe_mlp, static_argnames=("cfg", "mode", "impl", "moe_impl",
                                             "capacity"))


def _both(cfg, jcfg, layer, jlayer, x, **kw):
    """(JAX, port) moe_mlp outputs in f32 for x (B, T, H) f32."""
    jv = kw.pop("valid", None)
    want = _jmoe(jnp.asarray(x, jnp.bfloat16), jlayer, jcfg, jcfg.quant.mode,
                 impl="pallas", valid=None if jv is None else jnp.asarray(jv),
                 **kw)
    got = tm.moe_mlp(torch.from_numpy(x).to(torch.bfloat16), layer, cfg,
                     valid=None if jv is None else torch.from_numpy(jv), **kw)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy()


def _tokens(rng, cfg, n):
    return rng.standard_normal((1, n, cfg.hidden_size)).astype(np.float32)


@pytest.mark.parametrize("norm_topk", [True, False])
def test_route_topk_matches_jax(mixtral, norm_topk):
    """Routing first: the same k experts per token (either pick where JAX's
    k-th and (k+1)-th logits are within TIE), weights to f32 rounding,
    each row's weights on exactly k experts."""
    cfg, _, layer, jlayer = mixtral
    rng = np.random.default_rng(1)
    x2 = rng.standard_normal((64, cfg.hidden_size)).astype(np.float32)
    xb = jnp.asarray(x2, jnp.bfloat16)
    k = cfg.num_experts_per_tok
    want = np.asarray(jax.jit(jm.route_topk, static_argnums=(2, 3))(
        xb, jlayer["moe_router"], k, norm_topk))
    got = tm.route_topk(torch.from_numpy(x2).to(torch.bfloat16),
                        layer["moe_router"], k, norm_topk).numpy()
    assert ((got > 0).sum(1) == k).all()
    logits = np.asarray(xb, np.float32) @ np.asarray(jlayer["moe_router"],
                                                     np.float32)
    srt = np.sort(logits, 1)[:, ::-1]
    near_tie = srt[:, k - 1] - srt[:, k] < TIE
    same = ((got > 0) == (want > 0)).all(1)
    assert (same | near_tie).all()
    np.testing.assert_allclose(got[same], want[same], rtol=1e-5, atol=1e-7)
    if norm_topk:
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)


def test_top_k_order_and_ties():
    """Largest first, the lower index first among equal values, as
    jax.lax.top_k."""
    v = torch.tensor([[0.5, 0.2, 0.5, 0.9, 0.2]])
    vals, idx = tm.top_k(v, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(v.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [[3, 0, 2, 1]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_expert_capacity_matches_jax(mixtral):
    cfg, jcfg, _, _ = mixtral
    for n in (1, 7, 64, 72, 256, 1000):
        assert tm.expert_capacity(n, cfg) == jm.expert_capacity(n, jcfg)
    assert tm.expert_capacity(256, cfg) == 128     # the chip path's prefill


@pytest.mark.parametrize("moe_impl,n", [("dense", 8), ("dispatch", 256),
                                        ("dispatch", 72)])
def test_moe_mlp_matches_jax(mixtral, moe_impl, n):
    """Dense-masked form at a short prompt; capacity dispatch at the chip
    path's 256-token prefill chunk (C = 128: each expert's K4 calls take
    the N >= 64 route) and at 72 tokens (C = 40)."""
    cfg, jcfg, layer, jlayer = mixtral
    x = _tokens(np.random.default_rng(n), cfg, n)
    want, got = _both(cfg, jcfg, layer, jlayer, x, moe_impl=moe_impl)
    assert got.shape == want.shape == x.shape and np.isfinite(got).all()
    assert nmse(want, got) <= MOE_NMSE


def test_moe_select_runs_k7_and_matches_jax(mixtral, monkeypatch):
    """The B=1 decode form: both sides run their expert kernel (JAX's
    qgemm_expert_pallas, not the gather fallback; the port's K7, whose
    plain version runs on CPU tensors), 2 calls per routed expert."""
    cfg, jcfg, layer, jlayer = mixtral
    calls = {"jax": 0, "port": 0}

    def counting(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jek, "qgemm_expert_pallas",
                        counting("jax", jek.qgemm_expert_pallas))
    monkeypatch.setattr(tek, "qgemm_expert_plain",
                        counting("port", tek.qgemm_expert_plain))
    rng = np.random.default_rng(2)
    for trial in range(3):
        x = _tokens(rng, cfg, 1)
        want = np.asarray(jm.moe_mlp(
            jnp.asarray(x, jnp.bfloat16), jlayer, jcfg, jcfg.quant.mode,
            impl="pallas", moe_impl="select").astype(jnp.float32))
        got = tm.moe_mlp(torch.from_numpy(x).to(torch.bfloat16), layer, cfg,
                         moe_impl="select").float().numpy()
        assert nmse(want, got) <= MOE_NMSE, trial
        # auto picks select for one token
        auto = tm.moe_mlp(torch.from_numpy(x).to(torch.bfloat16), layer, cfg)
        assert np.array_equal(auto.float().numpy(), got)
    k = cfg.num_experts_per_tok
    assert calls == {"jax": 3 * 2 * k, "port": 6 * 2 * k}


def test_moe_select_gather_route_matches_jax(monkeypatch):
    """Outside the expert kernel's scope (scaled(8)'s own expert FFN, 1792,
    whose down K packs to 2048 at bits 2): both sides select the routed
    experts by a gathered copy and run the dense MLP's linears on it, the
    SwiGLU in bf16 before down; neither calls its expert kernel."""
    cfg, jcfg = _cfgs("mixtral-8x7b", 8)
    layer, jlayer = _layers(cfg, jcfg, seed=5)
    assert cfg.moe_intermediate_size == 1792
    assert not jek.expert_kernel_supported(jlayer["experts_down"])
    assert not tek.expert_kernel_supported(layer["experts_down"])

    def refuse(*a, **k):
        raise AssertionError("expert kernel called outside its scope")
    monkeypatch.setattr(jek, "qgemm_expert_pallas", refuse)
    monkeypatch.setattr(tek, "qgemm_expert_plain", refuse)
    rng = np.random.default_rng(4)
    for trial in range(2):
        x = _tokens(rng, cfg, 1)
        want, got = _both(cfg, jcfg, layer, jlayer, x, moe_impl="select")
        assert np.isfinite(got).all()
        assert nmse(want, got) <= MOE_NMSE, trial


def test_moe_select_gs16_runs_k7_on_both_sides(monkeypatch):
    """A Mixtral layer at group size 16 (GGUF's Q2_K experts): both
    packages' expert_kernel_supported take its stacks, so the select form
    runs the expert kernel on both sides (JAX's qgemm_expert_pallas, the
    port's K7, whose plain version runs on CPU tensors; neither the gather
    route nor apply_qlinear), 2 calls per routed expert, and the outputs
    agree as at other group sizes."""
    cfg, jcfg = (c.with_quant(group_size=16) for c in _mixtral())
    layer, jlayer = _layers(cfg, jcfg, seed=3)
    for stack in ("experts_gate_up", "experts_down"):
        assert layer[stack].group_size == 16
        assert jek.expert_kernel_supported(jlayer[stack])
        assert tek.expert_kernel_supported(layer[stack])
    calls = {"jax": 0, "port": 0}

    def counting(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped

    def refuse(*a, **k):
        raise AssertionError("an expert took the dense route")
    monkeypatch.setattr(jek, "qgemm_expert_pallas",
                        counting("jax", jek.qgemm_expert_pallas))
    monkeypatch.setattr(tek, "qgemm_expert_plain",
                        counting("port", tek.qgemm_expert_plain))
    monkeypatch.setattr(tl, "apply_qlinear", refuse)
    rng = np.random.default_rng(7)
    for trial in range(2):
        x = _tokens(rng, cfg, 1)
        want, got = _both(cfg, jcfg, layer, jlayer, x, moe_impl="select")
        assert np.isfinite(got).all()
        assert nmse(want, got) <= MOE_NMSE, trial
    # JAX's jitted moe_mlp traces its expert calls once, the port calls K7
    # each trial
    k = cfg.num_experts_per_tok
    assert calls == {"jax": 2 * k, "port": 2 * 2 * k}


def test_dispatch_drops_overflow_like_jax():
    """Capacity overflow (E = 2, top-1, 8 slots for 64 tokens): the same
    tokens are dropped on both sides, their rows exactly zero; the kept
    rows agree."""
    cfg, jcfg = _mixtral(num_experts=2, num_experts_per_tok=1)
    layer, jlayer = _layers(cfg, jcfg, seed=7)
    x = _tokens(np.random.default_rng(3), cfg, 64)
    want, got = _both(cfg, jcfg, layer, jlayer, x, moe_impl="dispatch",
                      capacity=8)
    dropped = np.abs(want[0]).max(-1) == 0.0
    assert 0 < dropped.sum() < 64
    np.testing.assert_array_equal(np.abs(got[0]).max(-1) == 0.0, dropped)
    assert nmse(want, got) <= MOE_NMSE


def test_valid_rows_take_no_capacity_like_jax():
    """Rows marked invalid get zero weight: they add nothing and take no
    dispatch slot from the real rows."""
    cfg, jcfg = _mixtral(num_experts=2, num_experts_per_tok=1)
    layer, jlayer = _layers(cfg, jcfg, seed=13)
    n_real, n_pad = 24, 104
    x = np.concatenate([_tokens(np.random.default_rng(7), cfg, n_real),
                        np.ones((1, n_pad, cfg.hidden_size), np.float32)], 1)
    valid = np.arange(n_real + n_pad)[None, :] < n_real
    want, got = _both(cfg, jcfg, layer, jlayer, x, moe_impl="dispatch",
                      capacity=32, valid=valid)
    assert np.abs(got[0, n_real:]).max() == 0.0
    assert (np.abs(got[0, :n_real]).max(-1) > 0).all()
    assert nmse(want, got) <= MOE_NMSE


def test_qwen2moe_shared_expert_matches_jax():
    """norm_topk=False routing (softmax over all experts, top-k weights
    unrenormalized) and the sigmoid-gated shared expert, at bits 4."""
    cfg, jcfg = _qwen()
    assert not cfg.moe_norm_topk and cfg.moe_shared_gate and cfg.quant.bits == 4
    layer, jlayer = _layers(cfg, jcfg, seed=21)
    assert "shared_gate" in layer and "shared_gate_up" in layer
    rng = np.random.default_rng(8)
    for moe_impl, n in (("dense", 12), ("select", 1)):
        x = _tokens(rng, cfg, n)
        want, got = _both(cfg, jcfg, layer, jlayer, x, moe_impl=moe_impl)
        assert np.isfinite(got).all()
        assert nmse(want, got) <= MOE_NMSE, moe_impl


def test_ep_axis_is_refused(mixtral):
    """moe_mlp(ep_axis=) takes this rank's (index, size) on the ep axis
    (parallel/ep.py; tests/test_torch_ep.py): a JAX mesh axis name, an
    index outside the axis, and a stack whose experts times the ep size are
    not the config's are refused."""
    cfg, _, layer, _ = mixtral
    x = torch.zeros(1, 1, cfg.hidden_size, dtype=torch.bfloat16)
    for ep_axis in ("ep", (2, 2), (0, 2)):
        with pytest.raises(ValueError, match="ep"):
            tm.moe_mlp(x, layer, cfg, ep_axis=ep_axis)
