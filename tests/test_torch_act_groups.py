"""Activation groups finer than the weight groups (the reference's
``act_group_size``, its -ags knob): K4's and K4L's ags form.

K4's plain version (``qgemm_grouped_plain(..., act_gs=)``, the port's
``qgemm(..., act_group_size=)``) against the JAX package's
``qgemm_pallas(act="fused", act_group_size=)`` (interpret mode on CPU,
compiled as the model runs it) on the fused route below 64 rows and the
external-int8 chunk route from 64, with every fold: bit for bit.  The
weight groups' code sums follow the order XLA compiles each route's
reshape-sum to (``weight_group_sums``), which differs between the two.

The reference's fused kernel asserts (``_make_kernel``: the chunk must be
the group unless the group is a multiple of Kp / p) for any activation
group size once Kp / p exceeds the group size, that is at every bits 3
tensor and at every real model shape (Llama-2-7B's wqkv: 4096 / 4 = 1024
rows a field against g128).  So the comparisons take the widths where it
runs (Kp / p = 128), bits 3 is held to bits 4 on the same codes, the
decode matmul's split and fold of the ags form is modelled against the
plain version, and the model tests cut the FFN to such a width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model_presets import (assert_tree_equal, given_xla_rsqrt)
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (
    K4L_TWO_BLOCKS, act_quant_grouped_plain, block_partials_plain,
    fold_split_plain, k4l_kt, k4l_smem, qgemm_grouped, qgemm_grouped_large,
    qgemm_grouped_plain)
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (DECODE_SMEM_LIMIT, decode_plan,
                                                  decode_smem, decode_units)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, effective_ags, kernel_for, qgemm
from tmac_tpu_torch.utils import argmax_agreement, nmse

torch.set_num_threads(2)

GS = 128
# the widest K at which the reference's fused kernel takes an ags, by bits
# (Kp / p = GS)
K_AT = {1: 1024, 2: 512, 4: 256}


def _pair(rng, bits, K, M, gs=GS):
    G = K // gs
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
    sub = sc * rng.integers(0, 1 << bits, (G, M)).astype(np.float32)
    return (QuantizedTensor.from_quantized(wq, sc, sub, bits, gs,
                                           scale_dtype=torch.bfloat16, device="cpu"),
            JQT.from_quantized(wq, sc, sub, bits, gs, scale_dtype=jnp.bfloat16))


def _pallas(xb, jqt, ags, **kw):
    dispatch = "chunk" if xb.shape[0] >= 64 else None

    def f(x, q, r):
        return qgemm_pallas(x, q, out_dtype=jnp.float32, interpret=True, act="fused",
                            act_group_size=ags, dispatch=dispatch, residual=r, **kw)
    return np.asarray(jax.jit(f)(xb, jqt, kw.pop("residual", None)))


@pytest.mark.parametrize("N", [1, 16, 256])
@pytest.mark.parametrize("ags", [32, 64])
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_plain_ags_matches_pallas(bits, ags, N):
    """The fused route (N < 64) and the chunk route (N >= 64), bit for
    bit: codes, scales per activation group, the weight groups' code sums
    in each route's order, and the f32 chain over the activation groups."""
    rng = np.random.default_rng(bits * 100 + ags + N)
    K = K_AT[bits]
    qt, jqt = _pair(rng, bits, K, 256)
    x = rng.standard_normal((N, K)).astype(np.float32)
    want = _pallas(jnp.asarray(x, jnp.bfloat16), jqt, ags)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = qgemm(xt, qt, impl="fused", act="fused", out_dtype=torch.float32, act_group_size=ags,
                dispatch="chunk" if N >= 64 else None).numpy()
    np.testing.assert_array_equal(got, want)
    codes, xs, xsum = act_quant_grouped_plain(xt, qt, ags=ags)
    assert xs.shape == (N, K // ags) and xsum.shape == (N, K // GS)
    # finer activation scales: a smaller quantization error than per group
    base = qgemm_grouped_plain(xt, qt).numpy()
    oracle = x.astype(np.float32) @ (
        qt.unpack().float().reshape(K // GS, GS, -1) * qt.scales.float()[:, None]
        - qt.sub.float()[:, None]).reshape(K, -1).numpy()
    assert nmse(oracle, got) <= nmse(oracle, base) * 1.5 and nmse(oracle, got) < 5e-4


# (bits, N, ags, folds): the decode (N = 1), short prefill (16) and K4L
# (72) routes with the model's folds
FOLD_CASES = [(2, 1, 32, "norm"), (2, 16, 64, "residual"), (4, 1, 32, "glu residual"),
              (1, 16, 32, "norm"), (2, 72, 32, "norm"), (4, 72, 64, "glu residual"),
              (1, 100, 32, "residual")]


@pytest.mark.parametrize("bits,N,ags,folds", FOLD_CASES)
def test_plain_ags_folds_match_pallas(bits, N, ags, folds):
    """rms_norm, SwiGLU and the residual with an activation group size:
    bit for bit with the residual alone; with a norm or SwiGLU within 1e-6
    (XLA's CPU rsqrt and exp can move a code at a .5 tie, as in
    tests/test_torch_qgemm_grouped.py)."""
    rng = np.random.default_rng(bits + N + ags)
    K = K_AT[bits]
    qt, jqt = _pair(rng, bits, K, 256)
    glu = "glu" in folds
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    kw_j, kw_t = dict(glu=glu), dict(glu=glu)
    if "norm" in folds:
        w = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kw_j["norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-5)
        kw_t["norm"] = (torch.from_numpy(w).to(torch.bfloat16), 1e-5)
    if "residual" in folds:
        r = rng.standard_normal((N, 256)).astype(np.float32)
        kw_j["residual"] = jnp.asarray(r, jnp.bfloat16)
        kw_t["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    want = _pallas(jnp.asarray(x, jnp.bfloat16), jqt, ags, **kw_j)
    got = kernel_for(qt, N, act_gs=ags, dispatch="chunk")(
        torch.from_numpy(x).to(torch.bfloat16), qt, **kw_t).numpy()
    if "norm" in folds or glu:
        assert nmse(want, got) <= 1e-6
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N", [1, 72])
def test_invalid_act_group_size_is_ignored(N):
    """As the reference: an ags that does not divide the group size, or is
    not below it, gives exactly the ags = 0 result, in both packages."""
    rng = np.random.default_rng(N)
    qt, jqt = _pair(rng, 2, 512, 256)
    x = rng.standard_normal((N, 512)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    base = qgemm_grouped_plain(xt, qt).numpy()
    for bad in (96, 128, 256, -32):
        assert effective_ags(qt, bad) == 0
        np.testing.assert_array_equal(qgemm_grouped_plain(xt, qt, act_gs=bad).numpy(), base)
    np.testing.assert_array_equal(_pallas(jnp.asarray(x, jnp.bfloat16), jqt, 96),
                                  _pallas(jnp.asarray(x, jnp.bfloat16), jqt, 0))
    # per-tensor scales (G = 1) take no activation groups either
    pt = QuantizedTensor.from_float(rng.standard_normal((512, 256)).astype(np.float32),
                                    2, device="cpu")
    assert effective_ags(pt, 32) == 0
    assert kernel_for(pt, N, act_gs=32) is kernel_for(pt, N)


@pytest.mark.parametrize("N,ags", [(1, 32), (16, 64), (100, 32)])
def test_bits3_ags_is_bits4_on_the_same_codes(N, ags):
    """The reference asserts on any ags at bits 3 (its lo plane's Kp / 4
    rows a field always exceed the group), so bits 3 is held to bits 4 on
    the same codes (0..7), scales and zero points: the same function, bit
    for bit."""
    rng = np.random.default_rng(N + ags)
    K, M = 1024, 256
    wq = rng.integers(0, 8, (K, M)).astype(np.uint8)
    sc = ((0.5 + rng.random((K // GS, M))) * 0.05).astype(np.float32)
    sub = sc * rng.integers(0, 8, (K // GS, M)).astype(np.float32)
    q3, q4 = (QuantizedTensor.from_quantized(wq, sc, sub, b, GS, scale_dtype=torch.bfloat16,
                                             device="cpu") for b in (3, 4))
    assert q3.packed_hi is not None and q3.kdim_padded == q4.kdim_padded
    x = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(torch.bfloat16)
    r = torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32)).to(torch.bfloat16)
    got = qgemm_grouped_plain(x, q3, residual=r, act_gs=ags)
    assert torch.equal(got, qgemm_grouped_plain(x, q4, residual=r, act_gs=ags))
    assert not torch.equal(got, qgemm_grouped_plain(x, q3, residual=r))


def test_reference_asserts_where_the_port_computes():
    """At a real model's width (here Kp / p = 384 rows a field, a W2 down
    of 1280 padded to 1536) the reference's kernel refuses an ags; the
    port computes the function, within the reference's accuracy gate of the
    dequant oracle and closer to it than without activation groups."""
    rng = np.random.default_rng(9)
    qt, jqt = _pair(rng, 2, 1536, 256)
    x = rng.standard_normal((4, 1536)).astype(np.float32)
    with pytest.raises(AssertionError):
        _pallas(jnp.asarray(x, jnp.bfloat16), jqt, 32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    w = (qt.unpack().float().reshape(12, GS, -1) * qt.scales.float()[:, None]
         - qt.sub.float()[:, None]).reshape(1536, -1)
    oracle = (xt.float() @ w).numpy()
    fine = qgemm_grouped_plain(xt, qt, act_gs=32).numpy()
    assert nmse(oracle, fine) < 5e-4
    assert nmse(oracle, fine) < nmse(oracle, qgemm_grouped_plain(xt, qt).numpy())


@pytest.mark.parametrize("bits,ags", [(1, 32), (2, 32), (2, 64), (3, 32), (4, 64)])
def test_decode_split_of_the_ags_form(bits, ags):
    """K4's ags form in the decode matmul (csrc/decode_matmul.cuh, AGS):
    the split's unit is an activation group of ags packed rows, each
    block's per-activation-group partials are exchanged and folded over
    the activation groups in order; every cluster size gives the plain
    version bit for bit."""
    rng = np.random.default_rng(bits * 10 + ags)
    K = 2048 if bits in (1, 3) else 1024
    if bits == 3:
        wq = rng.integers(0, 8, (K, 128)).astype(np.uint8)
        sc = ((0.5 + rng.random((K // GS, 128))) * 0.05).astype(np.float32)
        qt = QuantizedTensor.from_quantized(wq, sc, sc * 3, 3, GS,
                                            scale_dtype=torch.bfloat16, device="cpu")
    else:
        qt, _ = _pair(rng, bits, K, 128)
    x = torch.from_numpy(rng.standard_normal((2, K)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32)).to(torch.bfloat16)
    codes, xs, xsum = act_quant_grouped_plain(x, qt, ags=ags)
    want = qgemm_grouped_plain(x, qt, residual=r, act_gs=ags)
    _, unit, nunits = decode_units(qt.kdim_padded, bits, ags)
    assert unit == ags
    for ksplit in sorted({1, 2, 3, min(8, nunits)}):
        blocks = block_partials_plain(codes, qt, ksplit, ags)
        got = fold_split_plain(blocks, xs, xsum, qt, ksplit, r, ags)
        assert torch.equal(got, want), ksplit


def test_plans_and_limits_of_the_ags_form():
    """decode_plan sizes the ags form's shared memory (a partial and an xs
    an activation group) and finds a cluster at Llama-2-7B W2's shapes;
    K4L streams each activation group's row factors and its weight group's
    column factors through a few slots, so its shared memory is the same
    at any K (no limit on the activation groups) and two blocks fit an SM
    at every depth step, bf16 or f32 scales."""
    for K, M in ((4096, 12288), (4096, 4096), (4096, 22016), (11264, 4096)):
        for N in (1, 4, 16):
            for ags in (32, 64):
                ksplit, nt = decode_plan(N, K, M, 2, GS, ags=ags)
                _, unit, nunits = decode_units(K, 2, ags)
                smem = decode_smem(2, nt, True, nunits, unit, ksplit, K // GS,
                                   acts=K // ags)
                assert smem <= DECODE_SMEM_LIMIT
                assert smem > decode_smem(2, nt, True, nunits, unit, ksplit, K // GS)
    assert k4l_kt(2, GS, 32) == 32 and k4l_kt(2, GS, 64) == 64
    assert k4l_kt(2, GS) == 64 and k4l_kt(3, GS) == 64 and k4l_kt(4, 32) == 32
    for bits in (1, 2, 3, 4):
        for kt in (32, 64):
            assert k4l_smem(bits, kt) < k4l_smem(bits, kt, 4) <= K4L_TWO_BLOCKS
    # a CUDA-only narrowing: ags a multiple of 32; on the CPU any divisor runs
    rng = np.random.default_rng(3)
    qt, _ = _pair(rng, 2, 512, 256)
    x = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    for fn in (qgemm_grouped, qgemm_grouped_large):
        assert torch.equal(fn(x, qt, act_gs=16), qgemm_grouped_plain(x, qt, act_gs=16))
    assert qgemm_grouped.launches == qgemm_grouped_large.launches == 0


# ---------------------------------------------------------------------------
# whole models against JAX's forward(impl="pallas")
# ---------------------------------------------------------------------------

LLAMA_NMSE, MOE_NMSE, TIE_MARGIN = 2e-3, 3e-3, 1e-2
STEPS = 4
_fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))


def model_pair(name, **kw):
    """Both packages' configs of a preset at scaled(8), with replaced
    fields kw (quant fields under quant=)."""
    quant = kw.pop("quant", {})
    out = []
    for preset in (get_preset, jax_preset):
        cfg = dataclasses.replace(preset(name).scaled(8), **kw)
        out.append(cfg.with_quant(**quant) if quant else cfg)
    return out


def port_logits(model, prompt, toks):
    """The port's logits for the prompt and each of toks after it."""
    cache = KVCache.create(model.cfg, 1, 256, device="cpu")
    lg, cache = model(torch.from_numpy(prompt), cache)
    out = [lg[0].numpy()]
    for t in toks:
        lg, cache = model(torch.tensor([[t]]), cache)
        out.append(lg[0].numpy())
    return out


def teacher_forced(cfg, jcfg, prompt_len, steps=STEPS):
    """init_params byte for byte; the port's greedy tokens after a prompt
    of prompt_len; both packages' logits on them (prefill, then steps)."""
    params = init_params(cfg, seed=0, device="cpu")
    jparams = jl.init_params(jcfg, seed=0)
    assert_tree_equal(params, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                cfg, device="cpu"))
    model = Llama(cfg, params)
    prompt = np.random.default_rng(prompt_len).integers(0, cfg.vocab_size, (1, prompt_len))
    cache = KVCache.create(cfg, 1, 256, device="cpu")
    lg, cache = model(torch.from_numpy(prompt), cache)
    toks = [int(lg[0, -1].argmax())]
    for _ in range(steps - 1):
        lg, cache = model(torch.tensor([[toks[-1]]]), cache)
        toks.append(int(lg[0, -1].argmax()))
    jcache = jl.KVCache.create(jcfg, 1, 256)
    lg, jcache = _fwd(jparams, jcfg, jnp.asarray(prompt), jcache, impl="pallas")
    ref = [np.asarray(lg[0])]
    for t in toks:
        lg, jcache = _fwd(jparams, jcfg, jnp.asarray([[t]]), jcache, impl="pallas")
        ref.append(np.asarray(lg[0]))
    return dict(model=model, prompt=prompt, toks=toks, ref=ref,
                got=port_logits(model, prompt, toks))


def check(run, gate):
    for step, (ref, got) in enumerate(zip(run["ref"], run["got"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= gate, (step, nmse(ref, got))
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step


@pytest.fixture(scope="module", params=[8, 72], ids=["prompt8", "prompt72"])
def llama_ags(request):
    """Llama-2-7B W2 g128 with zero points and act_group_size 32 at
    scaled(8), its FFN cut to 512 (so Kp / 4 = 128 everywhere and the
    reference's kernel takes the ags); a 72-token prompt takes K4L's ags
    form."""
    cfg, jcfg = model_pair("llama-2-7b", intermediate_size=512,
                           quant=dict(act_group_size=32))
    return teacher_forced(cfg, jcfg, request.param)


def test_llama2_ags32_matches_jax_pallas(llama_ags):
    check(llama_ags, LLAMA_NMSE)


def test_llama2_ags32_bit_for_bit_given_xla_rsqrt(llama_ags, monkeypatch):
    given_xla_rsqrt(monkeypatch)
    got = port_logits(llama_ags["model"], llama_ags["prompt"], llama_ags["toks"])
    for step, (ref, g) in enumerate(zip(llama_ags["ref"], got)):
        np.testing.assert_array_equal(g, ref, err_msg=f"step {step}")


@pytest.fixture(scope="module")
def mixtral_ags():
    """Mixtral-8x7B w_fp at act_group_size 32 (the experts' FFN cut to
    512) after a 72-token prompt: the dispatch prefill's expert blocks take
    K4's ags form, and at decode the routed experts leave K7, as the
    reference's do, for a gathered copy through it."""
    cfg, jcfg = model_pair("mixtral-8x7b", moe_intermediate_size=512,
                           quant=dict(act_group_size=32))
    return teacher_forced(cfg, jcfg, 72)


def test_mixtral_ags32_steps_match_jax_pallas(mixtral_ags):
    """The decode steps, teacher-forced, at Mixtral's gates."""
    check(dict(ref=mixtral_ags["ref"][1:], got=mixtral_ags["got"][1:]), MOE_NMSE)


def test_mixtral_ags32_prefill_gap_is_xla_rsqrt(mixtral_ags, monkeypatch):
    """The prefill's logits: measured NMSE 2.9e-3 and argmax agreement
    0.958 (one of 72 positions) without XLA's rsqrt values, 6.3e-5 and 1.0
    with them (the same prompt at act_group_size 0: 4.8e-4 and 1.0), so
    the gap is the recorded rsqrt deviation (ROADMAP Queue 3), amplified
    by the router's top-k, as test_torch_forward_options.py's
    test_mixtral_other_prompt_gap_is_xla_rsqrt finds without ags."""
    ref, got = mixtral_ags["ref"][0], mixtral_ags["got"][0]
    assert nmse(ref, got) <= MOE_NMSE
    given_xla_rsqrt(monkeypatch)
    got = port_logits(mixtral_ags["model"], mixtral_ags["prompt"], [])[0]
    assert nmse(ref, got) <= 3e-4
    assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0
