"""Per-channel w_fp (group_size=-1: one f32 scale and zero point a column,
the activations int8 per token) against the JAX package.

JAX runs such weights through qgemm_pallas(act="fused") with one scale
row: below 64 rows its fused G = 1 kernel (K1 in the port), from 64 rows
its XLA prologue and the external-int8 kernel, single_dot at bits 1, 2 and
4 and the chunk loop with int32 sums at bits 3 (K3).  At the ops level the
port's plain version equals JAX's interpret-mode kernel bit for bit at bits
1, 3 and 4, N = 4 and 64, a padded K and per-column zero points; so does
K1's split of the int32 sums at bits 3 (2 + 1 planes).

The models: llama-3.1-8b scaled(8) at bits 1 to 4, with and without zero
points, teacher-forced against forward(impl="pallas") on a 64-token prompt
(K3 on every linear and the int8 head) and decode steps (K1), given XLA's
rsqrt values (tests/test_torch_model.py's docstring says why) and XLA's
outputs of each layer's prefill rope and attention: on this config XLA
computes the rope's cos, sin and multiply-adds and the attention's f32
masked softmax and dots of a 64-token prefill to other last bits inside
the jitted forward than torch does (and than the same functions jitted
alone do), and a bf16 rounding of them moved an int8 code at bits 2 with
zero points (NMSE up to 3.5e-4 on a decode step, measured on the CPU).
Each recorded input is held equal to the port's own first, so only the
step's last bits are given; the logits then agree bit for bit at every
bits (measured on the CPU), held here at the model gate, NMSE <=
1e-4 and argmax 1.0.  Mixtral-8x7B scaled(8) per channel at bits 3 (no hi
plane in K7's scope, so the experts run K1 and K3, the select form on
gathered copies) within Mixtral's gate given XLA's rsqrt
(tests/test_torch_model.py: the router's and combine's f32 ulps; measured
4.9e-5 to 9.4e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_act_groups import check
from tests.test_torch_model import _given_xla_rsqrt
from tests.test_torch_model_presets import assert_tree_equal
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models import llama as tl
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
from tmac_tpu_torch.ops.cuda.expert_kernel import expert_kernel_supported
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, route
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

PROMPT, STEPS = 64, 3
LOGITS_NMSE = 1e-4
MOE_NMSE, MOE_PROMPT = 3e-4, 128


def _pair(rng, bits, K, M, zero_point):
    """Random codes with one f32 scale and zero point a column (on each
    column's mean code, jittered, as init_params draws them), as a port and
    a JAX QuantizedTensor."""
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    s = ((0.5 + rng.random((1, M))) / np.sqrt(K)).astype(np.float32)
    zq = np.clip(wq.mean(0, keepdims=True).round() + rng.integers(-2, 3, (1, M)), 0,
                 (1 << bits) - 1) if zero_point else np.full((1, M), 1 << (bits - 1))
    sub = (s * zq).astype(np.float32)
    return (QuantizedTensor.from_quantized(wq, s, sub, bits, K, device="cpu"),
            JQT.from_quantized(wq, s, sub, bits, K))


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [4, 64])
@pytest.mark.parametrize("bits", [1, 3, 4])
def test_plain_equals_pallas_bit_for_bit(bits, N):
    """K = 1000 pads to 1024 at bits 1 and 3 (4 x 8 fields) and stays at
    bits 4.  N = 4 is K1's route, 64 K3's."""
    rng = np.random.default_rng(10 * bits + N)
    K, M = 1000, 384
    qt, jqt = _pair(rng, bits, K, M, True)
    assert qt.kdim_padded == (1024 if bits in (1, 3) else 1000)
    assert route(qt, N) == ("K3" if N >= 64 else "K1")
    x = jnp.asarray(rng.standard_normal((N, K)), jnp.bfloat16)
    want = jax.jit(lambda x: qgemm_pallas(x, jqt, act="fused", out_dtype=jnp.float32,
                                          interpret=True))(x)
    got = k1.qgemm_fused_plain(torch.from_numpy(np.array(x.astype(jnp.float32)))
                               .to(torch.bfloat16), qt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ksplit", range(1, 9))
def test_split_int_dot_at_bits3(ksplit):
    """K1's split of the int32 sums at bits 3 (a row: lo rows r and r + Kb,
    hi row r; decode_slot_weights) equals the plain int dot, at a K whose
    rows leave the last unit ragged."""
    rng = np.random.default_rng(ksplit)
    qt, _ = _pair(rng, 3, 2080, 256, True)
    codes = torch.from_numpy(rng.integers(-127, 128, (3, qt.kdim_padded)).astype(np.int8))
    want = k1.int_dot_plain(codes, qt)
    assert torch.equal(k1.int_dot_split_plain(codes, qt, ksplit), want)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_k3_order_meets_whole_packed_rows(bits):
    """K3's code order (dp4a_order): k' = F r + j holds k = r + j Kp / F, so
    the weights in the same order are F consecutive k' a packed row (bits
    3: lo rows r and r + Kp/8, hi row r), and the int dot is unchanged."""
    rng = np.random.default_rng(bits)
    K = 512
    wq = rng.integers(0, 1 << bits, (K, 128)).astype(np.uint8)
    s = np.full((1, 128), 0.01, np.float32)
    qt = QuantizedTensor.from_quantized(wq, s, s, bits, K, device="cpu")
    F = k1.decode_fields(bits)
    order = k1.dp4a_order(torch.arange(K)[None], bits)[0].numpy()
    np.testing.assert_array_equal(order.reshape(K // F, F),
                                  np.arange(K // F)[:, None] + np.arange(F) * (K // F))
    codes = torch.from_numpy(rng.integers(-127, 128, (2, K)).astype(np.int8))
    w = k1.dp4a_order(k1.unpack_codes(qt).t(), bits).t()
    assert torch.equal((k1.dp4a_order(codes, bits).long() @ w.long()).int(),
                       k1.int_dot_plain(codes, qt))


def test_epilogues_take_per_column_sub():
    """Both epilogues read sub (1, Mp) per column: a column's output moves
    with its own zero point only."""
    rng = np.random.default_rng(5)
    qt, _ = _pair(rng, 4, 256, 256, True)
    acc = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (3, 256)).astype(np.int32))
    xs, xsum = torch.rand(3) + 0.5, torch.randn(3) * 100
    for epilogue in (k1.decode_epilogue_plain, k1.large_epilogue_plain):
        base = epilogue(acc, xs, xsum, qt)
        moved = dataclasses.replace(qt, sub=qt.sub.clone())
        moved.sub[0, 7] += 1.0
        diff = (epilogue(acc, xs, xsum, moved) != base).any(0)
        assert diff[7] and diff.sum() == 1


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

# the prefill ropes and attentions recorded inside JAX's jitted forward
# (module-level, so that a forward compiled in one test records into them in
# the next), and JAX's jitted forwards by config
_RECORD = dict(ropes=[], attns=[])
_FORWARDS = {}


def _given_xla_prefill_steps(monkeypatch):
    """Record each layer's prefill rope (of q, then k) and attention inside
    JAX's jitted forward, and give the port's prefill the recorded outputs,
    each once the port's own input equals the recorded one."""
    for rec in _RECORD.values():
        rec.clear()
    rope, attention = jl.rope, jl._attention

    def keep(name):
        return lambda a, o: _RECORD[name].append((np.asarray(a, np.float32),
                                                  np.asarray(o, np.float32)))

    def recording_rope(x, tables):
        out = rope(x, tables)
        if x.shape[1] > 1:
            jax.debug.callback(keep("ropes"), x, out)
        return out

    def recording_attention(q, k_all, v_all, li, *args, **kw):
        out = attention(q, k_all, v_all, li, *args, **kw)
        if q.shape[1] > 1:
            jax.debug.callback(keep("attns"), q, out)
        return out

    def given(name, x):
        rec = _RECORD[name]
        i = next(i for i, (a, _) in enumerate(rec) if a.shape == tuple(x.shape))
        a, out = rec.pop(i)
        np.testing.assert_array_equal(x.float().numpy(), a)
        return torch.from_numpy(out).to(x.dtype)

    port_rope = tl.rope
    monkeypatch.setattr(jl, "rope", recording_rope)
    monkeypatch.setattr(jl, "_attention", recording_attention)
    monkeypatch.setattr(tl, "rope", lambda x, tables: given("ropes", x) if x.shape[1] > 1
                        else port_rope(x, tables))
    monkeypatch.setattr(tl.Llama, "_prefill_attention", lambda self, q, *a: given("attns", q))


def _forward(jcfg):
    """JAX's forward(impl="pallas") jitted for jcfg, recording its prefill
    steps.  The forward reads no zero_point (only init_params draws by
    it), so a config's two zero-point forms share one compilation."""
    key = dataclasses.replace(jcfg, quant=dataclasses.replace(jcfg.quant, zero_point=False))
    if key not in _FORWARDS:
        _FORWARDS[key] = jax.jit(lambda p, t, c: jl.forward(p, key, t, c, impl="pallas"))
    return _FORWARDS[key]


def _routes(monkeypatch):
    """Count the rows of every call of K1's and K3's entry points."""
    rows = {"K1": [], "K3": []}
    for name, fn in (("K1", "qgemm_fused"), ("K3", "qgemm_large_int")):
        def spy(x, *a, _k=name, _f=getattr(k1, fn), **kw):
            rows[_k].append(x.shape[0])
            return _f(x, *a, **kw)
        monkeypatch.setattr(k1, fn, spy)
    return rows


def _teacher_forced(cfg, jcfg, prompt_len, monkeypatch):
    """init_params byte for byte; JAX's prefill (recording its attention),
    the port's (given it) and greedy steps; JAX's steps on the port's
    tokens.  -> the logits of both and the rows K1 and K3 took."""
    _given_xla_rsqrt(monkeypatch)
    _given_xla_prefill_steps(monkeypatch)
    params = init_params(cfg, seed=0, device="cpu")
    jparams = jl.init_params(jcfg, seed=0)
    assert_tree_equal(params, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                cfg, device="cpu"))
    fwd = _forward(jcfg)
    prompt = np.random.default_rng(prompt_len).integers(0, cfg.vocab_size, (1, prompt_len))
    lg, jcache = fwd(jparams, jnp.asarray(prompt), jl.KVCache.create(jcfg, 1, 256))
    ref = [np.asarray(lg[0])]
    assert len(_RECORD["ropes"]) == 2 * len(_RECORD["attns"]) == 2 * cfg.num_layers
    rows = _routes(monkeypatch)
    model = Llama(cfg, params)
    lg, cache = model(torch.from_numpy(prompt), KVCache.create(cfg, 1, 256, device="cpu"))
    got, toks = [lg[0].numpy()], [int(lg[0, -1].argmax())]
    assert not _RECORD["ropes"] and not _RECORD["attns"]
    for _ in range(STEPS):
        lg, cache = model(torch.tensor([[toks[-1]]]), cache)
        got.append(lg[0].numpy())
        toks.append(int(lg[0, -1].argmax()))
    for t in toks[:STEPS]:
        lg, jcache = fwd(jparams, jnp.asarray([[t]]), jcache)
        ref.append(np.asarray(lg[0]))
    return dict(ref=ref, got=got, params=params, rows=rows)


@pytest.mark.parametrize("zero_point", [False, True], ids=["sym", "zp"])
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_llama31_per_channel_matches_jax_pallas(bits, zero_point, monkeypatch):
    """One f32 scale row per linear; the prompt takes K3 on the four
    linears a layer and the int8 head, each step K1."""
    cfg, jcfg = (p("llama-3.1-8b", bits=bits).scaled(8).with_quant(
        group_size=-1, zero_point=zero_point) for p in (get_preset, jax_preset))
    run = _teacher_forced(cfg, jcfg, PROMPT, monkeypatch)
    wqkv = run["params"]["layers"][0]["wqkv"]
    assert wqkv.scales.shape[0] == 1 and wqkv.scales.dtype == torch.float32
    assert (wqkv.packed_hi is not None) == (bits == 3)
    per_pass = 4 * cfg.num_layers + 1
    assert run["rows"]["K3"] == [PROMPT] * per_pass
    assert run["rows"]["K1"] == [1] * per_pass * STEPS
    check(run, LOGITS_NMSE)


def test_mixtral_per_channel_bits3_matches_jax_pallas(monkeypatch):
    """Mixtral-8x7B scaled(8) per channel at bits 3, its expert FFN raised
    to 512 (unpadded, so the SwiGLU folds into down on both sides): a
    128-token dispatch prefill (expert blocks of 64 slots on K3) and select
    steps on gathered copies of the routed experts (K1: a hi plane is out
    of K7's scope, as of JAX's expert kernel)."""
    cfg, jcfg = (dataclasses.replace(p("mixtral-8x7b", bits=3).scaled(8),
                                     moe_intermediate_size=512).with_quant(group_size=-1)
                 for p in (get_preset, jax_preset))
    run = _teacher_forced(cfg, jcfg, MOE_PROMPT, monkeypatch)
    assert not expert_kernel_supported(run["params"]["layers"][0]["experts_gate_up"])
    assert 64 in run["rows"]["K3"] and 1 in run["rows"]["K1"]
    check(run, MOE_NMSE)
