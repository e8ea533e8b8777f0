"""The PyTorch package's GGUF reader and writer against the JAX package's.

The same seeded numpy draws go through both packages: every block type's
bytes as written (``write_gguf``), every field decoder and ``dequantized``
array of the reader, and ``convert_gguf_model``'s config and params byte
for byte (packed codes, f32 or bf16 scales and sub, bf16 embeddings and
norms, the head) for Q4_0, Q4_1, Q4_K, Q8_0, Q2_K, Q3_K, the K-quant mix
with its requantization, the ternary types (per tensor and grouped), the
Mixtral-style MoE, qwen2moe's shared expert and tp=2.  Then the
converted models' logits on the CPU (f32 grouped scales, group size 16
and grouped bits 8 through the kernels' plain versions) against JAX's
``forward(impl="pallas")`` (its kernels in interpret mode), given XLA's
rsqrt values, as tests/test_torch_model_presets.py holds the presets: bit
for bit for the dense models; within test_torch_model_presets_moe.py's
gate for the MoE ones, whose expert kernel XLA compiles in another FMA
pairing (tests/test_torch_expert_kernel.py).  The JAX package's own
tests run these artifacts at ``impl="xla"``; its Pallas kernels take
them all, so they are the reference here.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_gguf import _write_tiny_llama_gguf
from tests.test_torch_model_presets import assert_tree_equal, given_xla_rsqrt
from tests.test_torch_model_presets_moe import MOE_GIVEN_RSQRT_NMSE
from tmac_tpu.convert import gguf as jg
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu_torch.convert import gguf as tg
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.utils import argmax_agreement, nmse

torch.set_num_threads(2)

ALL_TYPES = ("Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K",
             "Q5_K", "Q6_K", "TQ1_0", "TQ2_0", "I2_S", "F16", "F32")
TYPE = {n: getattr(jg, f"GGML_{n}") for n in ALL_TYPES}
TERNARY = ("TQ1_0", "TQ2_0", "I2_S")


def _weights(name, rng, M=32, K=512):
    """A (M, K) float tensor for block type `name` (ternary: trits times a
    scale, so the types' per-tensor form holds)."""
    if name in TERNARY:
        return (rng.integers(-1, 2, (M, K)) * 0.037).astype(np.float32)
    return rng.standard_normal((M, K)).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ALL_TYPES)
def test_write_gguf_bytes_match_jax(name, tmp_path):
    """Each type's file, metadata of every value kind included, byte for
    byte; the port's writer also from a torch tensor and a Lazy tensor."""
    rng = np.random.default_rng(TYPE[name])
    w = _weights(name, rng)
    md = {"general.architecture": "llama", "a.u32": 7, "a.f32": 0.5, "a.bool": True,
          "a.tokens": ["x", "yz"], "a.scores": [0.25, -1.0], "a.types": [1, 2],
          "a.empty": []}
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    jg.write_gguf(jpath, md, {"w": (TYPE[name], w), "n": (jg.GGML_F32, np.ones(5))})
    want = _bytes(jpath)
    for arr in (w, torch.from_numpy(w), tg.Lazy(w.shape, lambda: w)):
        tg.write_gguf(tpath, md, {"w": (TYPE[name], arr), "n": (tg.GGML_F32, np.ones(5))})
        assert _bytes(tpath) == want


def test_write_gguf_stacked_experts_bytes_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((4, 64, 256)).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    tensors = {f"e{t}": (TYPE[t], w) for t in ("Q4_0", "Q4_K", "Q8_0")}
    jg.write_gguf(jpath, {}, tensors)
    tg.write_gguf(tpath, {}, tensors)
    assert _bytes(tpath) == _bytes(jpath)


FIELDS = {"Q4_0": "q4_0_to_quantized", "Q4_1": "q4_1_to_quantized",
          "Q8_0": "q8_0_to_quantized", "Q4_K": "q4_k_to_quantized",
          "Q2_K": "q2_k_to_quantized", "Q3_K": "q3_k_to_quantized"}


@pytest.mark.parametrize("name", ALL_TYPES)
def test_reader_matches_jax(name, tmp_path):
    """Header, metadata, tensor directory, tensor bytes, `dequantized`,
    each field decoder's (wq, scales, sub) and the ternary mappings
    (uniform blocks: per tensor; a block scaled apart: grouped at 256)."""
    rng = np.random.default_rng(100 + TYPE[name])
    w = _weights(name, rng)
    w2 = w.copy()
    w2[:, :256] *= 0.5
    path = str(tmp_path / "t.gguf")
    jg.write_gguf(path, {"general.architecture": "llama", "k": [1.5, 2.5]},
                  {"w": (TYPE[name], w), "w2": (TYPE[name], w2)})
    jr, tr = jg.GGUFReader(path), tg.GGUFReader(path)
    assert (tr.version, tr.metadata, tr.tensors, tr._data_start) == \
        (jr.version, jr.metadata, jr.tensors, jr._data_start)
    for t in ("w", "w2"):
        np.testing.assert_array_equal(tr.tensor_bytes(t), jr.tensor_bytes(t))
        a, b = jr.dequantized(t), tr.dequantized(t)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
        if name in FIELDS:
            for x, y in zip(getattr(jr, FIELDS[name])(t), getattr(tr, FIELDS[name])(t)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(y, x)
        if name in TERNARY:
            jt, tt = jr.ternary_to_quantized(t), tr.ternary_to_quantized(t)
            assert jt[3:] == tt[3:]
            for x, y in zip(jt[:3], tt[:3]):
                np.testing.assert_array_equal(y, x)
            a, b = jr.ternary_block_scales(t), tr.ternary_block_scales(t)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b, a)
    jr.close(), tr.close()


def test_expert_views_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 64, 256)).astype(np.float32)
    path = str(tmp_path / "t.gguf")
    jg.write_gguf(path, {}, {"e": (jg.GGML_Q4_K, w)})
    jr, tr = jg.GGUFReader(path), tg.GGUFReader(path)
    names = tr.expert_views("e")
    assert names == jr.expert_views("e") and tr.tensors == jr.tensors
    for n in names:
        for x, y in zip(jr.q4_k_to_quantized(n), tr.q4_k_to_quantized(n)):
            np.testing.assert_array_equal(y, x)
    jr.close(), tr.close()


def test_tq1_0_all_trit_bytes_and_kquant_scales_match_jax():
    """Every 5-trit combination through TQ1_0's base-3 bytes, and every
    6-bit scale and min through the K-quants' 12-byte packing."""
    combos = np.array(list(itertools.product([-1, 0, 1], repeat=5)), np.float32)
    w = np.zeros((243, 256), np.float32)
    for n in range(5):
        w[:, 32 * n] = combos[:, n]
    w[:, 1] = 1.0
    raw = tg._pack_tq1_0(w)
    assert raw == jg._pack_tq1_0(w)
    raw = np.frombuffer(raw, np.uint8)
    for x, y in zip(jg.GGUFReader._tq1_0_fields(raw), tg.GGUFReader._tq1_0_fields(raw)):
        np.testing.assert_array_equal(y, x)
    rng = np.random.default_rng(8)
    sc6 = rng.integers(0, 64, (64, 8)).astype(np.uint8)
    m6 = rng.integers(0, 64, (64, 8)).astype(np.uint8)
    packed = tg._kq_pack_scales(torch.from_numpy(sc6), torch.from_numpy(m6)).numpy()
    np.testing.assert_array_equal(packed, jg._kq_pack_scales(sc6, m6))
    for x in ([t.numpy() for t in tg.GGUFReader._kq_scale_min(torch.from_numpy(packed))],
              jg.GGUFReader._kq_scale_min(packed)):
        np.testing.assert_array_equal(x[0], sc6)
        np.testing.assert_array_equal(x[1], m6)


# ---------------------------------------------------------------------------
# whole models: convert_gguf_model byte for byte, then the forward
# ---------------------------------------------------------------------------

def _moe_gguf(path, rng, arch="llama", shared=False):
    """A Mixtral-style (or qwen2moe, shared expert and biases) artifact:
    Q4_0 attention, stacked Q4_0 experts ffn_*_exps, an F32 router."""
    H, Ie, V, L, E = 128, 256, 512, 2, 4
    md = {"general.architecture": arch, f"{arch}.embedding_length": H,
          f"{arch}.block_count": L, f"{arch}.attention.head_count": 2,
          f"{arch}.attention.head_count_kv": 2, f"{arch}.feed_forward_length": Ie,
          f"{arch}.vocab_size": V, f"{arch}.rope.freq_base": 1e6,
          f"{arch}.attention.layer_norm_rms_epsilon": 1e-5,
          f"{arch}.attention.key_length": 64, f"{arch}.expert_count": E,
          f"{arch}.expert_used_count": 2}
    if shared:
        md[f"{arch}.expert_feed_forward_length"] = Ie
        md[f"{arch}.expert_shared_feed_forward_length"] = Ie
    std = 1 / np.sqrt(H)
    t = {"token_embd.weight": (jg.GGML_F16, rng.standard_normal((V, H)) * 0.02),
         "output_norm.weight": (jg.GGML_F32, np.ones((H,))),
         "output.weight": (jg.GGML_F16, rng.standard_normal((V, H)) * 0.02)}
    for i in range(L):
        p = f"blk.{i}"
        t[f"{p}.attn_norm.weight"] = (jg.GGML_F32, np.ones((H,)))
        t[f"{p}.ffn_norm.weight"] = (jg.GGML_F32, np.ones((H,)))
        for n, shp in (("attn_q", (128, H)), ("attn_k", (128, H)),
                       ("attn_v", (128, H)), ("attn_output", (H, 128))):
            t[f"{p}.{n}.weight"] = (jg.GGML_Q4_0, rng.standard_normal(shp) * std)
        if shared:
            for n in ("q", "k", "v"):
                t[f"{p}.attn_{n}.bias"] = (jg.GGML_F32, rng.standard_normal(128) * 0.1)
        t[f"{p}.ffn_gate_inp.weight"] = (jg.GGML_F32, rng.standard_normal((E, H)) * 0.02)
        for n, shp in (("ffn_gate_exps", (E, Ie, H)), ("ffn_up_exps", (E, Ie, H)),
                       ("ffn_down_exps", (E, H, Ie))):
            t[f"{p}.{n}.weight"] = (jg.GGML_Q4_0, rng.standard_normal(shp) * std)
        if shared:
            for n, shp in (("ffn_gate_shexp", (Ie, H)), ("ffn_up_shexp", (Ie, H)),
                           ("ffn_down_shexp", (H, Ie))):
                t[f"{p}.{n}.weight"] = (jg.GGML_Q4_0, rng.standard_normal(shp) * std)
            t[f"{p}.ffn_gate_inp_shexp.weight"] = (
                jg.GGML_F32, rng.standard_normal((1, H)) * 0.02)
    jg.write_gguf(path, md, t)


def _rope_llama31_gguf(path, rng, wtype):
    """llama-3.1-8b scaled(8) (its FFN 1792 a multiple of the K-quants'
    256), rewritten with llama.cpp's rope_freqs.weight for its llama3
    scaling."""
    cfg = jax_preset("llama-3.1-8b").scaled(8)
    _write_tiny_llama_gguf(path, cfg, rng, wtype=wtype)
    base, _ = jl._scaled_inv_freqs(cfg.head_dim, cfg.rope_theta, None)
    scaled, _ = jl._scaled_inv_freqs(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    r = jg.GGUFReader(path)
    md = dict(r.metadata)
    full = {n: (info["type"], r.dequantized(n)) for n, info in r.tensors.items()}
    r.close()
    full["rope_freqs.weight"] = (jg.GGML_F32, (base / scaled).astype(np.float32))
    jg.write_gguf(path, md, full)


def _kquant_mix(path, rng):
    _write_tiny_llama_gguf(path, jax_preset("llama-2-7b").scaled(8), rng,
                           wtype=jg.GGML_Q4_K,
                           overrides={"output.weight": jg.GGML_Q6_K,
                                      "token_embd.weight": jg.GGML_Q4_K,
                                      "attn_v.weight": jg.GGML_Q5_K,
                                      "ffn_down.weight": jg.GGML_Q4_0})


def _tiny(preset, wtype, scale=8, **overrides):
    def write(path, rng):
        _write_tiny_llama_gguf(path, jax_preset(preset).scaled(scale), rng,
                               wtype=wtype, overrides=overrides or None)
    return write


def _grouped_ternary(path, rng):
    """TQ2_0 tensors whose 256-blocks carry different scales (each row's
    first block halved): the grouped form (gs 256, f32), the model w_fp;
    llama-3.1-8b scaled(8)'s widths, every K a multiple of 512."""
    cfg = jax_preset("llama-3.1-8b").scaled(8)
    _write_tiny_llama_gguf(path, cfg, rng, wtype=jg.GGML_TQ2_0)
    r = jg.GGUFReader(path)
    md = dict(r.metadata)
    full = {}
    for n, info in r.tensors.items():
        a = r.dequantized(n)
        if info["type"] == jg.GGML_TQ2_0:
            a = a.copy()
            a[:, :256] *= 0.5
        full[n] = (info["type"], a)
    r.close()
    jg.write_gguf(path, md, full)


ARTIFACTS = {
    "q4_0": _tiny("llama-2-7b", jg.GGML_Q4_0),
    "q4_1": _tiny("llama-2-7b", jg.GGML_Q4_1),
    "q8_0": _tiny("llama-2-7b", jg.GGML_Q8_0),
    "q4_k": lambda p, rng: _rope_llama31_gguf(p, rng, jg.GGML_Q4_K),
    "q2_k": lambda p, rng: _rope_llama31_gguf(p, rng, jg.GGML_Q2_K),
    "q3_k": lambda p, rng: _rope_llama31_gguf(p, rng, jg.GGML_Q3_K),
    "kquant_mix": _kquant_mix,
    "mixed_bits": _tiny("llama-2-7b", jg.GGML_Q4_0, **{"attn_v.weight": jg.GGML_Q8_0,
                                                       "ffn_down.weight": jg.GGML_Q8_0}),
    "tq1_0": _tiny("bitnet-3b", jg.GGML_TQ1_0, 12),
    "tq2_0": _tiny("bitnet-3b", jg.GGML_TQ2_0, 12),
    "i2_s": _tiny("bitnet-3b", jg.GGML_I2_S, 12),
    "tq2_0_grouped": _grouped_ternary,
    "moe": lambda p, rng: _moe_gguf(p, rng),
    "qwen2moe": lambda p, rng: _moe_gguf(p, rng, "qwen2moe", shared=True),
}
CONVERTED = {}


def _converted(kind, tmp_path_factory):
    """(path, JAX (cfg, params), the port's (cfg, params)) of an artifact,
    made once per test process."""
    if kind not in CONVERTED:
        path = str(tmp_path_factory.mktemp("gguf") / f"{kind}.gguf")
        ARTIFACTS[kind](path, np.random.default_rng(sum(map(ord, kind))))
        CONVERTED[kind] = (path, jg.convert_gguf_model(path, name=kind),
                           tg.convert_gguf_model(path, name=kind, device="cpu"))
    return CONVERTED[kind]


def _check_same(jcfg, jparams, cfg, params):
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    assert_tree_equal(params, params_from_numpy(tree, cfg, device="cpu"))


@pytest.mark.parametrize("kind", list(ARTIFACTS))
def test_convert_gguf_model_matches_jax(kind, tmp_path_factory):
    """Config field for field, params byte for byte, and each form's
    scales: f32 for the exact block types, bf16 for a requantization."""
    _, (jcfg, jparams), (cfg, params) = _converted(kind, tmp_path_factory)
    _check_same(jcfg, jparams, cfg, params)
    l0 = params["layers"][0]
    qt = l0["wqkv"]
    if kind == "mixed_bits":  # Q8_0 beside Q4_0: all requantized, bf16
        assert qt.scales.dtype == torch.bfloat16 and qt.group_size == 32
        assert l0["down"].bits == 8 and l0["down"].scales.dtype == torch.float32
    elif kind in ("tq1_0", "tq2_0", "i2_s"):
        assert qt.scales.shape[0] == 1 and cfg.quant.mode == "w_a8"
    else:
        assert qt.scales.dtype == torch.float32
    if kind == "q4_k":
        assert cfg.rope_scaling[0] == "factors" and qt.group_size == 32
        assert l0["down"].bits == 4 and params["lm_head"].bits == 8


def test_convert_gguf_model_tp2_matches_jax(tmp_path):
    """tp=2 packs the shards byte for byte as the JAX package does."""
    path = str(tmp_path / "m.gguf")
    _rope_llama31_gguf(path, np.random.default_rng(4), jg.GGML_Q4_K)
    jcfg, jparams = jg.convert_gguf_model(path, tp=2, name="tp2")
    cfg, params = tg.convert_gguf_model(path, tp=2, name="tp2", device="cpu")
    _check_same(jcfg, jparams, cfg, params)
    assert params["layers"][0]["wo"].k_shards == 2


PROMPT, STEPS, TIE_MARGIN = 8, 4, 1e-2
_fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))


def _logits(kind, tmp_path_factory, impl):
    """Greedy tokens of the port's model, then both packages' logits on
    them, teacher-forced (prefill of PROMPT tokens, STEPS decode steps)."""
    _, (jcfg, jparams), (cfg, params) = _converted(kind, tmp_path_factory)
    model = Llama(cfg, params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT))

    def port(toks=None):
        cache = KVCache.create(cfg, 1, 64, device="cpu")
        lg, cache = model(torch.from_numpy(prompt), cache)
        out, toks = [lg[0].numpy()], toks or []
        greedy = toks == []
        for s in range(STEPS):
            if greedy:
                toks.append(int(lg[0, -1].argmax()))
            lg, cache = model(torch.tensor([[toks[s]]]), cache)
            out.append(lg[0].numpy())
        return out, toks
    got, toks = port()
    jcache = jl.KVCache.create(jcfg, 1, 64)
    lg, jcache = _fwd(jparams, jcfg, jnp.asarray(prompt), jcache, impl=impl)
    ref = [np.asarray(lg[0], np.float32)]
    for t in toks:
        lg, jcache = _fwd(jparams, jcfg, jnp.asarray([[t]]), jcache, impl=impl)
        ref.append(np.asarray(lg[0], np.float32))
    return ref, lambda: port(toks)[0]


@pytest.mark.parametrize("kind", ["q4_k", "q4_0", "q2_k", "q3_k", "kquant_mix",
                                  "mixed_bits", "tq1_0", "tq2_0_grouped"])
def test_forward_bit_for_bit_given_xla_rsqrt(kind, tmp_path_factory, monkeypatch):
    """The logits of a prefill and teacher-forced decode steps against
    forward(impl="pallas"), bit for bit given XLA's rsqrt: f32 grouped
    scales (K4's function; llama3 rope from rope_freqs.weight), group
    size 16 at bits 2 and 3, a fused requantized QKV and a grouped bits-8
    down, per-tensor and grouped ternary weights."""
    ref, port = _logits(kind, tmp_path_factory, "pallas")
    given_xla_rsqrt(monkeypatch)
    for step, (r, g) in enumerate(zip(ref, port())):
        np.testing.assert_array_equal(g, r, err_msg=f"step {step}")


@pytest.mark.parametrize("kind", ["moe", "qwen2moe"])
def test_moe_forward_given_xla_rsqrt(kind, tmp_path_factory, monkeypatch):
    """Q4_0 experts with f32 scales through K7's function (the select
    form), held to forward(impl="pallas") within the MoE gate given XLA's
    rsqrt (measured on the CPU: NMSE up to 8.7e-5), argmax 1.0."""
    ref, port = _logits(kind, tmp_path_factory, "pallas")
    given_xla_rsqrt(monkeypatch)
    for step, (r, g) in enumerate(zip(ref, port())):
        assert np.isfinite(g).all() and nmse(r, g) <= MOE_GIVEN_RSQRT_NMSE, step
        assert argmax_agreement(r, g, TIE_MARGIN) == 1.0, step


@pytest.mark.parametrize("bits,gs,K,M,k_shards,m_shards", [
    (4, 32, 512, 256, 1, 1), (4, 32, 480, 200, 1, 1), (4, 32, 1024, 256, 2, 2),
    (2, 16, 512, 384, 1, 1), (3, 16, 512, 128, 1, 1), (1, 64, 640, 128, 2, 1),
    (8, 32, 256, 100, 1, 1), (2, 512, 512, 256, 1, 1), (2, 256, 512, 256, 2, 1)])
def test_from_quantized_on_the_device_matches_numpy(bits, gs, K, M, k_shards, m_shards):
    """QuantizedTensor.from_quantized given numpy arrays and given torch
    tensors (the path a Q4_K tensor takes on the card) pads and packs to
    the JAX package's numpy bytes: every bits, padded K and M, shards,
    per-tensor scales."""
    rng = np.random.default_rng(bits * 100 + gs + K + M)
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    G = k_shards if gs >= K // k_shards else K // gs
    sc = rng.random((G, M)).astype(np.float32)
    sub = rng.random((G, M)).astype(np.float32)
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor
    kw = dict(bits=bits, group_size=gs, k_shards=k_shards, m_shards=m_shards,
              scale_dtype=torch.float32, device="cpu")
    from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
    ref = JQT.from_quantized(wq, sc, sub, bits=bits, group_size=gs, k_shards=k_shards,
                             m_shards=m_shards, device_put=False)
    for args in (wq, sc, sub), tuple(map(torch.from_numpy, (wq, sc, sub))):
        qt = QuantizedTensor.from_quantized(*args, **kw)
        for f in ("bits", "group_size", "k_shards", "m_shards", "shape"):
            assert getattr(qt, f) == getattr(ref, f), f
        assert (qt.packed_hi is None) == (ref.packed_hi is None)
        for f in ("packed", "packed_hi", "scales", "sub"):
            if getattr(ref, f) is not None:
                np.testing.assert_array_equal(getattr(qt, f).numpy(), np.asarray(getattr(ref, f)))


def test_torch_packers_give_the_numpy_bytes():
    """write_gguf's tensor bytes for CPU tensors and for numpy arrays (Q4_K,
    Q5_K and Q8_0 pack in torch, F16 and F32 convert in numpy) against the
    JAX package's numpy packers, on normal draws, blocks of zeros,
    all-positive rows and tiny values."""
    rng = np.random.default_rng(5)
    for scale in (1.0, 1e-3):
        w = (rng.standard_normal((64, 512)) * scale).astype(np.float32)
        w[:, :32] = 0.0
        w[5] = np.abs(w[5])
        for a in w, torch.from_numpy(w):
            for tt, ref in ((tg.GGML_Q4_K, jg._pack_q4_k(w)), (tg.GGML_Q5_K, jg._pack_q5_k(w)),
                            (tg.GGML_Q8_0, jg._pack_q8_0(w)),
                            (tg.GGML_F16, w.astype(np.float16).tobytes()),
                            (tg.GGML_F32, w.astype(np.float32).tobytes())):
                assert tg._tensor_data(tt, a) == ref, tt
