"""The port's converters (tmac_tpu_torch/convert/{bitnet,gptq,hf}.py)
against the JAX package's (tmac_tpu/convert/), on the CPU: a counterpart of
every converter test of tests/test_convert.py, where each synthetic
Hugging Face directory is converted by both packages and the port's params
must equal params_from_numpy(JAX's) byte for byte, its logits held to JAX's
forward(impl="pallas") under the model gate of tests/test_torch_model.py
(NMSE <= 1e-4 and tie-aware argmax agreement 1.0, the port given XLA's
rsqrt values).  Beyond them: a sharded directory, bf16 and tied heads, a
BitNet float checkpoint, and tp = 2 packing."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from tests.test_convert import (_write_synthetic_hf_awq,
                                _write_synthetic_hf_gptq,
                                _write_synthetic_hf_moe)
from tests.test_torch_model import (LOGITS_NMSE, TIE_MARGIN, _assert_tree_equal,
                                    _given_xla_rsqrt)
from tmac_tpu.convert import bitnet as jbitnet
from tmac_tpu.convert import gptq as jgptq
from tmac_tpu.convert import hf as jhf
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import QuantConfig as JQuantConfig
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu_torch.convert.bitnet import is_ternary, quantize_bitnet
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.convert.gptq import (_unpack_int32_fields, parse_gptq,
                                         quantize_awq_like, quantize_gptq_like,
                                         unpack_awq, unpack_gptq)
from tmac_tpu_torch.convert.hf import (HFReader, _qt_from_hf_linear,
                                       convert_hf_model)
from tmac_tpu_torch.models.config import QuantConfig
from tmac_tpu_torch.models.llama import KVCache, Llama
from tmac_tpu_torch.models.moe import expert_view, num_local_experts
from tmac_tpu_torch.ops.packing import dequantize
from tmac_tpu_torch.ops.qgemm import qgemm_torch
from tmac_tpu_torch.utils import argmax_agreement, nmse

torch.set_num_threads(2)

_jfwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))
PROMPT = np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]])


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _convert_both(path, monkeypatch, name, jquant=None, quant=None, **kw):
    """Both packages' conversions of the directory: the configs equal, the
    port's params byte for byte JAX's carried over; the port's prompt
    logits held to JAX's forward(impl="pallas") under the model gate.
    -> (cfg, params, JAX's params)."""
    jcfg, jparams = jhf.convert_hf_model(str(path), quant=jquant, name=name, **kw)
    cfg, params = convert_hf_model(str(path), quant=quant, name=name, device="cpu",
                                   **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    _assert_tree_equal(params, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                 cfg, device="cpu"))
    if kw.get("tp", 1) == 1:
        _given_xla_rsqrt(monkeypatch)
        ref, _ = _jfwd(jparams, jcfg, jnp.asarray(PROMPT),
                       jl.KVCache.create(jcfg, 1, 16), impl="pallas")
        got, _ = Llama(cfg, params)(torch.from_numpy(PROMPT),
                                    KVCache.create(cfg, 1, 16, device="cpu"))
        ref, got = np.asarray(ref[0], np.float32), got[0].numpy()
        assert np.isfinite(got).all()
        assert nmse(ref, got) <= LOGITS_NMSE
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0
    return cfg, params, jparams


def _float(x, qt):
    """The float qgemm of x (N, K) numpy with qt -> (N, M) numpy."""
    return qgemm_torch(torch.from_numpy(x), qt).float().numpy()


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_gptq_roundtrip(bits):
    rng = np.random.default_rng(0)
    K, M, gs = 256, 128, 64
    w = rng.standard_normal((K, M)).astype(np.float32)
    packed = quantize_gptq_like(w, bits, gs)
    _same(packed, jgptq.quantize_gptq_like(w, bits, gs))
    assert parse_gptq(*packed) == (K, M, bits, gs)
    got = unpack_gptq(*packed, gptq_v2=True)
    _same(got, jgptq.unpack_gptq(*packed, gptq_v2=True))
    wq, s, sub, b, g = got
    assert (b, g) == (bits, gs)
    # affine quantization error <= half a step
    step = np.repeat(s, gs, axis=0)
    assert np.abs(dequantize(wq, s, sub, gs) - w).max() <= 0.5 * step.max() + 1e-3


def test_gptq_v1_zeros_quirk():
    """AutoGPTQ v1 stores z - 1; unpacking with gptq_v2=False adds it back."""
    rng = np.random.default_rng(1)
    K, M, gs, bits = 128, 64, 64, 4
    w = rng.standard_normal((K, M)).astype(np.float32)
    qweight, scales, qzeros = quantize_gptq_like(w, bits, gs)
    z = qzeros.view(np.uint32).astype(np.int64)
    unpacked = np.stack([(z >> (4 * j)) & 15 for j in range(8)], -1) - 1
    z1 = np.zeros_like(z)
    for j in range(8):
        z1 |= (unpacked[..., j] & 15) << (4 * j)
    qzeros_v1 = z1.astype(np.uint32).view(np.int32)
    v1 = unpack_gptq(qweight, scales, qzeros_v1, gptq_v2=False)
    v2 = unpack_gptq(qweight, scales, qzeros, gptq_v2=True)
    _same(v1, jgptq.unpack_gptq(qweight, scales, qzeros_v1, gptq_v2=False))
    np.testing.assert_allclose(v2[2], v1[2], rtol=1e-6)
    np.testing.assert_array_equal(v2[0], v1[0])


def test_bitnet_quantize():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    wq, scales, sub = quantize_bitnet(w)
    _same((wq, scales, sub), jbitnet.quantize_bitnet(w))
    assert set(np.unique(wq)) <= {1, 2, 3}
    wdq = scales[0] * wq.astype(np.float32) - sub[0]
    assert is_ternary(wdq) and is_ternary(wdq) == jbitnet.is_ternary(wdq)
    assert not is_ternary(w)
    # absmean recipe: scale == mean |w|
    np.testing.assert_allclose(scales[0, 0], np.abs(w).mean(), rtol=1e-5)


def test_convert_hf_gptq_end_to_end(tmp_path, monkeypatch):
    cfg0 = jax_preset("llama-2-7b").scaled(8)
    ref = _write_synthetic_hf_gptq(str(tmp_path), cfg0, bits=2, gs=128)
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, "tiny-test")
    assert cfg.quant.bits == 2 and cfg.quant.zero_point
    # one linear alone: the qgemm equals the dequant oracle, and stays
    # within 2-bit quantization noise of the original
    qt_q = _qt_from_hf_linear(HFReader(str(tmp_path)),
                              "model.layers.0.self_attn.q_proj", cfg.quant, True,
                              1, 1, device="cpu")
    wdq = dequantize(qt_q.unpack().numpy(),
                     qt_q.scales.float().numpy()[:, :qt_q.mdim],
                     qt_q.sub.float().numpy()[:, :qt_q.mdim], qt_q.group_size)
    x = np.random.default_rng(3).standard_normal((2, cfg.hidden_size)).astype(np.float32)
    got = _float(x, qt_q)
    assert nmse(x @ wdq, got) < 1e-10
    assert nmse(x @ ref["model.layers.0.self_attn.q_proj"], got) < 0.5
    # the fused wqkv's q slice equals the standalone conversion
    assert nmse(got, _float(x, params["layers"][0]["wqkv"])[:, :cfg.q_dim]) < 1e-10


def test_gptq_b3_codes_exact():
    """The 3-bit straddle layout (32 codes in 3 words, codes 10 and 21 split
    across words) round-trips every code exactly, weights and zeros."""
    rng = np.random.default_rng(6)
    K, M, gs = 96, 64, 32
    codes = rng.integers(0, 8, (K, M)).astype(np.int64)
    codes[::gs, :] = 0
    codes[1::gs, :] = 7
    w = codes.astype(np.float32)
    qweight, scales, qzeros = quantize_gptq_like(w, 3, gs)
    np.testing.assert_array_equal(scales.astype(np.float32), 1.0)
    wq, s, sub, b, g = unpack_gptq(qweight, scales, qzeros, gptq_v2=True)
    assert b == 3 and g == gs
    np.testing.assert_array_equal(wq.astype(np.int64), codes)
    np.testing.assert_array_equal(
        _unpack_int32_fields(qweight.view(np.uint32).astype(np.int64), 3, 0),
        jgptq._unpack_int32_fields(qweight.view(np.uint32).astype(np.int64), 3, 0))
    np.testing.assert_array_equal(sub, 0.0)
    np.testing.assert_array_equal(dequantize(wq, s, sub, gs), w)


def test_convert_hf_gptq_b3_end_to_end(tmp_path, monkeypatch):
    """bits=3 HF GPTQ -> lo and hi planes -> the model runs."""
    cfg0 = jax_preset("llama-2-7b").scaled(8)
    ref = _write_synthetic_hf_gptq(str(tmp_path), cfg0, bits=3, gs=128)
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, "tiny-b3")
    qt = params["layers"][0]["wqkv"]
    assert cfg.quant.bits == 3 and qt.bits == 3 and qt.packed_hi is not None
    x = np.random.default_rng(7).standard_normal((2, cfg.hidden_size)).astype(np.float32)
    got = _float(x, qt)[:, :cfg.q_dim]
    assert nmse(x @ ref["model.layers.0.self_attn.q_proj"], got) < 5e-2


def test_convert_hf_moe_end_to_end(tmp_path, monkeypatch):
    """Mixtral-style MoE GPTQ -> stacked experts; expert 1's gate_up within
    2-bit noise of the original weights."""
    ref = _write_synthetic_hf_moe(str(tmp_path), bits=2, gs=64, E=4)
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, "tiny-moe")
    assert cfg.num_experts == 4 and cfg.num_experts_per_tok == 2
    assert cfg.moe_intermediate_size == 128
    layer = params["layers"][0]
    assert layer["moe_router"].shape == (cfg.hidden_size, 4)
    assert num_local_experts(layer["experts_gate_up"]) == 4
    x = np.random.default_rng(3).standard_normal((2, cfg.hidden_size)).astype(np.float32)
    got = _float(x, expert_view(layer["experts_gate_up"], 1))
    p = "model.layers.0.block_sparse_moe.experts.1"
    assert nmse(x @ ref[f"{p}.w1"], got[:, :128]) < 0.5
    assert nmse(x @ ref[f"{p}.w3"], got[:, 128:256]) < 0.5


def _write_synthetic_hf_qwen2moe(tmpdir, E=4, seed=14):
    """test_convert.py's Qwen2-MoE checkpoint: mlp.experts.{e} naming, a
    sigmoid-gated shared expert, norm_topk_prob=False, q/k/v biases."""
    rng = np.random.default_rng(seed)
    H, Ie, Is, V, L = 128, 128, 128, 512, 2
    tensors, shared = {}, {}

    def fp(name, shape, scale=0.02):
        tensors[name] = (rng.standard_normal(shape) * scale).astype(np.float16)

    def gptq(name, K, M):
        w = (rng.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32)
        qw, sc, qz = jgptq.quantize_gptq_like(w, 2, 64)
        tensors.update({f"{name}.qweight": qw, f"{name}.scales": sc,
                        f"{name}.qzeros": qz})
        return w

    fp("model.embed_tokens.weight", (V, H))
    for i in range(L):
        p = f"model.layers.{i}"
        fp(f"{p}.input_layernorm.weight", (H,), 1.0)
        fp(f"{p}.post_attention_layernorm.weight", (H,), 1.0)
        for n, shp in (("q_proj", (256, H)), ("k_proj", (256, H)),
                       ("v_proj", (256, H)), ("o_proj", (H, 256))):
            gptq(f"{p}.self_attn.{n}", shp[1], shp[0])
        for n in ("q_proj", "k_proj", "v_proj"):
            fp(f"{p}.self_attn.{n}.bias", (256,))
        fp(f"{p}.mlp.gate.weight", (E, H))
        for e in range(E):
            for n, K, M in (("gate_proj", H, Ie), ("up_proj", H, Ie),
                            ("down_proj", Ie, H)):
                gptq(f"{p}.mlp.experts.{e}.{n}", K, M)
        se = f"{p}.mlp.shared_expert"
        shared[i] = gptq(f"{se}.gate_proj", H, Is)
        gptq(f"{se}.up_proj", H, Is)
        gptq(f"{se}.down_proj", Is, H)
        fp(f"{p}.mlp.shared_expert_gate.weight", (1, H))
    fp("model.norm.weight", (H,), 1.0)
    fp("lm_head.weight", (V, H))
    save_file(tensors, os.path.join(tmpdir, "model.safetensors"))
    with open(os.path.join(tmpdir, "config.json"), "w") as f:
        json.dump({
            "model_type": "qwen2_moe", "vocab_size": V, "hidden_size": H,
            "intermediate_size": Ie, "num_hidden_layers": L,
            "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 128,
            "rope_theta": 1e6, "rms_norm_eps": 1e-6, "num_experts": E,
            "num_experts_per_tok": 2, "moe_intermediate_size": Ie,
            "shared_expert_intermediate_size": Is, "norm_topk_prob": False,
            "tie_word_embeddings": False,
            "quantization_config": {
                "bits": 2, "group_size": 64, "sym": False, "desc_act": False,
                "checkpoint_format": "gptq_v2", "quant_method": "gptq"},
        }, f)
    return shared


def test_convert_hf_qwen2moe_end_to_end(tmp_path, monkeypatch):
    """Qwen2-MoE: the shared expert and its gate land; the shared gate_proj
    within 2-bit noise of the original."""
    shared = _write_synthetic_hf_qwen2moe(str(tmp_path))
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, "tiny-qwen2moe")
    assert cfg.num_experts == 4 and not cfg.moe_norm_topk
    assert cfg.moe_shared_intermediate_size == 128 and cfg.moe_shared_gate
    assert cfg.attention_bias
    layer = params["layers"][0]
    assert "shared_gate_up" in layer and layer["shared_gate"].shape == (cfg.hidden_size,)
    x = np.random.default_rng(15).standard_normal((2, 128)).astype(np.float32)
    assert nmse(x @ shared[0], _float(x, layer["shared_gate_up"])[:, :128]) < 0.5


def test_awq_unpack_matches_dequant_contract():
    """unpack_awq reverses the AWQ interleave; dequantized within 4-bit
    noise of the original, and byte for byte JAX's."""
    rng = np.random.default_rng(7)
    K, gs = 256, 64
    w = rng.standard_normal((K, 96 * 8)).astype(np.float32) / np.sqrt(K)
    packed = quantize_awq_like(w, gs)
    _same(packed, jgptq.quantize_awq_like(w, gs))
    got = unpack_awq(*packed)
    _same(got, jgptq.unpack_awq(*packed))
    wq, scales, sub, bits, g = got
    assert (bits, g) == (4, gs)
    wdq = np.repeat(scales, gs, 0) * wq - np.repeat(sub, gs, 0)
    assert nmse(w, wdq) < 2e-2


def test_convert_hf_awq_end_to_end(tmp_path, monkeypatch):
    """AWQ 'gemm' -> packed params; wo within 4-bit noise of the original;
    generate runs."""
    from tmac_tpu_torch.runtime.generate import generate
    cfg0 = jax_preset("llama-2-7b").scaled(8)
    ref = _write_synthetic_hf_awq(str(tmp_path), cfg0, gs=64)
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, "tiny-awq")
    assert (cfg.quant.bits, cfg.quant.group_size, cfg.quant.zero_point) == (4, 64, True)
    x = np.random.default_rng(9).standard_normal((2, cfg.hidden_size)).astype(np.float32)
    got = _float(x, params["layers"][0]["wo"])
    assert nmse(x @ ref["model.layers.0.self_attn.o_proj"], got) < 2e-2
    out = generate(Llama(cfg, params), np.asarray([[1, 2, 3]], np.int32), 4)
    assert tuple(out.shape) == (1, 4)


def _bf16_bits(a):
    """float32 -> bf16 bit patterns (round to nearest even), as uint16."""
    return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _write_float_checkpoint(tmpdir, cfg, tied, sharded, bf16):
    """A float (fp16 or bf16) llama-architecture checkpoint, in one file or
    two shards with an index."""
    rng = np.random.default_rng(21)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    tensors = {}

    def fp(name, shape, scale):
        tensors[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    fp("model.embed_tokens.weight", (V, H), 0.02)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        fp(f"{p}.input_layernorm.weight", (H,), 1.0)
        fp(f"{p}.post_attention_layernorm.weight", (H,), 1.0)
        for n, M, K in (("self_attn.q_proj", cfg.q_dim, H), ("self_attn.k_proj", cfg.kv_dim, H),
                        ("self_attn.v_proj", cfg.kv_dim, H), ("self_attn.o_proj", H, cfg.q_dim),
                        ("mlp.gate_proj", I, H), ("mlp.up_proj", I, H),
                        ("mlp.down_proj", H, I)):
            fp(f"{p}.{n}.weight", (M, K), 1.0 / np.sqrt(K))
    fp("model.norm.weight", (H,), 1.0)
    if not tied:
        fp("lm_head.weight", (V, H), 0.02)
    if bf16:
        files = {k: _bf16_bits(v) for k, v in tensors.items()}
    else:
        files = {k: v.astype(np.float16) for k, v in tensors.items()}
    names = sorted(files)
    shards = [names[::2], names[1::2]] if sharded else [names]
    weight_map = {}
    for j, part in enumerate(shards):
        fname = f"model-{j:05d}-of-{len(shards):05d}.safetensors" if sharded \
            else "model.safetensors"
        if bf16:
            # the library has no numpy bf16: write the bits, then mark them
            from tmac_tpu_torch.convert.checkpoint import save_safetensors
            save_safetensors({k: files[k] for k in part}, os.path.join(tmpdir, fname),
                             bf16=set(part))
        else:
            save_file({k: files[k] for k in part}, os.path.join(tmpdir, fname))
        weight_map.update({k: fname for k in part})
    if sharded:
        with open(os.path.join(tmpdir, "model.safetensors.index.json"), "w") as f:
            json.dump({"weight_map": weight_map}, f)
    with open(os.path.join(tmpdir, "config.json"), "w") as f:
        json.dump({
            "model_type": "llama", "vocab_size": V, "hidden_size": H,
            "intermediate_size": I, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
            "tie_word_embeddings": tied,
        }, f)


@pytest.mark.parametrize("case", ["bitnet-sharded-bf16", "w2-tied-fp16",
                                  "w4-per-channel-zp-fp16", "w3-per-channel-bf16"])
def test_convert_float_checkpoint(case, tmp_path, monkeypatch):
    """Float master weights: BitNet's absmean ternarization (w_a8) from a
    sharded bf16 checkpoint, grouped W2 quantization with a tied head from
    fp16, and per-channel quantization (group_size -1: one f32 scale and
    zero point a column, gs = K a linear; K1 in the forward) of
    Llama-3.1-8B's architecture at bits 4 with zero points and bits 3
    without."""
    if case.startswith("bitnet"):
        jcfg0 = jax_preset("bitnet-3b").scaled(8)
        kw = dict(mode="w_a8", bits=2, group_size=-1)
        _write_float_checkpoint(str(tmp_path), jcfg0, tied=False, sharded=True, bf16=True)
    elif "per-channel" in case:
        jcfg0 = jax_preset("llama-3.1-8b").scaled(8)
        kw = dict(bits=int(case[1]), group_size=-1, zero_point="zp" in case)
        _write_float_checkpoint(str(tmp_path), jcfg0, tied=False, sharded=False,
                                bf16=case.endswith("bf16"))
    else:
        jcfg0 = jax_preset("llama-2-7b").scaled(8)
        kw = dict(bits=2, group_size=128, zero_point=True)
        _write_float_checkpoint(str(tmp_path), jcfg0, tied=True, sharded=False, bf16=False)
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, case,
                                   jquant=JQuantConfig(**kw), quant=QuantConfig(**kw))
    assert cfg.tie_word_embeddings == ("tied" in case)
    assert ("lm_head" in params) != cfg.tie_word_embeddings
    if case.startswith("bitnet"):
        assert params["layers"][0]["wqkv"].scales.dtype == torch.float32
    if "per-channel" in case:
        assert cfg.quant.group_size == -1
        for name in ("wqkv", "wo", "gate_up", "down"):
            qt = params["layers"][0][name]
            assert qt.scales.shape[0] == 1 and qt.scales.dtype == torch.float32
            assert qt.group_size == qt.kdim_padded and (qt.packed_hi is not None) == (kw["bits"] == 3)


@pytest.mark.parametrize("bits", [3, 4])
def test_convert_hf_gptq_per_channel(bits, tmp_path, monkeypatch):
    """A per-channel GPTQ directory (one scale row a linear, gs = K) in the
    form the JAX package's converter takes: every linear's K the hidden
    size (the FFN cut to it), which the config names as its group size,
    since the converter holds each linear's group size to the config's.
    Byte for byte JAX's (f32 scales: one group spans K), the forward on K1
    within the model gate."""
    cfg0 = dataclasses.replace(jax_preset("llama-3.1-8b").scaled(8), intermediate_size=512)
    H = cfg0.hidden_size
    assert cfg0.q_dim == H
    _write_synthetic_hf_gptq(str(tmp_path), cfg0, bits=bits, gs=H)
    cfg, params, _ = _convert_both(tmp_path, monkeypatch, f"pc-gptq-{bits}")
    assert (cfg.quant.bits, cfg.quant.group_size, cfg.quant.zero_point) == (bits, H, True)
    for name in ("wqkv", "wo", "gate_up", "down"):
        qt = params["layers"][0][name]
        assert qt.kdim == H and qt.scales.shape[0] == 1 and qt.scales.dtype == torch.float32


def test_gptq_group_size_minus_one_is_refused_by_both(tmp_path):
    """A GPTQ config's group_size -1 (AutoGPTQ's per channel): each linear
    parses to gs = K, which the JAX package's converter holds to the
    config's -1 and refuses (an assertion), and so does the port (a
    ValueError naming both)."""
    cfg0 = dataclasses.replace(jax_preset("llama-3.1-8b").scaled(8), intermediate_size=512)
    _write_synthetic_hf_gptq(str(tmp_path), cfg0, bits=4, gs=cfg0.hidden_size)
    path = tmp_path / "config.json"
    conf = json.loads(path.read_text())
    conf["quantization_config"]["group_size"] = -1
    path.write_text(json.dumps(conf))
    with pytest.raises(AssertionError):
        jhf.convert_hf_model(str(tmp_path), name="pc-gptq")
    with pytest.raises(ValueError, match="config says 4, -1"):
        convert_hf_model(str(tmp_path), name="pc-gptq", device="cpu")


def test_convert_tp2_packs_shards_as_jax(tmp_path, monkeypatch):
    """tp = 2: q/k/v and gate/up m-sharded, wo and down k-sharded, the FFN
    padded to 2 x group size; byte for byte JAX's tp = 2 conversion."""
    cfg0 = jax_preset("llama-2-7b").scaled(8)
    _write_synthetic_hf_gptq(str(tmp_path), cfg0, bits=2, gs=128)
    _, params, _ = _convert_both(tmp_path, monkeypatch, "tiny-tp2", tp=2)
    assert params["layers"][0]["wo"].k_shards == 2
    assert params["layers"][0]["wqkv"].m_shards == 2


def test_refusals(tmp_path):
    """A float checkpoint without a QuantConfig, act-order GPTQ and AWQ's
    gemv packing raise."""
    from tmac_tpu_torch.convert.hf import quant_config_from_hf
    cfg0 = jax_preset("llama-2-7b").scaled(8)
    _write_float_checkpoint(str(tmp_path), cfg0, tied=True, sharded=False, bf16=False)
    with pytest.raises(ValueError, match="QuantConfig"):
        convert_hf_model(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="desc_act"):
        quant_config_from_hf({"quantization_config": {"bits": 4, "group_size": 128,
                                                      "desc_act": True}})
    with pytest.raises(ValueError, match="gemv"):
        quant_config_from_hf({"quantization_config": {"quant_method": "awq",
                                                      "version": "gemv"}})
