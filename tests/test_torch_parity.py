"""The port's model-level quality gate (``tmac_tpu_torch/tools/parity.py``)
against the JAX package's (``tests/test_parity.py``) on the CPU: the same
presets pass the same bars at scaled(8) (the port's kernels' plain
versions against the f32 oracle), ``dense_weight`` and ``dense_params``
are byte for byte the JAX package's, the oracle is its oracle, and the
gate catches a corrupted weight."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.models.llama import init_params as jax_init
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jax_fuse_m
from tmac_tpu.tools import parity as jparity
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
from tmac_tpu_torch.tools import parity
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

# The reference's test holds its impl="xla" forward (float activations) to
# a median NLL delta of 0.01; the port's forward quantizes activations to
# int8 as the reference's kernels do (impl="pallas"), whose own delta at
# these presets is up to 0.0109 (llama-2-7b W4, equal to the port's to the
# last bit: test_model_parity_is_jax_pallas_gate).
NLL_DELTA = 0.02


@pytest.mark.parametrize("label,preset,quant_kw", [
    ("bitnet-w1.58", "bitnet-3b", {}),
    ("llama2-w2-zp", "llama-2-7b", {}),
    ("llama2-w4-zp", "llama-2-7b", {"bits": 4}),
    ("trilm-w2-sym", "trilm-3.9b", {}),
    ("llama3-w3-gqa", "llama-3-8b", {"bits": 3}),
    ("mixtral-w2-moe", "mixtral-8x7b", {}),
])
def test_model_parity_gate(label, preset, quant_kw):
    """The reference's bars on the port's forward (its kernels' plain
    versions on the CPU): median e2e and per-layer NMSE < 2e-3, tie-aware
    agreement 1.0, perplexity within 5%; the NLL's median delta within
    NLL_DELTA (the int8-activation forward's, see below)."""
    cfg = get_preset(preset, **quant_kw).scaled(8)
    r = parity.model_parity(cfg, seed=0, device="cpu")
    assert r["nmse"] < 2e-3, r
    assert r["layer_nmse_max"] < 2e-3, r
    assert r["agree_tie_aware"] == 1.0, r
    assert r["max_disagree_gap"] < 0.35, r
    assert r["nll_delta_median"] < NLL_DELTA, r
    assert r["ppl_rel_delta"] < 0.05, r
    assert r["device"] == "cpu"


def test_model_parity_is_jax_pallas_gate():
    """The port's gate numbers are the reference's own with its kernels
    (model_parity(impl="pallas")), at llama-2-7b W4 scaled(8): every
    metric within 1e-6 of it (relative), agreement equal."""
    cfg = get_preset("llama-2-7b", bits=4).scaled(8)
    got = parity.model_parity(cfg, seed=0, device="cpu")
    want = jparity.model_parity(jax_preset("llama-2-7b", bits=4).scaled(8), seed=0,
                                impl="pallas")
    for k in ("nmse", "layer_nmse_max", "nll_delta_median", "ppl_prod", "ppl_oracle"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), (k, got[k], want[k])
    for k in ("agree", "agree_tie_aware", "decode_steps", "layer_nmse_argmax"):
        assert got[k] == want[k], k


def test_model_parity_gate_qwen2moe():
    cfg = dataclasses.replace(
        get_preset("qwen2-moe-a14b").scaled(8), num_experts=8,
        num_experts_per_tok=2, num_heads=4, num_kv_heads=2,
        moe_intermediate_size=512, moe_shared_intermediate_size=512)
    r = parity.model_parity(cfg, seed=0, device="cpu")
    assert r["nmse"] < 2e-3, r
    assert r["layer_nmse_max"] < 2e-3, r
    assert r["agree_tie_aware"] == 1.0, r
    assert r["nll_delta_median"] < 0.01, r


def test_parity_gate_rope_scaling_and_window():
    """The long-context paths: llama3 rope scaling and a sliding window
    that bites within the gate's prefill."""
    r = parity.model_parity(get_preset("llama-3.1-8b").scaled(8), seed=0, device="cpu")
    assert r["nmse"] < 2e-3 and r["layer_nmse_max"] < 2e-3, r
    assert r["agree_tie_aware"] == 1.0, r
    cfgw = dataclasses.replace(get_preset("llama-2-7b").scaled(8), sliding_window=8)
    r = parity.model_parity(cfgw, seed=0, device="cpu")
    assert r["nmse"] < 2e-3 and r["layer_nmse_max"] < 2e-3, r
    assert r["agree_tie_aware"] == 1.0, r


def _as_bytes(a):
    a = np.ascontiguousarray(a, np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("bits,gs,k_shards,m_shards,fused", [
    (1, 64, 1, 1, False), (2, 128, 1, 1, False), (3, 64, 1, 1, False),
    (4, 32, 1, 1, True), (8, 64, 1, 1, False), (2, 0, 1, 1, False),
    (2, 64, 2, 1, False), (4, 0, 1, 2, False), (2, 64, 1, 2, True)])
def test_dense_weight_is_jax_dense_weight(bits, gs, k_shards, m_shards, fused):
    """dense_weight byte for byte the JAX package's, for grouped and
    per-tensor scales, K- and M-sharded and M-padded (M 200) tensors,
    bits 3's planes, bits 8's signed codes and fused (m_segments)
    tensors."""
    rng = np.random.default_rng(bits * 10 + gs + k_shards)
    K, Ms = 384, (200, 136) if fused else (200,)
    jq, tq = [], []
    for M in Ms:
        w = rng.standard_normal((K, M)).astype(np.float32)
        kw = dict(k_shards=k_shards, m_shards=m_shards)
        jq.append(JQT.from_float(w, bits, gs or None, zero_point=True,
                                 scale_dtype=jnp.bfloat16, **kw))
        tq.append(QuantizedTensor.from_float(w, bits, gs or None, zero_point=True,
                                             scale_dtype=torch.bfloat16, device="cpu", **kw))
    j = jax_fuse_m(jq) if fused else jq[0]
    t = fuse_m(tq) if fused else tq[0]
    want, got = jparity.dense_weight(j), parity.dense_weight(t)
    assert got.shape == want.shape == (K, sum(Ms))
    np.testing.assert_array_equal(_as_bytes(got), _as_bytes(want))


@pytest.mark.parametrize("preset", ["llama-2-7b", "mixtral-8x7b", "qwen2-7b"])
def test_dense_params_and_oracle_are_jax_s(preset):
    """dense_params over init_params (byte for byte the JAX package's
    draws) equals the JAX package's, array for array, and so does the
    oracle's forward from them, with the per-layer hidden states."""
    cfg = get_preset(preset).scaled(8)
    jcfg = jax_preset(preset).scaled(8)
    got = parity.dense_params(init_params(cfg, seed=0, device="cpu"))
    want = jparity.dense_params(jax_init(jcfg, seed=0))

    def walk(a, b, path="dense"):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            np.testing.assert_array_equal(_as_bytes(a), _as_bytes(b), err_msg=path)
    walk(got, want)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12))
    io_t, io_j = [], []
    np.testing.assert_array_equal(
        parity.oracle_forward(got, cfg, tokens, collect_layer_io=io_t),
        jparity.oracle_forward(want, jcfg, tokens, collect_layer_io=io_j))
    for a, b in zip(io_t, io_j):
        np.testing.assert_array_equal(a, b)


def test_oracle_catches_corruption():
    """The gate must FAIL on a corrupted model: a few packed weight bytes
    flipped after densifying the oracle's copy give NMSE > 1e-2."""
    cfg = get_preset("llama-2-7b").scaled(8)
    params = init_params(cfg, seed=0, device="cpu")
    dense = parity.dense_params(params)
    qt = params["layers"][0]["wqkv"]
    bad = qt.packed.clone()
    bad[:8, :] = 0xFF
    params["layers"][0]["wqkv"] = dataclasses.replace(qt, packed=bad)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    with torch.no_grad():
        logits, _ = Llama(cfg, params)(torch.as_tensor(prompt),
                                       KVCache.create(cfg, 1, 32, device="cpu"))
    want = parity.oracle_forward(dense, cfg, prompt)
    assert float(nmse(want, logits.numpy())) > 1e-2


def test_gate_configs_and_table():
    """GATE_CONFIGS is the reference's matrix; format_table prints every
    row; model_parity asks for the card unless told the CPU."""
    assert parity.GATE_CONFIGS == jparity.GATE_CONFIGS
    row = dict(preset="p", quant="b2/w_fp/gs128", nmse=1e-4, layer_nmse_max=2e-4,
               agree=1.0, agree_tie_aware=1.0, max_disagree_gap=0.0, ppl_rel_delta=1e-3)
    assert parity.format_table([row]).splitlines()[2].startswith("p ")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parity.model_parity(get_preset("bitnet-3b").scaled(8))
    with pytest.raises(ValueError, match="impl"):
        parity.model_parity(get_preset("bitnet-3b").scaled(8), impl="xla", device="cpu")
