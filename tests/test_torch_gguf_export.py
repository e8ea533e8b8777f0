"""The PyTorch package's gguf exporter against the JAX package's.

The same params (JAX's init_params, carried across with
params_from_numpy) go through both packages' export_gguf: the files must
be byte for byte the same, for the automatic block types (Q4_0, Q4_1,
TQ2_0), Q4_K, Q8_0 and Q2_K, with rope_freqs.weight (llama3 scaling), an
int8 or a bf16 head, an embedded SPM or BPE tokenizer, Mixtral's stacked
experts and qwen2moe's shared expert.  qt_to_float and split_fused equal
JAX's values, and a gguf -> convert -> export round trip is lossless.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_gguf import _write_tiny_llama_gguf
from tests.test_tokenizer import _bpe, _spm
from tmac_tpu.convert import gguf_export as je
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.models.llama import init_params as jax_init
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jfuse_m
from tmac_tpu_torch.convert import gguf as tg
from tmac_tpu_torch.convert import gguf_export as te
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.ops.qgemm import QuantizedTensor

torch.set_num_threads(2)


def _carry(jqt):
    """A JAX QuantizedTensor as the port's, byte for byte."""
    tree = {"layers": [], "q": jax.tree.map(np.asarray, jqt)}
    return params_from_numpy(tree, dataclasses.replace(get_preset("llama-2-7b"),
                                                       num_layers=0), device="cpu")["q"]


def _qts(rng):
    """(label, JAX tensor) of each form export dequantizes: an unpadded M,
    bits 1-4 and 8, f32 and bf16 scales, gs 16, a fused tensor, a head."""
    import jax.numpy as jnp
    out = []
    for bits, gs, M, sd in ((2, 128, 96, jnp.bfloat16), (4, 32, 256, jnp.float32),
                            (3, 16, 128, jnp.float32), (1, 64, 200, jnp.bfloat16),
                            (8, 32, 128, jnp.float32), (4, 256, 128, jnp.float32)):
        w = rng.standard_normal((256, M)).astype(np.float32)
        from tmac_tpu.ops import packing
        wq, s, sub = packing.quantize_weights(w, bits if bits != 8 else 8, gs, True)
        out.append((f"b{bits}g{gs}", JQT.from_quantized(wq, s, sub, bits=bits, group_size=gs,
                                                        scale_dtype=sd)))
    out.append(("fused", jfuse_m([JQT.from_float(rng.standard_normal((256, m)).astype(
        np.float32), bits=4, group_size=64) for m in (128, 64, 64)])))
    out.append(("head", JQT.from_float(rng.standard_normal((256, 300)).astype(np.float32),
                                       bits=8, group_size=256)))
    return out


def test_qt_to_float_and_split_fused_match_jax():
    for label, jqt in _qts(np.random.default_rng(0)):
        qt = _carry(jqt)
        a, b = je.qt_to_float(jqt), te.qt_to_float(qt)
        assert a.dtype == b.dtype and a.shape == b.shape, label
        np.testing.assert_array_equal(b, a, err_msg=label)
        for x, y in zip(je.split_fused(jqt, a), te.split_fused(qt, b)):
            np.testing.assert_array_equal(y, x, err_msg=label)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _pair(name, overrides=None, **kw):
    """(JAX cfg, JAX params, the port's cfg, the port's params carried
    across byte for byte) of a preset at scaled(8)."""
    jcfg = dataclasses.replace(jax_preset(name, **kw).scaled(8), **(overrides or {}))
    cfg = dataclasses.replace(get_preset(name, **kw).scaled(8), **(overrides or {}))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax_init(jcfg, seed=0)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                 device="cpu")


QWEN2MOE = dict(num_experts=4, num_experts_per_tok=2, num_heads=4, num_kv_heads=2,
                moe_intermediate_size=256, moe_shared_intermediate_size=256)
CASES = {
    # (preset, its keyword arguments, config overrides, export's arguments)
    "auto_q4_0": ("llama-2-7b", {}, {}, {}),
    "auto_q4_1": ("llama-2-7b", dict(bits=4), {}, {}),
    "q4_k_llama31": ("llama-3.1-8b", dict(bits=4, group_size=32), {}, dict(wtype="Q4_K")),
    "q8_0": ("llama-2-7b", dict(bits=4), {}, dict(wtype="Q8_0")),
    "q2_k_bf16_head": ("llama-3.1-8b", dict(bits=2), dict(head_bits=16), dict(wtype="Q2_K")),
    "auto_tq2_0": ("bitnet-3b", {}, {}, {}),
    "moe_q4_1": ("mixtral-8x7b", dict(bits=4), {}, {}),
    "qwen2moe": ("qwen2-moe-a14b", dict(bits=4), QWEN2MOE, dict(wtype="Q4_0")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_export_gguf_bytes_match_jax(case, tmp_path):
    name, kw, overrides, ekw = CASES[case]
    jcfg, jparams, cfg, params = _pair(name, overrides, **kw)
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    a = je.export_gguf(jpath, jcfg, jparams, **ekw)
    b = te.export_gguf(tpath, cfg, params, **ekw)
    assert {**a, "path": None} == {**b, "path": None}
    assert _bytes(tpath) == _bytes(jpath)
    if case == "q4_k_llama31":
        r = tg.GGUFReader(tpath)
        assert "rope_freqs.weight" in r.tensors
        assert r.tensors["blk.0.attn_q.weight"]["type"] == tg.GGML_Q4_K
        r.close()


@pytest.mark.parametrize("tokenizer", ["spm", "bpe"])
def test_export_tokenizer_bytes_match_jax(tokenizer, tmp_path):
    """A checkpoint directory's tokenizer rides along, the same bytes."""
    jcfg, jparams, cfg, params = _pair("llama-2-7b")
    ck = tmp_path / "ck"
    ck.mkdir()
    (_spm if tokenizer == "spm" else _bpe)().save(str(ck))
    jpath, tpath = str(tmp_path / "j.gguf"), str(tmp_path / "t.gguf")
    je.export_gguf(jpath, jcfg, jparams, ckpt_dir=str(ck))
    te.export_gguf(tpath, cfg, params, ckpt_dir=str(ck))
    assert _bytes(tpath) == _bytes(jpath)
    r = tg.GGUFReader(tpath)
    assert r.metadata["tokenizer.ggml.model"] == ("llama" if tokenizer == "spm" else "gpt2")
    r.close()


def test_export_roundtrip_q4_0_and_q4_k(tmp_path):
    """gguf Q4_0 -> the port's params -> export Q4_0 is lossless (the
    packed values requantize to themselves), and a Q4_K export read back
    gives the f32-scale params its values came from."""
    cfg0 = jax_preset("llama-2-7b").scaled(8)
    src = str(tmp_path / "src.gguf")
    _write_tiny_llama_gguf(src, cfg0, np.random.default_rng(2))
    cfg, params = tg.convert_gguf_model(src, name="t", device="cpu")
    out = str(tmp_path / "out.gguf")
    assert te.export_gguf(out, cfg, params, wtype="Q4_0")["wtype"] == "Q4_0"
    r_src, r_out = tg.GGUFReader(src), tg.GGUFReader(out)
    for name in ("blk.0.attn_q.weight", "blk.0.ffn_down.weight", "blk.1.attn_output.weight"):
        np.testing.assert_allclose(r_out.dequantized(name), r_src.dequantized(name),
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(r_out.dequantized("blk.0.attn_norm.weight"),
                                  r_src.dequantized("blk.0.attn_norm.weight"))
    r_src.close(), r_out.close()
    _, _, cfg, params = _pair("llama-3.1-8b", bits=4, group_size=32)
    te.export_gguf(out, cfg, params, wtype="Q4_K")
    cfg2, params2 = tg.convert_gguf_model(out, name="re", device="cpu")
    assert cfg2.rope_scaling[0] == "factors" and cfg2.quant.group_size == 32
    qt = params2["layers"][0]["wqkv"]
    assert qt.scales.dtype == torch.float32 and isinstance(qt, QuantizedTensor)
    r = tg.GGUFReader(out)
    np.testing.assert_array_equal(te.qt_to_float(params2["layers"][0]["wo"]),
                                  r.dequantized("blk.0.attn_output.weight").T)
    r.close()
