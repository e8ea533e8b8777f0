"""The port's model against the JAX package at the presets it now admits.

Each preset at ``.scaled(8)`` (2 layers, narrow widths, the preset's own
quantization, rope scaling, biases and head): ``init_params`` byte for
byte, then an 8-token prefill and 4 greedy decode steps teacher-forced
against ``forward(impl="pallas")`` (its Pallas kernels in interpret mode
on the CPU), compiled as the model runs it.  Qwen2's q/k/v biases, which
both packages draw as zeros, are set to the same seeded nonzero bf16
values in both trees first.

Given XLA's rsqrt values for every rms_norm factor (the prologues' and the
final and MoE norms', which the port otherwise takes from torch's IEEE
rsqrt) the logits are bit for bit JAX's.  Without them they differ where
a last-bit difference in a norm factor moves an int8 code at a .5 tie;
measured on the CPU, logits NMSE 7.6e-4 (llama-3.1-8b W3), 3.3e-4
(llama-2-13b), 2.7e-4 (phi-3.5-mini) and 0.0 for the other six, argmax
agreement 1.0; the gate leaves room for another CPU's rsqrt estimate.
"""

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
from tmac_tpu_torch.utils import argmax_agreement, nmse

torch.set_num_threads(2)

PROMPT, STEPS = 8, 4
PRESET_NMSE, TIE_MARGIN = 2e-3, 1e-2
PRESETS = [("bitnet-700m", None), ("bitnet-2b-4t", None), ("llama-2-13b", None),
           ("llama-3-8b", None), ("llama-3.1-8b", 2), ("llama-3.1-8b", 3),
           ("phi-3.5-mini", None), ("trilm-3.9b", None), ("qwen2-7b", None)]

_fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))


def cfg_pair(name, bits=None):
    kw = {} if bits is None else dict(bits=bits)
    return get_preset(name, **kw).scaled(8), jax_preset(name, **kw).scaled(8)


def set_biases(params, jparams, cfg, seed=7):
    """The same seeded nonzero bf16 q/k/v biases in both trees (both
    packages' init_params draw zeros)."""
    rng = np.random.default_rng(seed)
    for layer, jlayer in zip(params["layers"], jparams["layers"]):
        for name, width in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            b = (rng.standard_normal(width) * 0.5).astype(np.float32)
            jlayer[name] = jnp.asarray(b, jnp.bfloat16)
            layer[name] = torch.from_numpy(b).to(torch.bfloat16)


def port_logits(model, prompt, toks):
    """The port's logits for the prompt and each of toks[:STEPS] after it."""
    cache = KVCache.create(model.cfg, 1, 64, device="cpu")
    lg, cache = model(torch.from_numpy(prompt), cache)
    out = [lg[0].numpy()]
    for t in toks[:STEPS]:
        lg, cache = model(torch.tensor([[t]]), cache)
        out.append(lg[0].numpy())
    return out


def teacher_forced(cfg, jcfg):
    """Both trees (biases set), the port's greedy tokens, and the logits
    of both packages on them."""
    params = init_params(cfg, seed=0, device="cpu")
    jparams = jl.init_params(jcfg, seed=0)
    tree = jax.tree.map(np.asarray, jparams)
    if cfg.attention_bias:
        set_biases(params, jparams, cfg)
    model = Llama(cfg, params)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT))
    cache = KVCache.create(cfg, 1, 64, device="cpu")
    lg, cache = model(torch.from_numpy(prompt), cache)
    toks = [int(lg[0, -1].argmax())]
    for _ in range(STEPS):
        lg, cache = model(torch.tensor([[toks[-1]]]), cache)
        toks.append(int(lg[0, -1].argmax()))
    jcache = jl.KVCache.create(jcfg, 1, 64)
    lg, jcache = _fwd(jparams, jcfg, jnp.asarray(prompt), jcache, impl="pallas")
    ref = [np.asarray(lg[0])]
    for t in toks[:STEPS]:
        lg, jcache = _fwd(jparams, jcfg, jnp.asarray([[t]]), jcache, impl="pallas")
        ref.append(np.asarray(lg[0]))
    return dict(cfg=cfg, tree=tree, model=model, prompt=prompt, toks=toks,
                port=port_logits(model, prompt, toks), ref=ref)


def given_xla_rsqrt(monkeypatch):
    """Give every rms_norm of the port (the prologues' and the final and
    MoE norms) XLA's compiled rsqrt values for its factors."""
    import tmac_tpu_torch.models.llama as tl
    import tmac_tpu_torch.ops.cuda.qgemm_kernel as k1
    rsqrt = jax.jit(jax.lax.rsqrt)

    def xla(v):
        return torch.from_numpy(np.array(rsqrt(jnp.asarray(v.numpy()))))

    def prologue_norm(xf, w, eps, K):
        var = k1.row_sum_xla_order(xf * xf) * (1.0 / K)
        return xf * xla(var + eps) * torch.nn.functional.pad(w.float(), (0, xf.shape[1] - K))

    def rms_norm(x, w, eps):
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        return (xf * xla(var + eps) * w.float()).to(x.dtype)
    monkeypatch.setattr(k1, "rms_norm_values", prologue_norm)
    monkeypatch.setattr(tl, "rms_norm", rms_norm)


def assert_tree_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}.{i}")
    elif isinstance(a, QuantizedTensor):
        for f in ("bits", "group_size", "k_shards", "m_shards", "shape", "m_segments"):
            assert getattr(a, f) == getattr(b, f), (path, f)
        for f in ("packed", "packed_hi", "scales", "sub"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), (path, f)
            if x is not None:
                assert_tree_equal(x, y, f"{path}.{f}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b), path


def check_logits(run, gate):
    for step, (ref, got) in enumerate(zip(run["ref"], run["port"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= gate, step
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step


def check_bitwise_given_rsqrt(run, monkeypatch):
    given_xla_rsqrt(monkeypatch)
    got = port_logits(run["model"], run["prompt"], run["toks"])
    for step, (ref, g) in enumerate(zip(run["ref"], got)):
        np.testing.assert_array_equal(g, ref, err_msg=f"step {step}")


@pytest.fixture(scope="module", params=PRESETS,
                ids=[n if b is None else f"{n}-w{b}" for n, b in PRESETS])
def run(request):
    return teacher_forced(*cfg_pair(*request.param))


def test_init_params_match_jax_byte_for_byte(run):
    """Including bits 3's hi plane, zero biases and the heads."""
    cfg = run["cfg"]
    carried = params_from_numpy(run["tree"], cfg, device="cpu")
    assert_tree_equal(init_params(cfg, seed=0, device="cpu"), carried)
    layer = carried["layers"][0]
    assert (layer["wqkv"].packed_hi is not None) == (cfg.quant.bits == 3
                                                     and cfg.quant.mode == "w_fp")
    assert ("bq" in layer) == cfg.attention_bias


def test_logits_match_jax_pallas(run):
    """Prefill of PROMPT tokens and STEPS decode steps, teacher-forced."""
    check_logits(run, PRESET_NMSE)


def test_logits_bit_for_bit_given_xla_rsqrt(run, monkeypatch):
    check_bitwise_given_rsqrt(run, monkeypatch)
