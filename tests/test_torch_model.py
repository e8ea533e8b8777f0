"""The port's BitNet model and generation loop against the JAX package.

Config: bitnet-3b scaled(8) with head_dim put back to 100, so the cache's
100 -> 128 pad is exercised.  JAX runs forward(impl="pallas"), whose fused
qgemm kernel runs in interpret mode on the CPU; it is jitted once per
shape and fed the port's own greedy tokens (teacher forcing).
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


def _cfgs():
    cfg = dataclasses.replace(get_preset("bitnet-3b").scaled(8), head_dim=100)
    jcfg = dataclasses.replace(jax_preset("bitnet-3b").scaled(8), head_dim=100)
    return cfg, jcfg


@pytest.fixture(scope="module")
def run():
    """The port's prefill + greedy decode, and JAX teacher-forced on the
    port's tokens: logits per step from both."""
    cfg, jcfg = _cfgs()
    model = Llama(cfg, init_params(cfg, seed=0, device="cpu"))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, PROMPT))
    cache = KVCache.create(cfg, 1, 64, device="cpu")
    logits, cache = model(torch.from_numpy(prompt), cache)
    port = [logits[0].numpy()]
    toks = [int(logits[0, -1].argmax())]
    for _ in range(STEPS):
        logits, cache = model(torch.tensor([[toks[-1]]]), cache)
        port.append(logits[0].numpy())
        toks.append(int(logits[0, -1].argmax()))

    fwd = jax.jit(jl.forward, static_argnames=("cfg", "impl"))
    jparams = jl.init_params(jcfg, seed=0)
    jcache = jl.KVCache.create(jcfg, 1, 64)
    lg, jcache = fwd(jparams, jcfg, jnp.asarray(prompt), jcache, impl="pallas")
    ref = [np.asarray(lg[0])]
    for t in toks[:STEPS]:
        lg, jcache = fwd(jparams, jcfg, jnp.asarray([[t]]), jcache,
                         impl="pallas")
        ref.append(np.asarray(lg[0]))
    return dict(cfg=cfg, model=model, prompt=prompt, toks=toks, port=port,
                ref=ref, jparams=jparams, cache=cache)


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


def test_init_params_match_jax_byte_for_byte(run):
    cfg = run["cfg"]
    tree = jax.tree.map(np.asarray, run["jparams"])
    carried = params_from_numpy(tree, cfg, device="cpu")
    _assert_tree_equal(init_params(cfg, seed=0, device="cpu"), carried)
    assert carried["embed"].dtype == torch.bfloat16


def test_logits_match_jax_pallas(run):
    for step, (ref, got) in enumerate(zip(run["ref"], run["port"])):
        assert got.shape == ref.shape and np.isfinite(got).all()
        assert nmse(ref, got) <= LOGITS_NMSE, step
        assert argmax_agreement(ref, got, TIE_MARGIN) == 1.0, step


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
