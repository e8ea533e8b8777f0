"""The plain versions of kernels K6, K8 and K9 (the decode-attention modes:
int8 cache, sliding window, current token as an operand, in-kernel row
store) and the int8 cache's quantization, against the JAX package's
flash-decode Pallas kernels (interpret mode on the CPU) and _quantize_kv.

The cases mirror tests/test_attention.py, test_kv_quant.py and
test_sliding_window.py: int8 and bf16 caches, windows 0, 5 and 40, lengths
on both sides of the window's edge and across JAX's 32-row blocks and the
port's chunks (16 rows here beside the default 256), a fresh sequence
(cached length 0), head_dim 96 and 128, one and four query heads per KV
head.  Outputs are held to 2e-5 in f32 (the tolerance of K2's test: the
two sides add in other orders); written codes, scales, values and padding
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.llama import _quantize_kv
from tmac_tpu.ops.pallas.attention_kernel import (
    flash_decode_stacked, flash_decode_stacked_append,
    flash_decode_stacked_append_write)
from tmac_tpu_torch.ops.cuda import attention_kernel as ak

torch.set_num_threads(2)

L, B, S, Dp, LI, BLK = 2, 4, 64, 128, 1, 32
WINDOWS = (0, 5, 40)
# (head_dim, query heads per KV head, KV heads)
SHAPES = [(96, 1, 4), (128, 4, 2)]


def _lens(window, append, last=S):
    """Per batch row: the shortest, the window's edge on both sides, and
    the whole cache or `last` (in append mode, the rows already cached)."""
    if append:
        return (0, 17, 40, last) if not window \
            else (0, window - 1, window, last - 1)
    return (1, 17, 40, S) if not window else (1, window, window + 1, S)


def _inputs(seed, Dl, rep, KV, quant):
    """q f32 (B, KV, rep, Dl); the cache (L, B, KV, S, Dp) as int8 codes
    with their (L, B, KV, S) f32 scales (the numpy form of _quantize_kv)
    or as bf16, zero past Dl; the current token's k/v f32 (B, KV, Dl)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, rep, Dl)).astype(np.float32)
    kv = rng.standard_normal((2, L, B, KV, S, Dl)).astype(np.float32)
    cur = rng.standard_normal((2, B, KV, Dl)).astype(np.float32)
    pad = ((0, 0),) * 5 + ((0, Dp - Dl),)
    if quant:
        sc = (np.maximum(np.abs(kv).max(-1), 1e-20) / 127.0).astype(np.float32)
        codes = np.clip(np.round(kv / sc[..., None]), -127, 127)
        return q, np.pad(codes, pad).astype(np.int8), sc, cur
    kvb = torch.from_numpy(np.pad(kv, pad)).to(torch.bfloat16).float().numpy()
    return q, kvb, None, cur


def _both(q, kv, sc, cur, quant):
    """The inputs as JAX arrays and as torch tensors (the cache bf16 or
    int8 on both sides)."""
    j = dict(q=jnp.asarray(q), k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]),
             ck=jnp.asarray(cur[0]), cv=jnp.asarray(cur[1]))
    t = dict(q=torch.from_numpy(q), k=torch.from_numpy(kv[0].copy()),
             v=torch.from_numpy(kv[1].copy()), ck=torch.from_numpy(cur[0]),
             cv=torch.from_numpy(cur[1]))
    if quant:
        j.update(ks=jnp.asarray(sc[0]), vs=jnp.asarray(sc[1]))
        t.update(ks=torch.from_numpy(sc[0].copy()),
                 vs=torch.from_numpy(sc[1].copy()))
    else:
        j.update(k=j["k"].astype(jnp.bfloat16), v=j["v"].astype(jnp.bfloat16),
                 ks=None, vs=None)
        t.update(k=t["k"].to(torch.bfloat16), v=t["v"].to(torch.bfloat16),
                 ks=None, vs=None)
    return j, t


CASES = pytest.mark.parametrize(
    "Dl,rep,KV", SHAPES, ids=[f"Dl{d}-rep{r}" for d, r, _ in SHAPES])
WINDOW = pytest.mark.parametrize("window", WINDOWS, ids=lambda w: f"w{w}")
CACHE = pytest.mark.parametrize("quant", [True, False], ids=["int8", "bf16"])


@CACHE
@WINDOW
@CASES
def test_plain_k6_matches_pallas(quant, window, Dl, rep, KV, monkeypatch):
    """flash_decode with k_scale/v_scale and/or a window (K6; with neither,
    K2) against flash_decode_stacked."""
    j, t = _both(*_inputs(window + Dl, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, False), np.int32)
    want = np.asarray(flash_decode_stacked(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), blk=BLK,
        interpret=True, k_scale=j["ks"], v_scale=j["vs"], window=window))
    lens_t, li = torch.from_numpy(lens), torch.tensor([LI], dtype=torch.int32)
    got = ak.flash_decode(t["q"], t["k"], t["v"], lens_t, li,
                          k_scale=t["ks"], v_scale=t["vs"], window=window)
    assert got.shape == (B, KV, rep, Dl) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    monkeypatch.setattr(ak, "CHUNK", 16)
    small = ak.flash_decode_split(t["q"], t["k"], t["v"], lens_t, li,
                                  k_scale=t["ks"], v_scale=t["vs"],
                                  window=window)
    np.testing.assert_allclose(small.numpy(), want, rtol=2e-5, atol=2e-5)


@CACHE
@WINDOW
@CASES
def test_plain_k8_matches_pallas(quant, window, Dl, rep, KV, monkeypatch):
    """flash_decode_append against flash_decode_stacked_append, a fresh
    sequence among the rows."""
    j, t = _both(*_inputs(window + Dl + 1, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, True), np.int32)
    want = np.asarray(flash_decode_stacked_append(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), j["ck"],
        j["cv"], blk=BLK, interpret=True, k_scale=j["ks"], v_scale=j["vs"],
        window=window))
    li = torch.tensor([LI], dtype=torch.int32)
    for chunk in (ak.CHUNK, 16):
        monkeypatch.setattr(ak, "CHUNK", chunk)
        got = ak.flash_decode_append(
            t["q"], t["k"], t["v"], torch.from_numpy(lens), li, t["ck"],
            t["cv"], k_scale=t["ks"], v_scale=t["vs"], window=window)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@CACHE
@WINDOW
@CASES
def test_plain_k9_matches_pallas(quant, window, Dl, rep, KV):
    """flash_decode_append_write against flash_decode_stacked_append_write:
    the output, and the whole cache after the store (the written rows'
    codes, scales or values and their zero padding exact, every other byte
    untouched)."""
    j, t = _both(*_inputs(window + Dl + 2, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, True, last=S - 1), np.int32)
    res = flash_decode_stacked_append_write(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), j["ck"],
        j["cv"], blk=BLK, interpret=True, k_scale=j["ks"], v_scale=j["vs"],
        window=window)
    got = ak.flash_decode_append_write(
        t["q"], t["k"], t["v"], torch.from_numpy(lens),
        torch.tensor([LI], dtype=torch.int32), t["ck"], t["cv"],
        k_scale=t["ks"], v_scale=t["vs"], window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(res[0]), rtol=2e-5,
                               atol=2e-5)
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    for name, want in zip(names, res[1:]):
        mine = t[name].float().numpy()
        np.testing.assert_array_equal(mine, np.asarray(want, np.float32))
    assert not t["k"][..., Dl:].any() and not t["v"][..., Dl:].any()


def test_plain_k9_skips_the_store_past_the_cache():
    """cached_lens == S: K9 still attends (K8's output), and its store,
    which cannot go past the cache, lands on row S - 1, the last cached
    row, as the JAX kernel's does in interpret mode (it clamps the row as
    dynamic_update_slice clamps a start); the cache it leaves is JAX's, and
    nothing is stored past it: the cache is a view of buffers one row
    longer, whose guard row S stays as it was."""
    j, t = _both(*_inputs(7, 96, 1, 4, True), True)
    guarded = {}
    for n in ("k", "v", "ks", "vs"):
        tail = t[n].shape[4:]
        buf = torch.full((L, B, 4, S + 1) + tail, 7, dtype=t[n].dtype)
        buf[:, :, :, :S] = t[n]
        guarded[n], t[n] = buf, buf[:, :, :, :S]
    lens = torch.tensor([S, 3, S, 0], dtype=torch.int32)
    li = torch.tensor([LI], dtype=torch.int32)
    jout = flash_decode_stacked_append_write(
        j["q"], j["k"], j["v"], jnp.asarray(lens.numpy()), jnp.int32(LI),
        j["ck"], j["cv"], blk=BLK, interpret=True, k_scale=j["ks"],
        v_scale=j["vs"])
    jchanged = np.asarray(jout[1] != j["k"]).any(-1)
    assert jchanged[LI, 0, :, S - 1].all() and jchanged[LI, 2, :, S - 1].all()
    before = {n: t[n].clone() for n in ("k", "v", "ks", "vs")}
    want = ak.flash_decode_append_plain(
        t["q"], t["k"], t["v"], lens, li, t["ck"], t["cv"],
        k_scale=t["ks"], v_scale=t["vs"])
    got = ak.flash_decode_append_write(
        t["q"], t["k"], t["v"], lens, li, t["ck"], t["cv"],
        k_scale=t["ks"], v_scale=t["vs"])
    assert torch.equal(got, want)
    for n, old in before.items():
        changed = (t[n] != old).reshape(L, B, 4, S, -1).any(-1)
        # only rows S - 1, 3, S - 1 and 0 of batch rows 0 .. 3, in layer LI
        for b, row in ((0, S - 1), (1, 3), (2, S - 1), (3, 0)):
            assert changed[LI, b, :, row].all(), (n, b)
            changed[LI, b, :, row] = False
        assert not changed.any(), n
    for n, jn in zip(("k", "v", "ks", "vs"), jout[1:]):
        np.testing.assert_array_equal(t[n].numpy(), np.asarray(jn))
        assert (guarded[n][:, :, :, S] == 7).all(), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantize_kv_matches_jax_exactly(dtype):
    """Codes and scales of the int8 cache's quantization equal the JAX
    package's _quantize_kv as compiled (jit), at random rows, a row of
    exact .5 ties (absmax 127 gives the scale 1.0; rint rounds the ties to
    even) and an all-zero row."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    x[0, 0, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5]
    x[0, 1] = 0.0
    xt = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(xt.float().numpy())
    if dtype == torch.bfloat16:
        jx = jx.astype(jnp.bfloat16)
    want_q, want_s = jax.jit(_quantize_kv)(jx)
    q, s = ak.quantize_kv(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    assert q[0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, 126]
