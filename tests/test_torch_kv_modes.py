"""The plain versions of kernels K6, K8 and K9 (the decode-attention modes:
int8 cache, sliding window, current token as an operand, in-kernel row
store) and the int8 cache's quantization, against the JAX package's
flash-decode Pallas kernels (interpret mode on the CPU) and _quantize_kv.

The cases mirror tests/test_attention.py, test_kv_quant.py and
test_sliding_window.py: int8 and bf16 caches, windows 0, 5 and 40, lengths
0, 1, on both sides of the window's edge, across JAX's 32-row blocks and
the whole cache, a fresh sequence (cached length 0), head_dim 96 and 128,
one and four query heads per KV head, each split over 1, 2, 3 and 8 blocks
a head (nsplit) and over split_plan's choice.  Outputs are held to 2e-5 in
f32 (the tolerance of K2's test: the two sides add in other orders);
written codes, scales, values and padding exactly.  The split plan itself
(split_plan, split_spans) is tested at the end.
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

L, B, S, Dp, LI, BLK = 2, 5, 64, 128, 1, 32
NSPLITS = (None, 1, 2, 3, 8)  # None: split_plan's choice
WINDOWS = (0, 5, 40)
# (head_dim, query heads per KV head, KV heads)
SHAPES = [(96, 1, 4), (128, 4, 2)]


def _lens(window, append, last=S):
    """Per batch row: none, one, the window's edge on both sides (without
    a window, lengths across JAX's 32-row blocks), and the whole cache or
    `last` (in append mode, the rows already cached)."""
    if append:
        return (0, 1, 17, 40, last) if not window \
            else (0, 1, window - 1, window, last - 1)
    return (0, 1, 17, 40, S) if not window else (0, 1, window, window + 1, S)


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
def test_plain_k6_matches_pallas(quant, window, Dl, rep, KV):
    """flash_decode with k_scale/v_scale and/or a window (K6; with neither,
    K2) against flash_decode_stacked, split over each of NSPLITS."""
    j, t = _both(*_inputs(window + Dl, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, False), np.int32)
    want = np.asarray(flash_decode_stacked(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), blk=BLK,
        interpret=True, k_scale=j["ks"], v_scale=j["vs"], window=window))
    lens_t, li = torch.from_numpy(lens), torch.tensor([LI], dtype=torch.int32)
    for nsplit in NSPLITS:
        got = ak.flash_decode(t["q"], t["k"], t["v"], lens_t, li,
                              k_scale=t["ks"], v_scale=t["vs"], window=window,
                              nsplit=nsplit)
        assert got.shape == (B, KV, rep, Dl) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        assert not got[0].any()  # no valid row: zeros


@CACHE
@WINDOW
@CASES
def test_plain_k8_matches_pallas(quant, window, Dl, rep, KV):
    """flash_decode_append against flash_decode_stacked_append, a fresh
    sequence among the rows, split over each of NSPLITS."""
    j, t = _both(*_inputs(window + Dl + 1, Dl, rep, KV, quant), quant)
    lens = np.asarray(_lens(window, True), np.int32)
    want = np.asarray(flash_decode_stacked_append(
        j["q"], j["k"], j["v"], jnp.asarray(lens), jnp.int32(LI), j["ck"],
        j["cv"], blk=BLK, interpret=True, k_scale=j["ks"], v_scale=j["vs"],
        window=window))
    li = torch.tensor([LI], dtype=torch.int32)
    for nsplit in NSPLITS:
        got = ak.flash_decode_append(
            t["q"], t["k"], t["v"], torch.from_numpy(lens), li, t["ck"],
            t["cv"], k_scale=t["ks"], v_scale=t["vs"], window=window,
            nsplit=nsplit)
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
    names = ("k", "v", "ks", "vs") if quant else ("k", "v")
    for nsplit in NSPLITS:
        c = dict(t, **{n: t[n].clone() for n in names})
        got = ak.flash_decode_append_write(
            c["q"], c["k"], c["v"], torch.from_numpy(lens),
            torch.tensor([LI], dtype=torch.int32), c["ck"], c["cv"],
            k_scale=c["ks"], v_scale=c["vs"], window=window, nsplit=nsplit)
        np.testing.assert_allclose(got.numpy(), np.asarray(res[0]),
                                   rtol=2e-5, atol=2e-5)
        for name, want in zip(names, res[1:]):
            mine = c[name].float().numpy()
            np.testing.assert_array_equal(mine, np.asarray(want, np.float32))
        assert not c["k"][..., Dl:].any() and not c["v"][..., Dl:].any()


def test_plain_k9_stores_on_the_last_row_past_the_cache():
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
    lens = torch.tensor([S, 3, S, 0, 1], dtype=torch.int32)
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
        # only rows S - 1, 3, S - 1, 0 and 1 of batch rows 0 .. 4, in layer LI
        for b, row in ((0, S - 1), (1, 3), (2, S - 1), (3, 0), (4, 1)):
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


def _spans(lens, window, append, nsplit, S=S):
    start, end = ak.split_spans(torch.tensor(lens, dtype=torch.int32), S,
                                window, append, nsplit)
    return start.tolist(), end.tolist()


@pytest.mark.parametrize("nsplit", [1, 2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("window,append", [(0, False), (5, False), (40, False),
                                           (5, True), (40, True)])
def test_split_spans_cover_the_rows_once_in_order(nsplit, window, append):
    """At every length 0 .. S + 2, the spans of a cluster's blocks are
    contiguous, in rank order, each a whole number of row tiles but the
    last non-empty one, and together cover [lo, min(len, S)) once."""
    lens = list(range(S + 3))
    starts, ends = _spans(lens, window, append, nsplit)
    for n, st, en in zip(lens, starts, ends):
        length = min(n, S)
        lo = max(n - window + int(append), 0) if window else 0
        rows = [r for a, b in zip(st, en) for r in range(a, b)]
        assert rows == list(range(lo, length)), (n, st, en)
        assert st[0] == min(lo, length) and en[-1] == length
        assert all(b == a for a, b in zip(st[1:], en[:-1]))
        full = [b - a for a, b in zip(st, en) if b > a][:-1]
        assert all(w % ak.TILE == 0 for w in full), (n, st, en)


def test_split_spans_leave_blocks_empty_at_short_lengths():
    """A short length fills the first blocks with whole tiles and leaves
    the others empty, at the end of the rows (start == end == len)."""
    starts, ends = _spans([1, 9, 0], 0, False, 8)
    assert (starts[0], ends[0]) == ([0] + [1] * 7, [1] * 8)
    assert (starts[1], ends[1]) == ([0, 4, 8] + [9] * 5, [4, 8] + [9] * 6)
    assert (starts[2], ends[2]) == ([0] * 8, [0] * 8)


def test_split_spans_past_the_cache():
    """A length past S reads the rows below S, and the window's edge comes
    from the length as given (as the reference masks them)."""
    starts, ends = _spans([S + 10, S + 10], 0, False, 2)
    assert (starts[0], ends[0]) == ([0, 32], [32, S])
    starts, ends = _spans([S + 10], 20, True, 2)
    lo = S + 10 - 20 + 1
    assert (starts[0], ends[0]) == ([lo, lo + 8], [lo + 8, S])  # 9 rows


@pytest.mark.parametrize("B,KV,rows,sms,want", [
    (1, 32, 1152, 132, 6),     # Llama, BitNet: 192 blocks, ~1.5 an SM
    (1, 32, 2047, 132, 6),     # Phi-3's window
    (1, 8, 384, 132, 8),       # Mixtral: capped at the portable cluster
    (2, 32, 2048, 132, 3),     # two rows of 32 heads
    (1, 64, 2048, 132, 3),
    (1, 4, 64, 132, 2),        # few rows: half a stage a block at least
    (1, 4, 16, 132, 1),
    (1, 32, 128, 132, 4),
    (1, 32, 2048, 16, 1),      # a small card
    (4, 32, 2048, 132, 2),
])
def test_split_plan(B, KV, rows, sms, want):
    assert ak.split_plan(B, KV, rows, sms) == want


@pytest.mark.parametrize("nsplit", [0, 17])
def test_nsplit_must_be_a_cluster_size(nsplit):
    q = torch.zeros(1, 1, 1, 96)
    kv = torch.zeros(1, 1, 1, 8, 128)
    with pytest.raises(ValueError, match="nsplit"):
        ak.flash_decode(q, kv, kv, torch.ones(1, dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), nsplit=nsplit)
