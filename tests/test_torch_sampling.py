"""The port's sampler (tmac_tpu_torch/runtime/sampling.py) against the JAX
package's: the filters' masks on fixed logits (the same -inf set, the kept
values within 1 ulp), the penalties and counts, and the draws by their
distribution (threefry and Philox give different numbers from one seed, so
no stream is compared across the packages)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.runtime import sampling as js
from tmac_tpu_torch.runtime import sampling as ts
from tmac_tpu_torch.runtime.sampling import (SamplerConfig, SamplerState,
                                             apply_penalties, bump_counts,
                                             filtered_logits, sample,
                                             sample_state)

torch.set_num_threads(2)

# total-variation distance of N draws from their target is O(1/sqrt(N)):
# 40 000 draws stay below 0.02, as in tests/test_spec_sampling.py
DRAWS, TV = 40_000, 0.02


def _logits(seed, rows=4, V=64, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((rows, V))
            * scale).astype(np.float32)


def _same_masks(got, want):
    """The same -inf entries, and the kept values within 1 ulp."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = np.isfinite(want)
    assert keep.any(axis=-1).all()   # every row keeps its top-1
    np.testing.assert_array_max_ulp(got[keep], want[keep], 1)


FILTERS = {
    "temperature": SamplerConfig(temperature=0.7),
    "top_k": SamplerConfig(temperature=0.7, top_k=5),
    "top_p": SamplerConfig(temperature=1.0, top_p=0.9),
    "top_p_top1": SamplerConfig(temperature=1.0, top_p=1e-6),
    "min_p": SamplerConfig(temperature=1.3, min_p=0.1),
    "top_k_top_p": SamplerConfig(temperature=0.8, top_k=10, top_p=0.8),
    "top_k_min_p": SamplerConfig(temperature=0.8, top_k=20, min_p=0.05),
    "top_p_min_p": SamplerConfig(temperature=1.1, top_p=0.5, min_p=0.2),
    "all": SamplerConfig(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05),
}

_jfiltered = jax.jit(js.filtered_logits, static_argnames=("cfg",))


@pytest.mark.parametrize("name", FILTERS)
def test_filtered_logits_masks_match_jax(name):
    cfg = FILTERS[name]
    x = _logits(1)
    want = _jfiltered(jnp.asarray(x), js.SamplerConfig(**cfg.__dict__))
    _same_masks(filtered_logits(torch.from_numpy(x), cfg), want)


def test_top_k_keeps_ties_at_the_kth_value():
    x = np.array([[3.0, 2.0, 2.0, 2.0, 1.0, 0.5]], np.float32)
    cfg = SamplerConfig(temperature=1.0, top_k=2)
    got = filtered_logits(torch.from_numpy(x), cfg).numpy()
    assert np.isfinite(got[0, :4]).all() and np.isneginf(got[0, 4:]).all()
    _same_masks(got, _jfiltered(jnp.asarray(x),
                                js.SamplerConfig(**cfg.__dict__)))


def _capture_masked(module, monkeypatch):
    """sample_state's masked logits, from the module's _categorical."""
    seen = {}

    def fake(key, logits):
        seen["masked"] = np.asarray(logits)
        return (torch.argmax(logits, -1) if isinstance(logits, torch.Tensor)
                else jnp.argmax(logits, -1))
    monkeypatch.setattr(module, "_categorical", fake)
    return seen


# per-row settings: (temperature, top_k, top_p, min_p) for each row
ROWS = {
    "filters_one_each": [(0.7, 5, 1.0, 0.0), (1.0, 0, 0.9, 0.0),
                         (1.3, 0, 1.0, 0.1), (0.8, 0, 1.0, 0.0)],
    "mixed": [(0.8, 10, 0.8, 0.05), (0.8, 40, 0.95, 0.05),
              (1.0, 3, 0.5, 0.0), (0.5, 0, 0.3, 0.3)],
    "greedy_rows": [(0.0, 0, 1.0, 0.0), (1.0, 64, 1.0, 0.0),
                    (0.0, 5, 0.9, 0.1), (2.0, 1, 1.0, 0.0)],
}


def _state_masks(x, rows, monkeypatch):
    """(the port's masked logits, JAX's, the port's tokens, JAX's) of
    sample_state on logits x with per-row settings `rows`, the draw
    replaced by the masked argmax on both sides."""
    t, k, p, m = (list(c) for c in zip(*rows))
    jseen = _capture_masked(js, monkeypatch)
    jtok = np.asarray(js.sample_state(jnp.asarray(x), jax.random.PRNGKey(0),
                                      js.SamplerState.make(t, k, p, min_p=m)))
    tseen = _capture_masked(ts, monkeypatch)
    ttok = sample_state(torch.from_numpy(x), torch.Generator(),
                        SamplerState.make(t, k, p, min_p=m, device="cpu")).numpy()
    return tseen["masked"], jseen["masked"], ttok, jtok


@pytest.mark.parametrize("name", ROWS)
def test_sample_state_masks_match_jax(name, monkeypatch):
    x = _logits(2, scale=1.0)
    got, want, ttok, jtok = _state_masks(x, ROWS[name], monkeypatch)
    _same_masks(got, want)
    # the fake draw is the masked argmax: greedy rows and the rest agree
    np.testing.assert_array_equal(ttok, jtok)


# sample_state applies top-p to every row; at top_p = 1.0 a row keeps the
# tokens before its f32 cumulative probability first reaches 1.0, and the
# tail after that point depends on the rounding of exp and of the sums,
# which the port does not follow bit for bit (XLA's CPU exp and its sum
# orders; ROADMAP Queue 3).  Logits spread wide enough to reach that
# point: the masks agree except on tokens each below EDGE_P of their row.
EDGE_P = 2.0 ** -20


def test_sample_state_top_p_one_edge(monkeypatch):
    x = _logits(2, scale=3.0)
    rows = ROWS["filters_one_each"]
    got, want, _, _ = _state_masks(x, rows, monkeypatch)
    diff = np.isneginf(got) != np.isneginf(want)
    p = torch.softmax(torch.from_numpy(x) / torch.tensor(
        [r[0] for r in rows])[:, None], -1).numpy()
    assert diff.any()   # the edge is reached, or this test proves nothing
    assert (p[diff] < EDGE_P).all(), p[diff]
    assert all(rows[r][2] == 1.0 for r in np.nonzero(diff)[0])
    keep = np.isfinite(want) & np.isfinite(got)
    np.testing.assert_array_max_ulp(got[keep], want[keep], 1)


def test_sampler_state_matches_jax_fields():
    cfg = SamplerConfig(temperature=0.8, top_k=40, top_p=0.95, min_p=0.05,
                        repeat_penalty=1.1, presence_penalty=0.2,
                        frequency_penalty=0.3)
    got = SamplerState.broadcast(cfg, 3, device="cpu")
    want = js.SamplerState.broadcast(js.SamplerConfig(**cfg.__dict__), 3)
    for f in ("temperature", "top_k", "top_p", "min_p", "repeat_penalty",
              "presence_penalty", "frequency_penalty"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def test_apply_penalties_math():
    logits = torch.tensor([[2.0, -1.0, 0.5, 3.0]])
    counts = torch.tensor([[2, 1, 0, 0]], dtype=torch.int32)
    got = apply_penalties(logits, counts, 1.5, 0.7, 0.3).numpy()
    want = np.array([[2.0 / 1.5 - 0.7 - 0.6, -1.0 * 1.5 - 0.7 - 0.3,
                      0.5, 3.0]])
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_apply_penalties_match_jax(per_row):
    rng = np.random.default_rng(3)
    x = _logits(3, rows=3)
    counts = rng.integers(0, 4, x.shape).astype(np.int32)
    params = ([1.1, 1.3, 0.9], [0.2, 0.0, 0.5], [0.3, 0.1, 0.0]) \
        if per_row else (1.1, 0.2, 0.3)
    jparams = [jnp.asarray(p, jnp.float32) if per_row else p for p in params]
    tparams = [torch.tensor(p) if per_row else p for p in params]
    want = np.asarray(js.apply_penalties(jnp.asarray(x), jnp.asarray(counts),
                                         *jparams))
    got = apply_penalties(torch.from_numpy(x), torch.from_numpy(counts),
                          *tparams).numpy()
    np.testing.assert_array_max_ulp(got, want, 1)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_neutral_penalties_are_identity(per_row):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, 5, (3, 64)).astype(np.int32))
    params = (torch.ones(3), torch.zeros(3), torch.zeros(3)) if per_row \
        else (1.0, 0.0, 0.0)
    assert torch.equal(apply_penalties(x, counts, *params), x)


@pytest.mark.parametrize("active", [None, [True, False, True]],
                         ids=["all", "active_mask"])
def test_bump_counts_match_jax(active):
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 3, (3, 8)).astype(np.int32)
    toks = np.array([1, 2, 2], np.int32)
    want = np.asarray(js.bump_counts(
        jnp.asarray(counts), jnp.asarray(toks),
        None if active is None else jnp.asarray(active)))
    tc = torch.from_numpy(counts.copy())
    got = bump_counts(tc, torch.from_numpy(toks),
                      None if active is None else torch.tensor(active))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got is tc   # updated in place


def _tv(tokens, p):
    emp = np.bincount(np.asarray(tokens).reshape(-1), minlength=len(p)) \
        / np.asarray(tokens).size
    return 0.5 * np.abs(emp - p).sum()


# over 12 tokens: top_k below 12
TV_FILTERS = dict(FILTERS, all=SamplerConfig(temperature=0.8, top_k=6,
                                             top_p=0.95, min_p=0.05))


@pytest.mark.parametrize("name", ("temperature", "top_k", "top_p", "min_p",
                                  "all"))
def test_sample_draws_follow_the_filtered_distribution(name):
    cfg = TV_FILTERS[name]
    x = torch.from_numpy(_logits(5, rows=1, V=12, scale=1.5))
    p = torch.softmax(filtered_logits(x, cfg), -1)[0].double().numpy()
    gen = torch.Generator().manual_seed(7)
    toks = sample(x.expand(DRAWS, -1), gen, cfg)
    assert toks.dtype == torch.int32
    assert p[toks.numpy()].min() > 0       # nothing filtered is ever drawn
    assert _tv(toks.numpy(), p) < TV


def test_sample_state_draws_follow_each_rows_distribution():
    """Two rows with their own settings, DRAWS times each, from one
    batch-wide generator; each row's tokens within TV of its target."""
    x = torch.from_numpy(_logits(6, rows=1, V=12, scale=1.5))
    rows = [(0.8, 5, 1.0, 0.0), (1.2, 0, 0.9, 0.05)]
    t, k, p, m = (list(c) * DRAWS for c in zip(*rows))
    st = SamplerState.make(t, k, p, min_p=m, device="cpu")
    toks = sample_state(x.expand(2 * DRAWS, -1), torch.Generator()
                        .manual_seed(8), st).numpy().reshape(DRAWS, 2)
    for r, (tr, kr, pr, mr) in enumerate(rows):
        cfg = SamplerConfig(temperature=tr, top_k=kr, top_p=pr, min_p=mr)
        target = torch.softmax(filtered_logits(x, cfg), -1)[0].double().numpy()
        assert _tv(toks[:, r], target) < TV, r


def test_greedy_is_first_argmax():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [5.0, 5.0, 1.0, 2.0]])
    assert sample(x).tolist() == [1, 0]
    st = SamplerState.make([0.0, 0.0], [0, 0], [1.0, 1.0], device="cpu")
    assert sample_state(x, torch.Generator(), st).tolist() == [1, 0]


def test_per_row_generators_make_rows_independent():
    """A row's draws depend only on its own generator: the same seed gives
    the same row whatever the batch's other rows draw."""
    x = torch.from_numpy(_logits(9, rows=3, V=32, scale=0.5))
    cfg = SamplerConfig(temperature=1.0)
    alone = [sample(x[:1], [torch.Generator().manual_seed(5)], cfg)]
    batch = [sample(x, [torch.Generator().manual_seed(s) for s in (5, 6, 7)],
                    cfg)]
    gens = [torch.Generator().manual_seed(5)]
    bgens = [torch.Generator().manual_seed(s) for s in (5, 17, 99)]
    for _ in range(20):
        alone.append(sample(x[:1], gens, cfg))
        batch.append(sample(x, bgens, cfg))
    assert [int(a[0]) for a in alone[1:]] == [int(b[0]) for b in batch[1:]]
    assert int(alone[0][0]) == int(batch[0][0])
    assert len({int(a[0]) for a in alone}) > 3   # the draws do move


def test_sampling_without_a_generator_raises():
    x = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="Generator"):
        sample(x, None, SamplerConfig(temperature=1.0))
    with pytest.raises(ValueError, match="Generator"):
        sample_state(x, None, SamplerState.make([0.0], [0], [1.0], device="cpu"))
