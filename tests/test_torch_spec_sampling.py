"""The port's speculative rejection sampling
(tmac_tpu_torch/runtime/speculative._sampled_accept) against the JAX
package's target distribution, on the CPU: a counterpart of every test and
case of tests/test_spec_sampling.py.  The marginal of the first emitted
position over many independent trials (one batched call, the trials a
leading dimension, each with its own uniforms and Gumbel draw from one
torch.Generator) must be JAX's softmax(filtered_logits(...)) within a
total variation of 0.02, as there (N_TRIALS = 40 000: the distance's
sampling noise is ~O(1/sqrt(N))).  Threefry and Philox streams cannot
match, so the draws are compared by their distribution; the end-to-end
runs by their shapes, their seeds and, at a near point mass, by the
greedy stream."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.runtime.sampling import SamplerConfig as JSamplerConfig
from tmac_tpu.runtime.sampling import filtered_logits as jfiltered_logits
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import Llama, init_params
from tmac_tpu_torch.runtime.sampling import SamplerConfig
from tmac_tpu_torch.runtime.speculative import (_sampled_accept,
                                                generate_draft_speculative,
                                                generate_speculative)

torch.set_num_threads(2)

V, K = 8, 3
N_TRIALS = 40_000
TV_GATE = 0.02


def _fixed_logits(seed, rows):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, V)) * 1.5).astype(np.float32)


def _target_p(logits, cfg):
    """JAX's serving distribution softmax(filtered_logits(logits))."""
    jcfg = JSamplerConfig(**dataclasses.asdict(cfg))
    return np.asarray(jax.nn.softmax(jfiltered_logits(jnp.asarray(logits), jcfg), -1))


def _trials(logits, draft, cfg, q_probs=None, n=N_TRIALS, seed=0):
    """_sampled_accept over n independent trials -> (tokens (n, K+1), a (n,))."""
    gen = torch.Generator().manual_seed(seed)
    lg = torch.from_numpy(logits)[None].expand(n, -1, -1)
    d = torch.as_tensor(draft).reshape(-1, K).expand(n, -1)
    q = None if q_probs is None else torch.as_tensor(q_probs).reshape(-1, K, V).expand(n, -1, -1)
    return _sampled_accept(lg, d, gen, cfg, q)


def _tv(first, p0):
    emp = np.bincount(first.numpy(), minlength=V) / first.numel()
    return 0.5 * np.abs(emp - p0).sum()


@pytest.mark.parametrize("cfg", [
    SamplerConfig(temperature=1.0),
    SamplerConfig(temperature=0.7, top_k=4),
    SamplerConfig(temperature=1.3, top_p=0.8),
])
def test_deterministic_draft_preserves_distribution(cfg):
    logits = _fixed_logits(1, K + 1)
    p0 = _target_p(logits, cfg)[0]
    for draft0 in (int(np.argmax(p0)), int(np.argmin(p0))):
        toks, _ = _trials(logits, [draft0, 1, 2], cfg)
        assert _tv(toks[:, 0], p0) < TV_GATE


def test_draft_model_q_preserves_distribution():
    """Draft tokens drawn from a mismatched proposal q != p; acceptance must
    still give p."""
    cfg = SamplerConfig(temperature=1.0)
    logits = _fixed_logits(2, K + 1)
    p0 = _target_p(logits, cfg)[0]
    rng = np.random.default_rng(3)
    q = torch.softmax(torch.from_numpy(rng.standard_normal((K, V)) * 2.0).float(), -1)
    gen = torch.Generator().manual_seed(1)
    draft = torch.multinomial(q, N_TRIALS, replacement=True, generator=gen).t()
    lg = torch.from_numpy(logits)[None].expand(N_TRIALS, -1, -1)
    toks, _ = _sampled_accept(lg, draft, gen, cfg, q[None].expand(N_TRIALS, -1, -1))
    assert _tv(toks[:, 0], p0) < TV_GATE


def test_all_rejected_draft_is_resampled_from_residual():
    """A point-mass draft on a token top-k filters out (p = 0): never
    accepted, and the correction never emits it."""
    cfg = SamplerConfig(temperature=1.0, top_k=2)
    logits = np.array([[5.0, 4.0, -3.0, 0, 0, 0, 0, 0]] * (K + 1), np.float32)
    toks, a = _trials(logits, [2, 2, 2], cfg, n=4000, seed=2)
    assert int(a.max()) == 0
    assert not bool((toks[:, 0] == 2).any())


def test_single_call_matches_the_batched_form():
    """The round's unbatched call is the batched one at B = 1: the same
    tokens and count from the same generator state."""
    cfg = SamplerConfig(temperature=0.9, top_p=0.9)
    logits = _fixed_logits(5, K + 1)
    draft = torch.tensor([3, 1, -1])
    one = _sampled_accept(torch.from_numpy(logits), draft,
                          torch.Generator().manual_seed(4), cfg)
    many = _trials(logits, draft, cfg, n=1, seed=4)
    assert one[0].tolist() == many[0][0].tolist() and one[1].tolist() == many[1].tolist()


@pytest.fixture(scope="module")
def llama():
    cfg = get_preset("llama-2-7b").scaled(8)
    return cfg, Llama(cfg, init_params(cfg, 0, device="cpu"))


def test_spiked_distribution_matches_greedy(llama):
    """temperature > 0 on a near point mass (1e-4): sampled speculation
    emits greedy speculation's stream."""
    _, model = llama
    prompt = np.asarray([[5, 6, 7, 6, 5, 6, 7, 6]])
    greedy, _ = generate_speculative(model, prompt, 10)
    sampled, _ = generate_speculative(model, prompt, 10,
                                      sampler=SamplerConfig(temperature=1e-4), seed=0)
    assert greedy.tolist() == sampled.tolist()


def test_generate_speculative_sampled_runs(llama):
    cfg, model = llama
    prompt = np.asarray([[1, 2, 3, 4]])
    sampler = SamplerConfig(temperature=0.8, top_k=40)
    out, nf = generate_speculative(model, prompt, 12, sampler=sampler, seed=7)
    assert tuple(out.shape) == (1, 12) and nf >= 1
    assert all(0 <= t < cfg.vocab_size for t in out[0].tolist())
    again, _ = generate_speculative(model, prompt, 12, sampler=sampler, seed=7)
    other, _ = generate_speculative(model, prompt, 12, sampler=sampler, seed=8)
    assert again.tolist() == out.tolist()       # a seed repeats
    assert other.tolist() != out.tolist()       # it is actually sampling


def test_generate_draft_speculative_sampled_runs(llama):
    cfg_t, model = llama
    cfg_d = dataclasses.replace(cfg_t, num_layers=1, name="draft")
    draft = Llama(cfg_d, init_params(cfg_d, 1, device="cpu"))
    out, nft, nfd = generate_draft_speculative(
        model, draft, np.asarray([[1, 2, 3, 4]]), 10, k=3,
        sampler=SamplerConfig(temperature=0.9), seed=3)
    assert tuple(out.shape) == (1, 10) and nft >= 1 and nfd >= 3


def test_no_proposal_round_is_unbiased():
    """draft == -1 (no n-gram match) resamples from the full p: token 0
    keeps its probability."""
    cfg = SamplerConfig(temperature=1.0)
    logits = np.array([[3.0, 0.0, 0.0, 0.0, -1, -1, -1, -1]] * (K + 1), np.float32)
    toks, a = _trials(logits, [-1, -1, -1], cfg, n=8000, seed=4)
    assert int(a.max()) == 0
    assert _tv(toks[:, 0], _target_p(logits, cfg)[0]) < TV_GATE
