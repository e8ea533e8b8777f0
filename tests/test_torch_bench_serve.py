"""The port's serving bench (tmac_tpu_torch/runtime/bench_serve.py) on the
CPU at llama-2-7b scaled(8): tests/test_server.py's bench test, and the
port's per-prompt budgets and uids in prompt order."""

import numpy as np
import pytest
import torch

from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import Llama, init_params
from tmac_tpu_torch.runtime.bench_serve import run_serve_bench
from tmac_tpu_torch.runtime.engine import InferenceEngine
from tmac_tpu_torch.runtime.generate import generate

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    cfg = get_preset("llama-2-7b").scaled(8)
    return Llama(cfg, init_params(cfg, seed=0, device="cpu"))


def _prompts(cfg, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in lens]


def test_bench_serve_mixed_arrivals(model):
    """All requests finish, stats sane, and TTFT stays bounded while other
    requests decode."""
    eng = InferenceEngine(model, max_batch=4, max_len=64, decode_chunk=2,
                          prefill_chunk=16)
    prompts = _prompts(model.cfg, (3, 20, 7, 30, 5, 12))
    r = run_serve_bench(eng, prompts, max_new=6, arrival_rate=50.0)
    assert r["requests"] == 6
    assert r["decode_tokens"] > 0 and r["aggregate_tok_s"] > 0
    assert r["ttft_p95_s"] <= r["latency_p95_s"]
    assert len(eng.finished) == 6
    for req in eng.finished.values():
        assert len(req.output) == 6


def test_bench_serve_budgets_and_streams(model):
    """Per-prompt budgets; the uids come in prompt order, and each stream
    is the prompt's single-stream greedy generate whatever the arrivals."""
    eng = InferenceEngine(model, max_batch=2, max_len=64, decode_chunk=4,
                          prefill_chunk=16)
    prompts = _prompts(model.cfg, (4, 18, 9), seed=2)
    budgets = [3, 7, 5]
    r = run_serve_bench(eng, prompts, max_new=budgets, arrival_rate=200.0, seed=3)
    assert r["prefill_tokens"] == sum(map(len, prompts))
    for uid, p, n in zip(r["uids"], prompts, budgets):
        assert eng.finished[uid].output == generate(
            model, np.asarray([p]), n)[0].tolist()
    with pytest.raises(ValueError, match="budgets"):
        run_serve_bench(eng, prompts, max_new=[1, 2], arrival_rate=1.0)
