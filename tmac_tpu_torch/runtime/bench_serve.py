"""Mixed-arrival serving benchmark: aggregate throughput and latency
percentiles under continuous batching (the port of
``tmac_tpu/runtime/bench_serve.py``).

Drives an InferenceEngine with a deterministic Poisson arrival process and
reports aggregate decode tokens/s, time to first token (TTFT: submit ->
first output token committed) and per-request completion latency, all on
the host's clock around the engine's steps (each step ends in the host
sync that reads its tokens).  The interleaved prefill/decode scheduler
(engine.prefill_budget) is what keeps TTFT bounded while decodes run.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Union

import numpy as np


def run_serve_bench(engine, prompts: List[List[int]],
                    max_new: Union[int, Sequence[int]], arrival_rate: float,
                    seed: int = 0, eos_id: Optional[int] = None) -> dict:
    """Submit `prompts` with exponential inter-arrival gaps (mean
    1/arrival_rate seconds) while stepping the engine; returns aggregate
    stats, unrounded, and the requests' uids in prompt order.  max_new: one
    token budget for every prompt, or one a prompt.  Single-threaded:
    arrivals are injected between engine ticks at their due time
    (deterministic given the seed)."""
    budgets = [max_new] * len(prompts) if isinstance(max_new, int) else list(max_new)
    if len(budgets) != len(prompts):
        raise ValueError(f"{len(budgets)} budgets for {len(prompts)} prompts")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / arrival_rate, len(prompts))
    due = np.cumsum(gaps)

    submit_t: dict[int, float] = {}
    first_tok_t: dict[int, float] = {}
    done_t: dict[int, float] = {}
    uids: List[int] = []
    t0 = time.perf_counter()
    while len(done_t) < len(prompts):
        now = time.perf_counter() - t0
        while len(uids) < len(prompts) and now >= due[len(uids)]:
            i = len(uids)
            uids.append(engine.submit(prompts[i], max_new_tokens=budgets[i],
                                      eos_id=eos_id))
            submit_t[uids[-1]] = time.perf_counter()
            now = time.perf_counter() - t0
        if engine.pending():
            engine.step()
        elif len(uids) < len(prompts):
            time.sleep(min(0.002, max(0.0, due[len(uids)] - now)))
        # record first-token times and completions
        for req in list(engine.slots):
            if req is not None and req.output and req.uid not in first_tok_t:
                first_tok_t[req.uid] = time.perf_counter()
        for uid in uids:
            req = engine.finished.get(uid)
            if req is not None and uid not in done_t:
                if uid not in first_tok_t:
                    first_tok_t[uid] = time.perf_counter()
                done_t[uid] = time.perf_counter()

    wall = time.perf_counter() - t0
    total_new = sum(len(engine.finished[u].output) for u in uids)
    ttft = np.array([first_tok_t[u] - submit_t[u] for u in uids])
    lat = np.array([done_t[u] - submit_t[u] for u in uids])
    return {
        "requests": len(prompts),
        "wall_s": wall,
        "aggregate_tok_s": total_new / wall,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "ttft_p95_s": float(np.percentile(ttft, 95)),
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "prefill_tokens": engine.stats["prefill_tokens"],
        "decode_tokens": engine.stats["decode_tokens"],
        "uids": uids,
    }
