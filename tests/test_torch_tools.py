"""The port's tools on the CPU (``tmac_tpu_torch/tools``, ``platform.py``),
mirroring the JAX package's ``tests/test_tools.py`` (not its ``parallel/``
cases, whose module is not ported yet): the timing chain, the microbench
probes, the profiler's row on a tiny shape, the card's spec table, and
perplexity and scores on the port's model.  On the CPU the tools time
the host's clock and name no card; their device numbers come only from a
run on the card (chip_smoke.py --phase tools_path)."""

import numpy as np
import pytest
import torch

from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
from tmac_tpu_torch.runtime.perplexity import perplexity, score_continuations
from tmac_tpu_torch.tools import microbench, profile_kernels, timing

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bitnet():
    cfg = get_preset("bitnet-3b").scaled(8)
    return cfg, Llama(cfg, init_params(cfg, seed=0, device="cpu"))


def test_perplexity_sane(bitnet):
    cfg, model = bitnet
    stream = np.random.default_rng(0).integers(0, cfg.vocab_size, 64).astype(np.int32)
    r = perplexity(model, stream, window=32)
    assert r["tokens"] == 62  # two windows x 31 predictions
    assert 0 < r["nll"] < 20 and r["ppl"] > 1


def test_score_continuations_matches_window_nll(bitnet):
    """score_continuations == the log-softmax sums of one forward of each
    context + continuation; greedy iff the continuation is the argmax."""
    cfg, model = bitnet
    ctx = [5, 9, 2]
    conts = [[7, 11], [3], [7, 12, 4]]
    got = score_continuations(model, ctx, conts)
    for c, r in zip(conts, got):
        row = ctx + c
        with torch.no_grad():
            logits, _ = model(torch.as_tensor([row]), KVCache.create(cfg, 1, len(row),
                                                                     device="cpu"))
        lp = torch.log_softmax(logits[0, :-1].float(), -1)
        want = sum(float(lp[len(ctx) - 1 + i, t]) for i, t in enumerate(c))
        assert abs(r["logprob"] - want) < 1e-3, (r, want)
        am = [int(lp[len(ctx) - 1 + i].argmax()) for i in range(len(c))]
        assert r["greedy"] == (am == c)


def test_bench_chained_on_the_cpu():
    """A dependent chain of calls: the time a call of a step that does
    measurable work is positive and below the chain's; a step whose out is
    the next x (feedback None) chains without the feedback pass."""
    x0 = torch.ones(256, 256)
    t = timing.bench_chained(lambda x: (x @ x, x @ x), x0, iters=4, reps=2)
    assert 2e-7 <= t < 1.0
    seen = []

    def step(x):
        seen.append(x.clone())
        return x + 1, None
    timing.bench_chained(step, torch.zeros(4), iters=3, reps=1)
    assert [float(s[0]) for s in seen] == [0.0, 0.0, 1.0, 2.0]   # warm-up, then the chain
    assert timing.null_roundtrip() >= 0.0


def test_microbench_probes_run_on_cpu():
    """The probes run and give finite numbers (tiny sizes), and main
    prints a row a probe with the device it ran on."""
    rows = microbench.probe_hbm_copy(0.0, sizes_mb=(1,), device="cpu")
    rows += microbench.probe_hbm_read(1, device="cpu")
    rows += microbench.probe_mma(0.0, n=64, device="cpu")
    rows += microbench.probe_shiftmask(0.0, mb=1, device="cpu")
    rows += microbench.probe_gather(0.0, K=256, M=128, device="cpu")
    assert len(rows) == 6
    for r in rows:
        assert all(np.isfinite(v) and v >= 0 for v in r.values() if isinstance(v, float))
    out = microbench.main(["--device", "cpu", "--probes", "hbm", "shiftmask"])
    assert [r["probe"] for r in out] == ["hbm_rw_1MB", "hbm_read_1MB", "shiftmask_1MB"]
    assert {r["device"] for r in out} == {"cpu"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal is the no-card case")
@pytest.mark.parametrize("probe,args", [
    ("probe_hbm_copy", (0.0, (1,))), ("probe_hbm_read", (1,)), ("probe_mma", (0.0, 64)),
    ("probe_shiftmask", (0.0, 1)), ("probe_gather", (0.0, 256, 128))])
def test_microbench_probe_without_a_device_raises_off_the_card(probe, args):
    """A probe given no device runs on the card, and without one raises:
    it never measures the host and reports the rate as the card's."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(microbench, probe)(*args)


@pytest.mark.parametrize("mode,act,N,kernel", [
    ("w_fp", "auto", 1, "K4"), ("w_fp", "auto", 64, "K4L"), ("w_fp", "auto", 384, "K5"),
    ("w_fp", "native", 4, "K4"), ("w_a8", "auto", 1, "K1"), ("w_a8", "auto", 64, "K3")])
def test_profile_shape_tiny(mode, act, N, kernel):
    """profile_shape's row on a tiny shape: the route's kernel for act,
    the kernel's and the dequant baseline's times; no speed of light off
    the card."""
    r = profile_kernels.profile_shape(2, 256, 512, N, mode=mode, iters=2, device="cpu",
                                      act=act)
    assert r["kernel"] == kernel and r["N"] == N and r["act"] == act
    assert r["kernel_us"] > 0 and r["dequant_baseline_us"] > 0
    assert "pct_sol" not in r


def test_profile_main_writes_csv(tmp_path, monkeypatch):
    monkeypatch.setitem(profile_kernels.SHAPE_PRESETS, "tiny", [(2, 256, 256), (4, 128, 256)])
    out = tmp_path / "p.csv"
    rows = profile_kernels.main(["--preset", "tiny", "--n", "1", "4", "--iters", "2",
                                 "--device", "cpu", "--out", str(out)])
    assert len(rows) == 4
    lines = out.read_text().splitlines()
    assert lines[0].split(",")[:7] == ["bits", "M", "K", "N", "mode", "act", "kernel"]
    assert len(lines) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profile_kernels.main(["--preset", "tiny"])


def test_platform_spec_table():
    """The card's spec by its name (the data-sheet values chip_smoke.py
    bounds kernels with), H200 before H100; an unknown card raises."""
    from tmac_tpu_torch.platform import decode_speed_of_light_tps, device_spec
    h100 = device_spec("NVIDIA H100 80GB HBM3")
    assert (h100.hbm_gbps, h100.bf16_tflops, h100.int8_tops, h100.hbm_gib) == \
        (3350.0, 989.0, 1979.0, 80.0)
    assert h100.kind == "NVIDIA H100 80GB HBM3" and h100.smem_kib == 227.0
    assert device_spec("NVIDIA H200").hbm_gbps == 4800.0
    assert device_spec("NVIDIA H100 PCIe").hbm_gbps == 2000.0
    assert decode_speed_of_light_tps(3.35e9, "NVIDIA H100 80GB HBM3") == pytest.approx(1000.0)
    assert h100.hbm_bytes_per_s == 3.35e12 and h100.l2_mib == 50.0
    with pytest.raises(ValueError, match="no spec"):
        device_spec("TPU v5 lite")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_spec()
