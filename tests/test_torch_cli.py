"""The port's command line (``tmac_tpu_torch/tools/cli.py``) on the CPU
(``--device cpu``), mirroring the CLI cases of the JAX package's
``tests/test_tools.py``: convert -> ppl on a synthetic HF directory, the
checkpoint byte for byte the JAX CLI's and the NLL within 1e-5 of the JAX
CLI's on it, score likewise, generate, bench-e2e, trace and export-gguf;
every subcommand is there; no card and no --device cpu, or an unknown
device, raises.

The JAX CLI runs its model at impl="auto", which off the TPU is its XLA
route (float activations); the port's kernels compute the reference's
kernel route (int8 activations), so the JAX CLI's commands run here
in-process with that route (perplexity and score_continuations at
impl="pallas"), and the port takes XLA's rsqrt for its rms_norm and XLA's
prefill rope and attention outputs, recorded inside the JAX CLI's run
(tests/test_torch_per_channel.py): the steps XLA rounds otherwise inside a
jitted forward than torch does, which flip an int8 code now and then.
"""

import argparse
import functools
import json

import jax
import numpy as np
import pytest
import torch

from tests.test_convert import _write_synthetic_hf_gptq
from tests.test_torch_model_presets import given_xla_rsqrt
from tmac_tpu.models import llama as jl
from tmac_tpu_torch.models import llama as tl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu.runtime import perplexity as jppl
from tmac_tpu.tools import cli as jcli
from tmac_tpu_torch.tools import cli

torch.set_num_threads(2)


def _given_xla_prefill_steps(monkeypatch):
    """Record each prefill rope and attention inside the JAX forward
    (jax.debug.callback, whose calls come in no set order), and give each
    of the port's the recorded output whose input equals its own (q and k
    have one shape without GQA, so the input, not the shape, finds it)."""
    rec = dict(ropes=[], attns=[])
    rope, attention = jl.rope, jl._attention

    def keep(name):
        return lambda a, o: rec[name].append((np.asarray(a, np.float32),
                                              np.asarray(o, np.float32)))

    def recording_rope(x, tables):
        out = rope(x, tables)
        if x.shape[1] > 1:
            jax.debug.callback(keep("ropes"), x, out)
        return out

    def recording_attention(q, k_all, v_all, li, *args, **kw):
        out = attention(q, k_all, v_all, li, *args, **kw)
        if q.shape[1] > 1:
            jax.debug.callback(keep("attns"), q, out)
        return out

    def given(name, x):
        xf = x.float().numpy()
        i = next(i for i, (a, _) in enumerate(rec[name])
                 if a.shape == xf.shape and np.array_equal(a, xf))
        return torch.from_numpy(rec[name].pop(i)[1]).to(x.dtype)

    port_rope = tl.rope
    monkeypatch.setattr(jl, "rope", recording_rope)
    monkeypatch.setattr(jl, "_attention", recording_attention)
    monkeypatch.setattr(tl, "rope", lambda x, tables: given("ropes", x) if x.shape[1] > 1
                        else port_rope(x, tables))
    monkeypatch.setattr(tl.Llama, "_prefill_attention", lambda self, q, *a: given("attns", q))


def _jax_cli(monkeypatch, capsys, fn, **kw):
    """One of the JAX CLI's commands in-process on its kernel route, its
    prefill steps recorded for the port's run after it; -> the JSON it
    printed last."""
    given_xla_rsqrt(monkeypatch)
    _given_xla_prefill_steps(monkeypatch)
    monkeypatch.setattr(jppl, "perplexity", functools.partial(_JPPL, impl="pallas"))
    monkeypatch.setattr(jppl, "score_continuations",
                        functools.partial(_JSCORE, impl="pallas"))
    capsys.readouterr()
    fn(argparse.Namespace(**kw))
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


_JPPL, _JSCORE = jppl.perplexity, jppl.score_continuations


def _port_cli(capsys, *argv):
    capsys.readouterr()
    cli.main([*argv, "--device", "cpu"])
    return capsys.readouterr().out.strip().splitlines()


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A synthetic GPTQ HF directory converted by both CLIs."""
    tmp = tmp_path_factory.mktemp("cli")
    hf = tmp / "hf"
    hf.mkdir()
    _write_synthetic_hf_gptq(str(hf), jax_preset("llama-2-7b").scaled(8), bits=2, gs=128)
    cli.main(["convert", "--model-dir", str(hf), "--out", str(tmp / "port"), "--name", "t",
              "--device", "cpu"])
    jcli.cmd_convert(argparse.Namespace(model_dir=str(hf), out=str(tmp / "jax"), bits=None,
                                        group_size=128, zero_point=False, mode="w_fp",
                                        tp=1, name="t"))
    return tmp


def test_cli_convert_is_the_jax_cli_s(converted):
    for f in ("weights.safetensors", "config.json"):
        assert (converted / "port" / f).read_bytes() == (converted / "jax" / f).read_bytes(), f


def test_cli_ppl_matches_the_jax_cli(converted, monkeypatch, capsys):
    toks = converted / "toks.npy"
    np.save(toks, np.random.default_rng(0).integers(0, 500, 80).astype(np.int32))
    want = _jax_cli(monkeypatch, capsys, jcli.cmd_ppl, ckpt=str(converted / "jax"),
                    tokens=str(toks), text="", tokenizer="", window=32)
    got = json.loads(_port_cli(capsys, "ppl", "--ckpt", str(converted / "port"),
                               "--tokens", str(toks), "--window", "32")[-1])
    assert got["tokens"] == want["tokens"] == 62 and got["ppl"] > 1
    assert abs(got["nll"] - want["nll"]) <= 1e-5, (got, want)


def test_cli_score_matches_the_jax_cli(converted, monkeypatch, capsys):
    args = dict(context_ids="1,2,3", continuation_ids="4,5;6")
    want = _jax_cli(monkeypatch, capsys, jcli.cmd_score, ckpt=str(converted / "jax"),
                    **args)
    got = json.loads(_port_cli(capsys, "score", "--ckpt", str(converted / "port"),
                               "--context-ids", args["context_ids"],
                               "--continuation-ids", args["continuation_ids"])[-1])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["greedy"] == w["greedy"]
        assert abs(g["logprob"] - w["logprob"]) <= 1e-5, (g, w)


def test_cli_generate_bench_trace_export(converted, capsys, tmp_path):
    ck = str(converted / "port")
    ids = _port_cli(capsys, "generate", "--ckpt", ck, "--prompt-ids", "1,2,3", "-n", "4")
    assert len(ids[-1].split(",")) == 4
    rows = _port_cli(capsys, "bench-e2e", "--model", "bitnet-3b", "--scale", "8",
                     "--prompt-len", "8", "--steps", "3")
    assert rows[0].startswith("model,batch") and float(rows[1].split(",")[4]) > 0
    trace = tmp_path / "trace.json"
    out = json.loads(_port_cli(capsys, "trace", "--ckpt", ck, "--steps", "3",
                               "--prompt-len", "4", "--out", str(trace))[-1])
    assert out["trace"] == str(trace) and json.loads(trace.read_text())["traceEvents"]
    line = _port_cli(capsys, "export-gguf", "--ckpt", ck, "--out",
                     str(tmp_path / "m.gguf"))[-1]
    assert line.startswith("exported") and (tmp_path / "m.gguf").stat().st_size > 0


def test_every_subcommand_and_the_device_rule(converted):
    ap = cli._parser()
    sub = next(a for a in ap._actions if isinstance(a, argparse._SubParsersAction))
    jsub = set(("convert generate chat bench-e2e bench-serve serve ppl export-gguf score "
                "parity profile autotune microbench trace").split())
    assert set(sub.choices) == set(cli.SUBCOMMANDS) == jsub
    with pytest.raises(ValueError, match="--device"):
        cli.main(["score", "--ckpt", str(converted / "port"), "--context-ids", "1",
                  "--continuation-ids", "2", "--device", "tpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["score", "--ckpt", str(converted / "port"), "--context-ids", "1",
                      "--continuation-ids", "2"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["microbench"])
