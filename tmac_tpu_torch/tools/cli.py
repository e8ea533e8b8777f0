"""The port's command line (``tmac_tpu/tools/cli.py``, the reference's
tools/run_pipeline.py role), every subcommand of the JAX package's:

  convert      HF directory or gguf file -> packed checkpoint
  generate     generation from a packed checkpoint (llama-cli)
  chat         interactive streaming chat on the engine
  bench-e2e    decode and prefill tokens/s (llama-bench)
  bench-serve  mixed-arrival serving bench
  serve        HTTP serving (continuous batching)
  ppl          perplexity over a token or text file (llama-perplexity)
  export-gguf  packed checkpoint -> gguf (llama-quantize)
  score        continuation log-likelihoods (lm-eval's primitive)
  parity       model-level quality gate against the f32 oracle
  profile      kernel profiler CSV
  autotune     the kernels' plan tuner (ops/tune_table.py)
  microbench   hardware probes
  trace        a torch.profiler Chrome trace of a decode run

Everything runs on the card unless ``--device cpu`` is given; without a
card and without it the CLI raises (it does not fall back to the CPU).
``main(argv)`` runs in-process.

    python -m tmac_tpu_torch.tools.cli generate --ckpt DIR --prompt-ids 1,2,3 -n 16
    python -m tmac_tpu_torch.tools.cli ppl --ckpt DIR --tokens toks.npy --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

DEVICES = ("cuda", "cpu")


def device_of(args):
    """The torch device of a run: the card ("cuda", the default) or, when
    asked, the CPU.  Raises without a card, and for any other device."""
    import torch
    name = getattr(args, "device", None) or "cuda"
    if name not in DEVICES:
        raise ValueError(f"--device takes {' or '.join(DEVICES)}, not {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLI runs on the card (pass --device cpu "
                           "to run on the host)")
    return torch.device(name)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def cmd_convert(args):
    from tmac_tpu_torch.convert.checkpoint import save_checkpoint
    from tmac_tpu_torch.models.config import QuantConfig
    dev = device_of(args)
    if args.model_dir.endswith(".gguf"):
        from tmac_tpu_torch.convert.gguf import GGUFReader, convert_gguf_model
        from tmac_tpu_torch.runtime.tokenizer import tokenizer_from_gguf
        cfg, params = convert_gguf_model(args.model_dir, tp=args.tp, name=args.name,
                                         device=dev)
        save_checkpoint(args.out, cfg, params)
        r = GGUFReader(args.model_dir)
        tok = tokenizer_from_gguf(r.metadata)
        r.close()
        extra = ""
        if tok is not None:
            tok.save(args.out)
            extra = f", tokenizer ({tok.MODEL}, {tok.vocab_size} tokens)"
        print(f"converted {args.model_dir} -> {args.out} (gguf, tp={args.tp}{extra})")
        return
    from tmac_tpu_torch.convert.hf import convert_hf_model
    quant = None
    if args.bits is not None:
        quant = QuantConfig(bits=args.bits, group_size=args.group_size,
                            zero_point=args.zero_point, mode=args.mode)
    elif args.mode == "w_a8":
        quant = QuantConfig(bits=2, group_size=-1, mode="w_a8")
    cfg, params = convert_hf_model(args.model_dir, quant=quant, tp=args.tp, name=args.name,
                                   device=dev)
    save_checkpoint(args.out, cfg, params)
    n_tok = _copy_hf_tokenizer(args.model_dir, args.out)
    print(f"converted {args.model_dir} -> {args.out} "
          f"({cfg.quant.bits}-bit, mode={cfg.quant.mode}, tp={args.tp}"
          + (f", +{n_tok} tokenizer files" if n_tok else "") + ")")


def _copy_hf_tokenizer(model_dir: str, out_dir: str) -> int:
    """Copy the HF tokenizer files beside the packed weights, so the
    checkpoint is self-contained."""
    import shutil
    n = 0
    for f in ("tokenizer.json", "tokenizer_config.json", "tokenizer.model",
              "special_tokens_map.json", "vocab.json", "merges.txt",
              "added_tokens.json", "chat_template.jinja"):
        src = os.path.join(model_dir, f)
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(out_dir, f))
            n += 1
    return n


def _load(args, dev):
    from tmac_tpu_torch.convert.checkpoint import load_checkpoint
    return load_checkpoint(args.ckpt, device=dev)


def _model(cfg, params):
    from tmac_tpu_torch.models.llama import Llama
    return Llama(cfg, params)


def _preset_model(args, dev, bits=None):
    """The model of --ckpt, or of --model (a preset, --scale shrinking it)
    with init_params' weights from seed 0."""
    from tmac_tpu_torch.models.config import get_preset
    from tmac_tpu_torch.models.llama import init_params
    if getattr(args, "ckpt", ""):
        cfg, params = _load(args, dev)
    else:
        cfg = get_preset(args.model, bits=bits)
        if getattr(args, "scale", 0):
            cfg = cfg.scaled(args.scale)
        params = init_params(cfg, seed=0, device=dev)
    return cfg, _model(cfg, params)


def _tokenizer_for(args):
    """--tokenizer <HF dir> wins; else the tokenizer saved with the
    checkpoint; else None (token-id mode)."""
    if getattr(args, "tokenizer", ""):
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(args.tokenizer)
    if getattr(args, "ckpt", ""):
        from tmac_tpu_torch.runtime.tokenizer import load_tokenizer
        tok = load_tokenizer(args.ckpt)
        if tok is not None:
            return tok
        if any(os.path.exists(os.path.join(args.ckpt, f))
               for f in ("tokenizer.json", "tokenizer.model", "vocab.json")):
            from transformers import AutoTokenizer
            return AutoTokenizer.from_pretrained(args.ckpt)
    return None


def _sampler(args):
    from tmac_tpu_torch.runtime.sampling import SamplerConfig
    return SamplerConfig(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p)


def cmd_generate(args):
    import numpy as np
    from tmac_tpu_torch.runtime.generate import generate
    dev = device_of(args)
    cfg, params = _load(args, dev)
    model = _model(cfg, params)
    if args.prompt_ids:
        ids = [int(t) for t in args.prompt_ids.split(",")]
    else:
        tok = _tokenizer_for(args)
        if tok is None:
            raise SystemExit("no tokenizer: pass --tokenizer, use --prompt-ids, or convert "
                             "from a gguf (whose tokenizer is saved with the checkpoint)")
        ids = tok.encode(args.prompt)
    sampler = _sampler(args)
    t0 = time.time()
    prompt = np.asarray([ids], np.int32)
    if getattr(args, "draft_ckpt", ""):
        from tmac_tpu_torch.convert.checkpoint import load_checkpoint
        from tmac_tpu_torch.runtime.speculative import generate_draft_speculative
        cfg_d, params_d = load_checkpoint(args.draft_ckpt, device=dev)
        out, nft, nfd = generate_draft_speculative(model, _model(cfg_d, params_d), prompt,
                                                   max_new_tokens=args.n, k=args.spec_k,
                                                   sampler=sampler)
        print(f"[draft-speculative: {args.n} tokens in {nft} target + {nfd} draft "
              "forwards]", file=sys.stderr)
    elif getattr(args, "speculative", False):
        from tmac_tpu_torch.runtime.speculative import generate_speculative
        out, nf = generate_speculative(model, prompt, max_new_tokens=args.n, sampler=sampler)
        print(f"[speculative: {args.n} tokens in {nf} forwards]", file=sys.stderr)
    else:
        out = generate(model, prompt, max_new_tokens=args.n, sampler=sampler)
    out = out.cpu().numpy()[0]
    print(f"[{args.n} tokens in {time.time() - t0:.1f}s on {dev}]", file=sys.stderr)
    if args.prompt_ids:
        print(",".join(map(str, out.tolist())))
    else:
        print(tok.decode(out.tolist()))


def cmd_chat(args):
    """Interactive streaming chat on the engine (one slot); each turn
    resubmits the conversation and the prefix cache prefills only the
    newest turn."""
    from tmac_tpu_torch.runtime.engine import InferenceEngine
    dev = device_of(args)
    _, model = _preset_model(args, dev)
    tok = _tokenizer_for(args)
    eng = InferenceEngine(model, max_batch=1, max_len=args.max_len, sampler=_sampler(args),
                          decode_chunk=args.decode_chunk,
                          max_decode_chunk=args.max_decode_chunk, prefix_cache_size=2,
                          prefix_cache_max_len=args.max_len, kv_quant=args.kv_quant)
    printed = {"n": 0}

    def cb(uid, toks_so_far, done):
        if tok is None:
            new = toks_so_far[printed["n"]:]
            if new:
                print(("," if printed["n"] else "") + ",".join(map(str, new)), end="",
                      flush=True)
            printed["n"] = len(toks_so_far)
        else:
            text = tok.decode(toks_so_far, skip_special_tokens=True)
            print(text[printed["n"]:], end="", flush=True)
            printed["n"] = len(text)
        if done:
            print(flush=True)

    eng.stream_cb = cb
    eos = tok.eos_token_id if tok is not None else None
    msgs, ids_hist = [], []
    print("chat ready (empty line or /exit quits" + ("; raw token-id mode)" if tok is None
                                                      else ")"), file=sys.stderr)
    while True:
        try:
            user = input("user> ")
        except EOFError:
            break
        if not user.strip() or user.strip() in ("/exit", "/quit"):
            break
        if tok is not None and getattr(tok, "chat_template", None):
            msgs.append({"role": "user", "content": user})
            prompt_ids = tok.apply_chat_template(msgs, add_generation_prompt=True)
        elif tok is not None:
            msgs.append({"role": "user", "content": user})
            prompt_ids = tok.encode("".join(f"{m['role']}: {m['content']}\n" for m in msgs)
                                    + "assistant:")
        else:
            ids_hist += [int(t) for t in user.replace(",", " ").split()]
            prompt_ids = list(ids_hist)
        printed["n"] = 0
        t0 = time.time()
        uid = eng.submit(prompt_ids, max_new_tokens=args.n, eos_id=eos)
        out = eng.run()[uid]
        if tok is not None:
            msgs.append({"role": "assistant",
                         "content": tok.decode(out, skip_special_tokens=True)})
        else:
            ids_hist += [int(t) for t in out]
        print(f"[{len(out)} tokens in {time.time() - t0:.1f}s; prefix tokens reused so "
              f"far: {eng.stats['prefix_tokens_reused']}]", file=sys.stderr)


def cmd_bench_e2e(args):
    """Decode + prefill throughput -> CSV on stdout: prefill tokens/s (host
    clock around the prefill and a synchronize, best of 3), decode tokens/s
    (decode_loop: on the card its replayed CUDA graph, timed by its own
    CUDA events; best of 3)."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.generate import decode_loop, prefill
    dev = device_of(args)
    cfg, model = _preset_model(args, dev, args.bits)
    print("model,batch,prompt_len,steps,decode_tok_s,prefill_tok_s")
    rng = np.random.default_rng(0)
    for B in args.batch:
        S = args.prompt_len + args.steps
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, args.prompt_len)),
                               device=dev)
        with torch.no_grad():
            prefill(model, toks, KVCache.create(cfg, B, S, device=dev))   # warm-up
            t_pre = float("inf")
            for _ in range(3):
                cache = KVCache.create(cfg, B, S, device=dev)
                _sync(dev)
                t0 = time.perf_counter()
                logits, cache = prefill(model, toks, cache)
                _sync(dev)
                t_pre = min(t_pre, time.perf_counter() - t0)
            best = float("inf")
            for _ in range(3):
                cache = KVCache.create(cfg, B, S, device=dev)
                logits, cache = prefill(model, toks, cache)
                first = logits.argmax(-1).to(torch.int32)
                stats = {}
                _sync(dev)
                t0 = time.perf_counter()
                decode_loop(model, first, cache, steps=args.steps, stats=stats)
                _sync(dev)
                wall = time.perf_counter() - t0
                ev = stats.get("replay_events")
                if ev is not None and stats.get("replays"):
                    # the replayed steps' device time, per step
                    per = ev[0].elapsed_time(ev[1]) / 1e3 / stats["replays"]
                    wall = per * args.steps
                best = min(best, wall)
        name = args.ckpt or args.model
        print(f"{name},{B},{args.prompt_len},{args.steps},{B * args.steps / best:.2f},"
              f"{B * args.prompt_len / t_pre:.2f}")


def _engine(args, model):
    from tmac_tpu_torch.runtime.engine import InferenceEngine
    from tmac_tpu_torch.runtime.sampling import SamplerConfig
    return InferenceEngine(model, max_batch=args.max_batch, max_len=args.max_len,
                           sampler=_sampler(args) if hasattr(args, "temperature")
                           else SamplerConfig(),
                           decode_chunk=args.decode_chunk,
                           max_decode_chunk=args.max_decode_chunk,
                           speculative=getattr(args, "speculative", False),
                           prefix_cache_size=args.prefix_cache, kv_quant=args.kv_quant)


def cmd_serve(args):
    from tmac_tpu_torch.runtime.server import serve
    dev = device_of(args)
    cfg, model = _preset_model(args, dev)
    serve(_engine(args, model), host=args.host, port=args.port,
          tokenizer=_tokenizer_for(args), model_name=cfg.name)


def cmd_ppl(args):
    import numpy as np
    from tmac_tpu_torch.runtime.perplexity import perplexity
    dev = device_of(args)
    cfg, params = _load(args, dev)
    if getattr(args, "text", ""):
        tok = _tokenizer_for(args)
        if tok is None:
            raise SystemExit("--text needs a tokenizer: pass --tokenizer or use a "
                             "gguf-converted checkpoint")
        with open(args.text) as f:
            stream = np.asarray(tok.encode(f.read()), np.int32)
    elif not args.tokens:
        raise SystemExit("pass --tokens (ids) or --text (raw corpus)")
    elif args.tokens.endswith(".npy"):
        stream = np.load(args.tokens)
    else:
        with open(args.tokens) as f:
            stream = np.asarray([int(t) for t in f.read().split()], np.int32)
    print(json.dumps(perplexity(_model(cfg, params), stream, window=args.window)))


def cmd_export_gguf(args):
    from tmac_tpu_torch.convert.gguf_export import export_gguf
    dev = device_of(args)
    cfg, params = _load(args, dev)
    r = export_gguf(args.out, cfg, params, wtype=args.wtype, ckpt_dir=args.ckpt)
    print(f"exported {args.ckpt} -> {r['path']} ({r['wtype']}, {r['tensors']} tensors, "
          f"{r['bytes'] / 1e6:.1f} MB)")


def cmd_score(args):
    from tmac_tpu_torch.runtime.perplexity import score_continuations
    dev = device_of(args)
    cfg, params = _load(args, dev)
    ctx = [int(t) for t in args.context_ids.split(",")]
    conts = [[int(t) for t in c.split(",")] for c in args.continuation_ids.split(";")]
    print(json.dumps(score_continuations(_model(cfg, params), ctx, conts)))


def cmd_parity(args):
    from tmac_tpu_torch.tools import parity
    dev = device_of(args)
    configs = None
    if args.presets:
        configs = [c for c in parity.GATE_CONFIGS if c[0] in args.presets]
        if not configs:
            raise SystemExit(f"no match among {[c[0] for c in parity.GATE_CONFIGS]}")
    rows = parity.run_gate(configs=configs, scale=args.scale, impl=args.impl,
                           seed=args.seed, device=dev)
    print(parity.format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


def cmd_profile(args):
    from tmac_tpu_torch.tools import profile_kernels
    return profile_kernels.main(args.rest)


def cmd_autotune(args):
    from tmac_tpu_torch.tools import autotune
    return autotune.main(args.rest)


def cmd_microbench(args):
    from tmac_tpu_torch.tools import microbench
    return microbench.main(args.rest)


def cmd_bench_serve(args):
    """Mixed-arrival continuous-batching bench -> JSON on stdout."""
    import numpy as np
    from tmac_tpu_torch.runtime.bench_serve import run_serve_bench
    dev = device_of(args)
    cfg, model = _preset_model(args, dev, args.bits)
    eng = _engine(args, model)
    rng = np.random.default_rng(0)
    shared = ([int(t) for t in rng.integers(1, cfg.vocab_size, args.shared_prefix)]
              if args.shared_prefix else [])
    tail = max(args.prompt_len - len(shared), 1)
    prompts = [shared + [int(t) for t in rng.integers(1, cfg.vocab_size, tail)]
               for _ in range(args.requests)]
    eng.warmup()
    eng.submit(prompts[0], max_new_tokens=2)
    eng.run()
    eng.finished.clear()
    for k in eng.stats:
        if isinstance(eng.stats[k], (int, float)):
            eng.stats[k] = 0 if not isinstance(eng.stats[k], float) else 0.0
    r = run_serve_bench(eng, prompts, args.max_new, args.rate)
    r["prefix_hits"] = eng.stats["prefix_hits"]
    r["prefix_tokens_reused"] = eng.stats["prefix_tokens_reused"]
    print(json.dumps(r))


def cmd_trace(args):
    """A torch.profiler trace (CPU and, on the card, CUDA activity) of a
    decode run after a warm-up one, written as a Chrome trace."""
    import numpy as np
    import torch
    from tmac_tpu_torch.models.llama import KVCache
    from tmac_tpu_torch.runtime.generate import decode_loop, prefill
    dev = device_of(args)
    cfg, model = _preset_model(args, dev)
    B, S = args.batch, args.prompt_len + args.steps
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, args.prompt_len)), device=dev)

    def run():
        with torch.no_grad():
            logits, cache = prefill(model, toks, KVCache.create(cfg, B, S, device=dev))
            out, _ = decode_loop(model, logits.argmax(-1).to(torch.int32), cache,
                                 steps=args.steps)
        _sync(dev)
        return out
    run()  # warm-up: the graph's capture and the kernels' build outside the trace
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        run()
    out = args.out if args.out.endswith(".json") else os.path.join(args.out, "trace.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    prof.export_chrome_trace(out)
    events = prof.key_averages()
    dev_us = sum(getattr(e, "device_time_total", 0.0) or 0.0 for e in events)
    print(json.dumps({"trace": out, "events": len(events), "device": str(dev),
                      "device_time_us": dev_us}))
    return out


def _parser():
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda",
                        help="cuda (the card, default) or cpu")
    ap = argparse.ArgumentParser(prog="tmac-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        p = sub.add_parser(name, parents=[common], **kw)
        p.set_defaults(fn=fn)
        return p

    c = add("convert", cmd_convert, help="HF checkpoint or gguf -> packed checkpoint")
    c.add_argument("--model-dir", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--bits", type=int, default=None)
    c.add_argument("--group-size", type=int, default=128)
    c.add_argument("--zero-point", action="store_true")
    c.add_argument("--mode", default="w_fp", choices=["w_fp", "w_a8"])
    c.add_argument("--tp", type=int, default=1)
    c.add_argument("--name", default="hf-model")

    g = add("generate", cmd_generate, help="generate tokens from a checkpoint")
    g.add_argument("--ckpt", required=True)
    g.add_argument("--prompt", default="")
    g.add_argument("--prompt-ids", default="")
    g.add_argument("--tokenizer", default="")
    g.add_argument("-n", type=int, default=64)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--speculative", action="store_true",
                   help="lookup speculative decoding (greedy; lossless)")
    g.add_argument("--draft-ckpt", default="",
                   help="packed checkpoint of a small draft model: two-model "
                        "speculative decoding (greedy; lossless)")
    g.add_argument("--spec-k", type=int, default=4, help="draft tokens per verification")

    ch = add("chat", cmd_chat, help="interactive streaming chat")
    ch.add_argument("--ckpt", default="")
    ch.add_argument("--model", default="bitnet-3b")
    ch.add_argument("--tokenizer", default="")
    ch.add_argument("-n", type=int, default=256)
    ch.add_argument("--max-len", type=int, default=2048)
    ch.add_argument("--decode-chunk", type=int, default=8)
    ch.add_argument("--max-decode-chunk", type=int, default=0)
    ch.add_argument("--temperature", type=float, default=0.7)
    ch.add_argument("--top-k", type=int, default=0)
    ch.add_argument("--top-p", type=float, default=1.0)
    ch.add_argument("--scale", type=int, default=0, help="shrink the preset (smoke tests)")
    ch.add_argument("--kv-quant", action="store_true", help="int8 KV cache")

    b = add("bench-e2e", cmd_bench_e2e, help="tokens/s sweep")
    b.add_argument("--ckpt", default="")
    b.add_argument("--model", default="bitnet-3b")
    b.add_argument("--bits", type=int, default=None)
    b.add_argument("--batch", type=int, nargs="+", default=[1])
    b.add_argument("--prompt-len", type=int, default=16)
    b.add_argument("--steps", type=int, default=64)
    b.add_argument("--scale", type=int, default=0, help="shrink the preset (0 = full size)")

    bs = add("bench-serve", cmd_bench_serve, help="mixed-arrival serving bench")
    bs.add_argument("--ckpt", default="")
    bs.add_argument("--model", default="bitnet-3b")
    bs.add_argument("--bits", type=int, default=None)
    bs.add_argument("--scale", type=int, default=0)
    bs.add_argument("--max-batch", type=int, default=8)
    bs.add_argument("--max-len", type=int, default=1024)
    bs.add_argument("--requests", type=int, default=32)
    bs.add_argument("--rate", type=float, default=4.0, help="mean arrivals per second")
    bs.add_argument("--prompt-len", type=int, default=128)
    bs.add_argument("--max-new", type=int, default=64)
    bs.add_argument("--decode-chunk", type=int, default=8)
    bs.add_argument("--max-decode-chunk", type=int, default=0)
    bs.add_argument("--shared-prefix", type=int, default=0)
    bs.add_argument("--prefix-cache", type=int, default=0)
    bs.add_argument("--kv-quant", action="store_true", help="int8 KV cache")

    s = add("serve", cmd_serve, help="HTTP serving (continuous batching)")
    s.add_argument("--ckpt", default="")
    s.add_argument("--model", default="bitnet-3b")
    s.add_argument("--scale", type=int, default=0)
    s.add_argument("--tokenizer", default="")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8777)
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--max-len", type=int, default=2048)
    s.add_argument("--decode-chunk", type=int, default=16)
    s.add_argument("--max-decode-chunk", type=int, default=0)
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--top-p", type=float, default=1.0)
    s.add_argument("--speculative", action="store_true",
                   help="single-stream lookup speculation (--max-batch 1)")
    s.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    s.add_argument("--prefix-cache", type=int, default=8,
                   help="prompt-prefix KV cache entries (0 disables)")

    p = add("ppl", cmd_ppl, help="perplexity over a token or text file")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--tokens", default="", help=".npy or whitespace ids")
    p.add_argument("--text", default="", help="raw text (the checkpoint's tokenizer)")
    p.add_argument("--tokenizer", default="")
    p.add_argument("--window", type=int, default=512)

    xg = add("export-gguf", cmd_export_gguf, help="packed checkpoint -> gguf")
    xg.add_argument("--ckpt", required=True)
    xg.add_argument("--out", required=True, help="output .gguf path")
    xg.add_argument("--wtype", default="auto",
                    help="matmul block type (Q4_0/Q4_1/Q5_0/Q5_1/Q8_0/Q4_K/Q5_K/Q6_K/"
                         "TQ1_0/TQ2_0/I2_S; default from the quant mode)")

    sc = add("score", cmd_score, help="continuation log-likelihoods")
    sc.add_argument("--ckpt", required=True)
    sc.add_argument("--context-ids", required=True, help="comma-separated token ids")
    sc.add_argument("--continuation-ids", required=True,
                    help="semicolon-separated comma-lists, one per choice")

    pa = add("parity", cmd_parity, help="model-level quality gate vs the f32 oracle")
    pa.add_argument("--presets", nargs="*", default=None,
                    help="gate config labels (default: all)")
    pa.add_argument("--scale", type=int, default=0, help="shrink factor (0 = full size)")
    pa.add_argument("--impl", default="auto", choices=["auto", "plain"])
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--json", default=None, help="also write the rows to this file")

    for name, fn, hlp in (("profile", cmd_profile, "kernel profiler (pass-through args)"),
                          ("autotune", cmd_autotune, "the kernels' plan tuner"),
                          ("microbench", cmd_microbench, "hardware probes")):
        pr = sub.add_parser(name, help=hlp)
        pr.add_argument("rest", nargs=argparse.REMAINDER)
        pr.set_defaults(fn=fn)

    tr = add("trace", cmd_trace, help="a torch.profiler Chrome trace of a decode run")
    tr.add_argument("--ckpt", default="")
    tr.add_argument("--model", default="bitnet-3b")
    tr.add_argument("--scale", type=int, default=0)
    tr.add_argument("--out", default="tmac-trace/trace.json")
    tr.add_argument("--batch", type=int, default=1)
    tr.add_argument("--prompt-len", type=int, default=16)
    tr.add_argument("--steps", type=int, default=16)
    return ap


SUBCOMMANDS = ("convert", "generate", "chat", "bench-e2e", "bench-serve", "serve", "ppl",
               "export-gguf", "score", "parity", "profile", "autotune", "microbench", "trace")


def main(argv=None):
    ap = _parser()
    # parse_known_args so pass-through flags (profile, autotune, microbench) survive
    args, extra = ap.parse_known_args(argv)
    if hasattr(args, "rest"):
        args.rest = list(args.rest) + extra
    elif extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    main()
