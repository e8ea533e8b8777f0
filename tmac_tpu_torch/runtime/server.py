"""Minimal HTTP serving front end over the continuous-batching engine (the
port of ``tmac_tpu/runtime/server.py``).

Stdlib-only (http.server) over the port's engine (runtime/engine.py) and
any tokenizer with ``encode``/``decode`` (runtime/tokenizer.py).

API (JSON over HTTP):
  POST /v1/completions   {"prompt_ids": [int, ...], "max_tokens": int,
                          "eos_id": int|null,
                          "temperature": float, "top_k": int, "top_p": float,
                          "min_p": float, "repeat_penalty": float,
                          "presence_penalty": float,
                          "frequency_penalty": float, "seed": int,
                          "stop": str|[str]  (text stop strings; matched on
                              decoded output with partial-match withholding,
                              generation cancelled live at the match),
                          "stop_token_ids": [int]  (token-level stops,
                              matched in the engine),
                          "logprobs": int  (per-token logprob of the chosen
                              token + that many top alternatives, from the
                              RAW model distribution; non-stream only),
                          "stream": bool}
                      -> {"ids": [int, ...], "uid": int,
                          "finish_reason": "eos"|"stop"|"length",
                          "logprobs": [{"id", "token"?, "logprob",
                                        "top": [...]}, ...]  (when asked)}
     or with "stream": true -> text/event-stream of
                         data: {"ids": [new tokens], "done": false}
                         ...
                         data: {"ids": [], "done": true,
                                "finish_reason": ...}
        (tokens arrive per decode chunk)
     or with a tokenizer configured:
                         {"prompt": "text", ...} -> {"text": "...", ...}
  GET  /v1/stats      -> engine counters
  GET  /health        -> {"ok": true}

OpenAI-compatible surface:
  GET  /v1/models           -> {"object": "list", "data": [{"id": ...}]}
  POST /v1/chat/completions {"messages": [{"role", "content"}, ...],
                             "max_tokens", "temperature", "top_p",
                             "stream"}  (needs a tokenizer with a chat
                             template) -> chat.completion object, or an
                             SSE stream of chat.completion.chunk deltas
                             terminated by `data: [DONE]`

Requests from concurrent clients are batched together by the engine;
each HTTP handler thread blocks until its request completes (or consumes
its stream queue).  One scheduler thread steps the engine: it turns off
autograd for itself (grad mode is per thread), and the engine makes its
model's card the current device for each step, so the CUDA graphs that
warmup captured on another thread replay from it.  A request the engine
refuses (ValueError) is answered 400.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import torch

from tmac_tpu_torch.runtime.engine import InferenceEngine


class StopMatcher:
    """Incremental stop-STRING matching over a decoded token stream.

    Stop strings can straddle token boundaries (a BPE tokenizer rarely
    emits "\\n\\n" or "</s>" as one token), so token-level matching in the
    engine is not enough: this matcher works on the decoded TEXT, and
    withholds the longest tail that could still be the prefix of a stop
    string so a streaming client never sees half a stop sequence
    (llama.cpp's server does the same partial-match buffering).

        m = StopMatcher(["\\nUser:"])
        emit = m.feed(decoded_delta)   # safe-to-emit text
        if m.stopped: ...              # stop hit; m.text is final text
        tail = m.flush()               # at end-of-stream, release the hold
    """

    def __init__(self, stops):
        self.stops = [s for s in stops if s]
        self.pending = ""   # withheld tail (possible stop prefix)
        self.emitted = ""   # everything released so far
        self.stopped = False

    def feed(self, text: str) -> str:
        if self.stopped:
            return ""
        if not self.stops:
            self.emitted += text
            return text
        buf = self.pending + text
        cut = min((i for i in (buf.find(s) for s in self.stops) if i >= 0),
                  default=-1)
        if cut >= 0:
            self.stopped = True
            self.pending = ""
            out, buf = buf[:cut], ""
            self.emitted += out
            return out
        # withhold the longest suffix that is a proper prefix of some stop
        hold = 0
        for h in range(min(max(len(s) for s in self.stops) - 1, len(buf)),
                       0, -1):
            tail = buf[-h:]
            if any(s.startswith(tail) for s in self.stops):
                hold = h
                break
        out = buf[:len(buf) - hold] if hold else buf
        self.pending = buf[len(buf) - hold:] if hold else ""
        self.emitted += out
        return out

    def flush(self) -> str:
        """End of stream without a match: the withheld tail is real text."""
        out, self.pending = self.pending, ""
        self.emitted += out
        return out

    @property
    def text(self) -> str:
        return self.emitted


class ServingEngine:
    """Thread-safe wrapper: submit from any thread, one scheduler thread."""

    def __init__(self, engine: InferenceEngine, poll_s: float = 0.002):
        self.engine = engine
        self._lock = threading.Lock()
        self._events: dict[int, threading.Event] = {}
        self._results: dict[int, list] = {}
        # streaming state: per-uid delta queue + count of tokens delivered
        self._queues: dict[int, queue.Queue] = {}
        self._delivered: dict[int, int] = {}
        # finish reasons captured at completion ("eos"/"stop"/"length");
        # entries are popped by pop_reason (bounded: one per live waiter)
        self._reasons: dict[int, str] = {}
        # logprob records captured at completion for requests that asked
        # for them (engine Request.logprobs_out); popped by pop_logprobs
        self._lps: dict[int, list] = {}
        self._poll_s = poll_s
        self._stop = False
        engine.stream_cb = self._on_tokens
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _on_tokens(self, uid: int, tokens: list, done: bool):
        """Engine callback (scheduler thread): fan out deltas to streaming
        consumers and resolve blocking completions on finish."""
        q = self._queues.get(uid)
        if q is not None:
            sent = self._delivered.get(uid, 0)
            delta = list(tokens[sent:])
            self._delivered[uid] = sent + len(delta)
            if delta or done:
                q.put((delta, done))
        if done:
            # pop the engine's finished entry: the result flows through
            # this callback, and a long-running server must not accumulate
            # one Request per completion forever
            req = self.engine.finished.pop(uid, None)
            if req is not None:
                self._reasons[uid] = req.finish_reason or "length"
                if req.logprobs_out:
                    self._lps[uid] = req.logprobs_out
                # bound the maps: callers normally pop right after
                # completion; drop the oldest entries if a caller that
                # never does accumulates them (insertion-ordered dicts)
                while len(self._reasons) > 4096:
                    self._reasons.pop(next(iter(self._reasons)))
                while len(self._lps) > 4096:
                    self._lps.pop(next(iter(self._lps)))
            # record the result only for a blocking waiter (complete());
            # streaming consumers read their queue -- unconditionally
            # storing would leak an entry per streamed request
            ev = self._events.pop(uid, None)
            if ev:
                self._results[uid] = list(tokens)
                ev.set()

    def _loop(self):
        with torch.no_grad():
            while not self._stop:
                with self._lock:
                    busy = self.engine.pending() > 0
                    if busy:
                        self.engine.step()
                if not busy:
                    time.sleep(self._poll_s)

    def _submit(self, prompt_ids, max_tokens, eos_id, sampling,
                stop_tokens=None, logprobs=0):
        return self.engine.submit(prompt_ids, max_new_tokens=max_tokens,
                                  eos_id=eos_id, stop_tokens=stop_tokens,
                                  logprobs=logprobs, **(sampling or {}))

    def pop_reason(self, uid: int, default: str = "length") -> str:
        """The engine-side finish reason ("eos"/"stop"/"length") recorded
        when the request completed; one-shot (the entry is removed)."""
        with self._lock:
            return self._reasons.pop(uid, default)

    def pop_logprobs(self, uid: int) -> list:
        """Per-token logprob records (engine Request.logprobs_out) for a
        completed request; one-shot.  Empty if none were requested."""
        with self._lock:
            return self._lps.pop(uid, [])

    def complete(self, prompt_ids, max_tokens: int = 128,
                 eos_id: Optional[int] = None, timeout: float = 600.0,
                 sampling: Optional[dict] = None, stop_tokens=None,
                 logprobs: int = 0):
        ev = threading.Event()
        with self._lock:
            uid = self._submit(prompt_ids, max_tokens, eos_id, sampling,
                               stop_tokens, logprobs)
            self._events[uid] = ev
        if not ev.wait(timeout):
            # Clean up fully: free the engine slot (or wait-queue entry) and
            # drop the event/result entries so abandoned requests don't
            # accumulate or keep occupying batch capacity.
            with self._lock:
                self._events.pop(uid, None)
                self._results.pop(uid, None)
                self._reasons.pop(uid, None)
                self._lps.pop(uid, None)
                self.engine.cancel(uid)
            raise TimeoutError(f"request {uid} timed out after {timeout}s")
        return uid, self._results.pop(uid)

    def stream(self, prompt_ids, max_tokens: int = 128,
               eos_id: Optional[int] = None, timeout: float = 600.0,
               sampling: Optional[dict] = None, stop_tokens=None,
               uid_box: Optional[list] = None, logprobs: int = 0):
        """Generator of (delta_tokens, done) tuples as the engine produces
        them -- tokens arrive per decode chunk, BEFORE the request
        completes.  uid_box: optional list the request uid is appended to
        at submission (callers that need the uid for finish-reason lookup
        or response ids; a generator cannot return it earlier)."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            uid = self._submit(prompt_ids, max_tokens, eos_id, sampling,
                               stop_tokens, logprobs)
            self._queues[uid] = q
            self._delivered[uid] = 0
        if uid_box is not None:
            uid_box.append(uid)
        finished = False
        try:
            while True:
                try:
                    delta, done = q.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"stream {uid} stalled for {timeout}s") from None
                yield delta, done
                if done:
                    finished = True
                    return
        finally:
            with self._lock:
                self._queues.pop(uid, None)
                self._delivered.pop(uid, None)
                self._results.pop(uid, None)
                if not finished:
                    # consumer went away mid-stream (client disconnect,
                    # timeout, GeneratorExit, or a live text-stop match):
                    # free the engine slot so the request doesn't keep
                    # decoding as a zombie.  Capture its logprob records
                    # FIRST (a cancelled request never reaches the finish
                    # callback), drop its reason entry (nobody pops it).
                    if logprobs:
                        r = self.engine.request(uid)
                        if r is not None and r.logprobs_out:
                            self._lps[uid] = list(
                                r.logprobs_out[:len(r.output)])
                    self._reasons.pop(uid, None)
                    self.engine.cancel(uid)

    def stats(self):
        return dict(self.engine.stats)

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=5)


def _stops_from_req(req: dict):
    """Parse the OpenAI/llama.cpp stop params: `stop` (string or list of
    strings, matched on DECODED text with partial-match withholding) and
    `stop_token_ids` (list of ints, each an individual stop token --
    vLLM's convention; matched in the engine)."""
    stop = req.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    stop_strs = [s for s in (stop or []) if isinstance(s, str) and s]
    stop_tokens = [[int(t)] for t in (req.get("stop_token_ids") or [])]
    return stop_strs, (stop_tokens or None)


def _fmt_logprobs(ids, recs, tokenizer):
    """Engine logprob records -> JSON-friendly per-token entries, aligned
    1:1 with the generated ids (recs may be shorter if the request was
    cancelled mid-chunk)."""
    out = []
    for tid, rec in zip(ids, recs):
        e = {"id": int(tid), "logprob": rec["logprob"],
             "top": [{"id": int(i), "logprob": float(v)}
                     for i, v in rec["top"]]}
        if tokenizer is not None:
            e["token"] = tokenizer.decode([int(tid)])
            for t in e["top"]:
                t["token"] = tokenizer.decode([t["id"]])
        out.append(e)
    return out


def _sampling_from_req(req: dict) -> Optional[dict]:
    s = {}
    if "temperature" in req:
        s["temperature"] = float(req["temperature"])
    if "top_k" in req:
        s["top_k"] = int(req["top_k"])
    if "top_p" in req:
        s["top_p"] = float(req["top_p"])
    if "min_p" in req:
        s["min_p"] = float(req["min_p"])
    if "repeat_penalty" in req:
        s["repeat_penalty"] = float(req["repeat_penalty"])
    if "presence_penalty" in req:
        s["presence_penalty"] = float(req["presence_penalty"])
    if "frequency_penalty" in req:
        s["frequency_penalty"] = float(req["frequency_penalty"])
    if "seed" in req and req["seed"] is not None:
        # per-request reproducible sampling (engine submit(seed=...))
        s["seed"] = int(req["seed"])
    return s or None


def make_handler(serving: ServingEngine, tokenizer=None,
                 model_name: str = "tmac-tpu-torch"):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"ok": True})
            if self.path == "/v1/stats":
                return self._json(200, serving.stats())
            if self.path == "/v1/models":
                return self._json(200, {"object": "list", "data": [
                    {"id": model_name, "object": "model",
                     "owned_by": "tmac-tpu-torch"}]})
            return self._json(404, {"error": "not found"})

        def _consume_with_stops(self, ids, max_tokens, eos_id, sampling,
                                stop_strs, stop_tokens, strip_eos=False,
                                logprobs=0):
            """Drive a request through the internal stream so text-level
            stop strings can cancel generation LIVE (at chunk granularity)
            instead of truncating after the full max_tokens completion.
            Returns (uid, out_ids, text, finish_reason, logprob_recs);
            text is None when the server has no tokenizer."""
            m = StopMatcher(stop_strs)
            box: list = []
            out: list = []
            prev = ""
            reason = "length"
            gen = serving.stream(ids, max_tokens=max_tokens, eos_id=eos_id,
                                 sampling=sampling, stop_tokens=stop_tokens,
                                 uid_box=box, logprobs=logprobs)
            try:
                for delta, done in gen:
                    out.extend(delta)
                    if tokenizer is not None:
                        vis = [t for t in out if t != eos_id] \
                            if strip_eos else out
                        cum = tokenizer.decode(vis)
                        m.feed(cum[len(prev):])
                        prev = cum
                        if m.stopped:
                            reason = "stop"
                            gen.close()  # finally-cancels the live request
                            break
                    if done:
                        reason = serving.pop_reason(box[0])
                        m.flush()
            except (BrokenPipeError, ConnectionResetError):
                gen.close()
                raise
            text = m.text if tokenizer is not None else None
            recs = serving.pop_logprobs(box[0]) if (logprobs and box) else []
            return (box[0] if box else -1), out, text, reason, recs

        def _stream_response(self, ids, max_tokens, eos_id, sampling,
                             stop_strs=(), stop_tokens=None):
            """Server-sent-events-style incremental token delivery.  With
            stop strings, decoded text is withheld while it could still be
            a stop prefix, and the stream ends at the match with
            finish_reason "stop" (the engine request is cancelled)."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            m = StopMatcher(stop_strs)
            box: list = []
            out: list = []
            prev = ""
            gen = serving.stream(ids, max_tokens=max_tokens, eos_id=eos_id,
                                 sampling=sampling, stop_tokens=stop_tokens,
                                 uid_box=box)

            def send(ev):
                self.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                self.wfile.flush()

            try:
                for delta, done in gen:
                    ev = {"ids": delta, "done": done}
                    if tokenizer is not None and (delta or done):
                        out.extend(delta)
                        cum = tokenizer.decode(out)
                        emit = m.feed(cum[len(prev):])
                        prev = cum
                        if m.stopped:
                            if emit:
                                send({"ids": delta, "done": False,
                                      "text": emit})
                            send({"ids": [], "done": True,
                                  "finish_reason": "stop"})
                            gen.close()  # cancels the live request
                            return
                        if done:
                            emit += m.flush()
                        if emit:
                            ev["text"] = emit
                    if done:
                        ev["finish_reason"] = serving.pop_reason(box[0])
                    send(ev)
            except (BrokenPipeError, ConnectionResetError):
                # client went away: closing the generator runs its finally
                # block, which cancels the engine request
                gen.close()

        def _chat_stream(self, ids, max_tokens, eos_id, sampling, cid,
                         stop_strs=(), stop_tokens=None):
            """OpenAI chat.completion.chunk SSE stream."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

            def chunk(delta: dict, finish=None):
                return ("data: " + json.dumps({
                    "id": cid, "object": "chat.completion.chunk",
                    "model": model_name,
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": finish}],
                }) + "\n\n").encode()

            m = StopMatcher(stop_strs)
            box: list = []
            out: list = []
            prev = ""
            gen = serving.stream(ids, max_tokens=max_tokens, eos_id=eos_id,
                                 sampling=sampling, stop_tokens=stop_tokens,
                                 uid_box=box)
            try:
                self.wfile.write(chunk({"role": "assistant", "content": ""}))
                for delta, done in gen:
                    # keep the streamed text identical to the non-stream
                    # path, which strips eos
                    out.extend(t for t in delta if t != eos_id)
                    cum = tokenizer.decode(out)
                    emit = m.feed(cum[len(prev):])
                    prev = cum
                    if m.stopped:
                        if emit:
                            self.wfile.write(chunk({"content": emit}))
                        self.wfile.write(chunk({}, finish="stop"))
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                        gen.close()  # cancels the live request
                        return
                    if done:
                        emit += m.flush()
                    if emit:
                        self.wfile.write(chunk({"content": emit}))
                    if done:
                        r = serving.pop_reason(box[0])
                        self.wfile.write(chunk(
                            {}, finish="length" if r == "length" else "stop"))
                        self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                gen.close()

        def _chat_completions(self, req: dict):
            """OpenAI-compatible chat endpoint (needs a tokenizer whose
            chat template renders the message list)."""
            if tokenizer is None or not hasattr(tokenizer,
                                                "apply_chat_template"):
                return self._json(400, {"error": {"message":
                    "server has no tokenizer with a chat template",
                    "type": "invalid_request_error"}})
            msgs = req.get("messages")
            if not isinstance(msgs, list) or not msgs:
                return self._json(400, {"error": {"message":
                    "messages must be a non-empty list",
                    "type": "invalid_request_error"}})
            ids = tokenizer.apply_chat_template(msgs,
                                                add_generation_prompt=True)
            max_tokens = int(req.get("max_tokens")
                             or req.get("max_completion_tokens") or 128)
            eos_id = getattr(tokenizer, "eos_token_id", None)
            sampling = _sampling_from_req(req)
            stop_strs, stop_tokens = _stops_from_req(req)
            cid = f"chatcmpl-{int(time.time() * 1000):x}"
            if req.get("stream"):
                return self._chat_stream(ids, max_tokens, eos_id, sampling,
                                         cid, stop_strs, stop_tokens)
            # OpenAI chat logprobs: "logprobs": true (+ "top_logprobs": N)
            n_lp = int(req.get("top_logprobs") or 1) \
                if req.get("logprobs") else 0
            if stop_strs:
                uid, out, text, reason, recs = self._consume_with_stops(
                    ids, max_tokens, eos_id, sampling, stop_strs,
                    stop_tokens, strip_eos=True, logprobs=n_lp)
            else:
                uid, out = serving.complete(ids, max_tokens=max_tokens,
                                            eos_id=eos_id, sampling=sampling,
                                            stop_tokens=stop_tokens,
                                            logprobs=n_lp)
                reason = serving.pop_reason(uid)
                recs = serving.pop_logprobs(uid) if n_lp else []
                text = tokenizer.decode(
                    [t for t in out if eos_id is None or t != eos_id])
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      "finish_reason": "length" if reason == "length"
                      else "stop"}
            if n_lp:
                # records align with the RAW output ids; drop eos entries
                # to match the content string
                choice["logprobs"] = {"content": [
                    {"token": e.get("token", str(e["id"])),
                     "logprob": e["logprob"],
                     "top_logprobs": [
                         {"token": t.get("token", str(t["id"])),
                          "logprob": t["logprob"]} for t in e["top"]]}
                    for e in _fmt_logprobs(out, recs, tokenizer)
                    if e["id"] != eos_id]}
            return self._json(200, {
                "id": cid, "object": "chat.completion",
                "model": model_name,
                "choices": [choice],
                "usage": {"prompt_tokens": len(ids),
                          "completion_tokens": len(out),
                          "total_tokens": len(ids) + len(out)},
            })

        def do_POST(self):
            if self.path == "/v1/chat/completions":
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    return self._chat_completions(
                        json.loads(self.rfile.read(n)))
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    return self._json(
                        500, {"error": f"{type(e).__name__}: {e}"})
            if self.path != "/v1/completions":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                if "prompt_ids" in req:
                    ids = [int(t) for t in req["prompt_ids"]]
                elif tokenizer is not None and "prompt" in req:
                    ids = tokenizer.encode(req["prompt"])
                else:
                    return self._json(400, {"error": "need prompt_ids (or prompt with a tokenizer)"})
                max_tokens = int(req.get("max_tokens", 128))
                eos_id = req.get("eos_id")
                sampling = _sampling_from_req(req)
                stop_strs, stop_tokens = _stops_from_req(req)
                if stop_strs and tokenizer is None:
                    return self._json(400, {"error":
                        "stop strings need a server-side tokenizer "
                        "(use stop_token_ids)"})
                if req.get("stream"):
                    return self._stream_response(ids, max_tokens, eos_id,
                                                 sampling, stop_strs,
                                                 stop_tokens)
                n_lp = int(req.get("logprobs") or 0)
                if stop_strs:
                    uid, out, text, reason, recs = self._consume_with_stops(
                        ids, max_tokens, eos_id, sampling, stop_strs,
                        stop_tokens, logprobs=n_lp)
                    resp = {"uid": uid, "ids": out, "text": text,
                            "finish_reason": reason}
                    if n_lp:
                        resp["logprobs"] = _fmt_logprobs(out, recs,
                                                         tokenizer)
                    return self._json(200, resp)
                uid, out = serving.complete(ids, max_tokens=max_tokens,
                                            eos_id=eos_id, sampling=sampling,
                                            stop_tokens=stop_tokens,
                                            logprobs=n_lp)
                resp = {"uid": uid, "ids": out,
                        "finish_reason": serving.pop_reason(uid)}
                if n_lp:
                    resp["logprobs"] = _fmt_logprobs(
                        out, serving.pop_logprobs(uid), tokenizer)
                if tokenizer is not None:
                    resp["text"] = tokenizer.decode(out)
                return self._json(200, resp)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 -- report, don't crash the server
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8777,
          tokenizer=None, model_name: str = "tmac-tpu-torch"):
    """Blocking serve loop (serve_async starts one in the background)."""
    serving = ServingEngine(engine)
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(serving, tokenizer, model_name))
    print(f"tmac-tpu-torch serving on http://{host}:{port}  "
          f"(batch={engine.B}, max_len={engine.S})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        serving.shutdown()
        httpd.server_close()


def serve_async(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 0,
                tokenizer=None, model_name: str = "tmac-tpu-torch"):
    """Start the server on a background thread; returns (httpd, serving).
    port=0 picks a free port (httpd.server_address[1])."""
    serving = ServingEngine(engine)
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(serving, tokenizer, model_name))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, serving
