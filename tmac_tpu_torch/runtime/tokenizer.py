"""Self-contained tokenizers for gguf artifacts: the port's own copy of
``tmac_tpu/runtime/tokenizer.py``, with the same classes, functions and
behaviour (importing the JAX package's module would import jax; this one
needs the standard library, and jinja2 for chat templates).

llama.cpp ships the tokenizer INSIDE the gguf file (`tokenizer.ggml.*`
metadata: token table, merge list, scores, special ids), so a reference
user runs end-to-end from one artifact with no HF tokenizer directory
(reference tools/run_pipeline.py:222-277 passes only the gguf to
llama-cli).  This module gives converted checkpoints the same property:
`tokenizer_from_gguf` rebuilds the tokenizer from gguf metadata, the JAX
package's convert CLI saves it beside the packed weights
(`TOKENIZER_FILE`), and `load_tokenizer` reads it back from a checkpoint
directory.

Two vocab families cover the model zoo:
  - "llama"  -> SentencePiece-style greedy bigram merge by score, with
                <0xXX> byte fallback (llama-2, mistral/mixtral).
  - "gpt2"   -> byte-level BPE by merge rank (llama-3, qwen2, phi-3.5).

The API surface matches what the CLI/server already use from HF
tokenizers: encode / decode(..., skip_special_tokens=) / eos_token_id /
bos_token_id, plus apply_chat_template when the gguf carries a
`tokenizer.chat_template` and jinja2 is importable.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Any, Dict, List, Optional, Sequence

# llama.cpp token_type enum (llama_token_type in the vocab table)
TT_NORMAL, TT_UNKNOWN, TT_CONTROL, TT_USER_DEFINED, TT_UNUSED, TT_BYTE = \
    1, 2, 3, 4, 5, 6

_SP_SPACE = "▁"  # '▁'

TOKENIZER_FILE = "tmac_tokenizer.json"


def _split_on_specials(text: str, specials: Dict[str, int]):
    """Yield (piece, special_id_or_None): special-token strings embedded
    in the text (chat-template markers like <|eot_id|>) map directly to
    their ids and never pass through the merge algorithm."""
    if not specials:
        yield text, None
        return
    # first-char index, longest-first per bucket: O(text) scan instead of
    # O(text * n_specials) startswith probes (llama-3 ggufs carry ~256
    # specials; the naive scan made whole-corpus encodes minutes of pure
    # pre-tokenization).  Longest-first resolves overlapping markers like
    # llama.cpp's token-trie ("<|end|>" before "<|e").
    by_first: Dict[str, list] = {}
    for k in sorted(specials, key=len, reverse=True):
        by_first.setdefault(k[0], []).append(k)
    i, n = 0, len(text)
    plain_start = 0
    while i < n:
        hit = None
        for k in by_first.get(text[i], ()):
            if text.startswith(k, i):
                hit = k
                break
        if hit is None:
            i += 1
            continue
        if i > plain_start:
            yield text[plain_start:i], None
        yield hit, specials[hit]
        i += len(hit)
        plain_start = i
    if plain_start < n:
        yield text[plain_start:], None


class _Base:
    """Shared vocab plumbing; subclasses implement _encode_piece."""

    def __init__(self, tokens: Sequence[str], token_types: Sequence[int],
                 bos_token_id: Optional[int], eos_token_id: Optional[int],
                 unk_token_id: Optional[int], add_bos: bool,
                 chat_template: str = ""):
        self.tokens = list(tokens)
        self.token_types = list(token_types)
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        self.bos_token_id = bos_token_id
        self.eos_token_id = eos_token_id
        self.unk_token_id = unk_token_id
        self.add_bos = add_bos
        self.chat_template = chat_template
        self.specials = {
            t: i for i, t in enumerate(self.tokens)
            if self.token_types[i] in (TT_CONTROL, TT_USER_DEFINED)
        }

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encode ------------------------------------------------------------
    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        ids: List[int] = []
        if (self.add_bos if add_bos is None else add_bos) \
                and self.bos_token_id is not None:
            ids.append(self.bos_token_id)
        first = True
        for piece, sid in _split_on_specials(text, self.specials):
            if sid is not None:
                ids.append(sid)
                first = True  # llama.cpp re-applies the space prefix
                continue
            ids.extend(self._encode_piece(piece, first=first))
            first = False
        return ids

    # -- decode ------------------------------------------------------------
    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        # accumulate RAW BYTES and decode once at the end: a multi-byte
        # UTF-8 character split across tokens (byte fallback, or BPE
        # byte-unicode pieces) must reassemble before decoding
        out = bytearray()
        for i in ids:
            i = int(i)
            if not (0 <= i < len(self.tokens)):
                continue
            tt = self.token_types[i]
            if tt == TT_BYTE:
                out += bytes([self._byte_of(i)])
            elif tt == TT_CONTROL and skip_special_tokens:
                continue
            else:
                out += self._piece_bytes(i)
        text = out.decode("utf-8", errors="replace")
        return self._post_decode(text)

    def _byte_of(self, i: int) -> int:
        t = self.tokens[i]
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            return int(t[3:5], 16)
        return ord(t[0]) & 0xFF

    def _piece_bytes(self, i: int) -> bytes:
        return self.tokens[i].encode("utf-8")

    def _post_decode(self, text: str) -> str:
        return text

    # -- chat template -----------------------------------------------------
    def _apply_chat_template(self, messages, tokenize: bool = True,
                             add_generation_prompt: bool = True):
        """Render the gguf-embedded jinja chat template.  Exposed as
        `apply_chat_template` via __getattr__ ONLY when a template was
        embedded, so the server/cli hasattr fallback keeps working."""
        import jinja2  # ships with transformers

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = lambda m: (_ for _ in ()).throw(
            ValueError(m))
        text = env.from_string(self.chat_template).render(
            messages=messages,
            add_generation_prompt=add_generation_prompt,
            bos_token=self.tokens[self.bos_token_id]
            if self.bos_token_id is not None else "",
            eos_token=self.tokens[self.eos_token_id]
            if self.eos_token_id is not None else "")
        return self.encode(text) if tokenize else text

    def __getattr__(self, name):
        # only consulted for names not found normally: surface
        # apply_chat_template only when a template was embedded
        if name == "apply_chat_template" and self.__dict__.get(
                "chat_template"):
            return self._apply_chat_template
        raise AttributeError(name)

    # -- persistence ---------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        return {
            "tokens": self.tokens, "token_types": self.token_types,
            "bos_token_id": self.bos_token_id,
            "eos_token_id": self.eos_token_id,
            "unk_token_id": self.unk_token_id, "add_bos": self.add_bos,
            "chat_template": self.chat_template,
        }

    def save(self, ckpt_dir: str):
        state = self._state()
        state["model"] = self.MODEL
        with open(os.path.join(ckpt_dir, TOKENIZER_FILE), "w") as f:
            json.dump(state, f)


class SPMTokenizer(_Base):
    """SentencePiece-style vocab used greedily: merge the adjacent symbol
    pair whose concatenation has the highest vocab score (llama.cpp
    llm_tokenizer_spm).  Whitespace becomes '▁'; unknown bytes fall back
    to <0xXX> byte tokens."""

    MODEL = "llama"

    def __init__(self, tokens, token_types, scores, bos_token_id=1,
                 eos_token_id=2, unk_token_id=0, add_bos=True,
                 add_space_prefix=True, chat_template=""):
        super().__init__(tokens, token_types, bos_token_id, eos_token_id,
                         unk_token_id, add_bos, chat_template)
        self.scores = list(scores)
        self.add_space_prefix = add_space_prefix

    def _encode_piece(self, text: str, first: bool) -> List[int]:
        if not text:
            return []
        if self.add_space_prefix and first:
            text = " " + text
        text = text.replace(" ", _SP_SPACE)
        # Merge WORD-LOCAL chunks (a run of '▁'s plus the following word
        # chars): SPM vocab pieces never contain an internal '▁' after
        # word chars, so no valid merge can cross a word-char -> '▁'
        # boundary -- chunking changes nothing semantically but turns the
        # O(piece^2) greedy scan into O(sum word^2), which is what makes
        # `ppl --text` on a whole corpus tractable.
        ids: List[int] = []
        n = len(text)
        i = 0
        while i < n:
            j = i
            while j < n and text[j] == _SP_SPACE:
                j += 1
            while j < n and text[j] != _SP_SPACE:
                j += 1
            ids.extend(self._merge_chunk(text[i:j]))
            i = j
        return ids

    def _merge_chunk(self, chunk: str) -> List[int]:
        syms = list(chunk)  # initial symbols = unicode chars
        if not syms:
            return []
        # greedy highest-score bigram merge (llama.cpp llm_tokenizer_spm)
        while len(syms) > 1:
            best, best_i = None, -1
            for i in range(len(syms) - 1):
                cat = syms[i] + syms[i + 1]
                j = self.vocab.get(cat)
                if j is not None and (best is None or self.scores[j] > best):
                    best, best_i = self.scores[j], i
            if best_i < 0:
                break
            syms[best_i:best_i + 2] = [syms[best_i] + syms[best_i + 1]]
        ids: List[int] = []
        for s in syms:
            j = self.vocab.get(s)
            if j is not None:
                ids.append(j)
                continue
            for b in s.encode("utf-8"):  # byte fallback
                jb = self.vocab.get(f"<0x{b:02X}>")
                ids.append(jb if jb is not None else self.unk_token_id)
        return [i for i in ids if i is not None]

    def _piece_bytes(self, i: int) -> bytes:
        return self.tokens[i].replace(_SP_SPACE, " ").encode("utf-8")

    def _post_decode(self, text: str) -> str:
        # llama.cpp drops the synthetic leading space it added at encode
        if self.add_space_prefix and text.startswith(" "):
            return text[1:]
        return text

    def _state(self):
        s = super()._state()
        s["scores"] = self.scores
        s["add_space_prefix"] = self.add_space_prefix
        return s


# -- GPT-2 byte-level BPE ----------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->printable-unicode table (the standard
    construction: printable ranges map to themselves, the rest shift into
    U+0100+)."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}


# llama.cpp selects the byte-level-BPE pre-tokenizer by the
# `tokenizer.ggml.pre` metadata string; these are the upstream regexes
# (llama.cpp llm_tokenizer_bpe regex_exprs) for the families this repo's
# model zoo covers.  Unknown pre strings fall back to gpt-2 (llama.cpp
# warns and does the same for its default).
_PRE_PATTERNS = {
    "gpt-2": r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
             r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+",
    "llama-bpe": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
                 r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                 r"\s+(?!\S)|\s+",
    "qwen2": r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|"
             r"[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
             r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
             r"\s+(?!\S)|\s+",
}
_PRE_CACHE: Dict[str, Any] = {}


def _pre_regex(pre: str):
    """Compiled pre-tokenizer for a tokenizer.ggml.pre string (None when
    the `regex` module is unavailable -> scanner fallback)."""
    if pre not in _PRE_CACHE:
        try:
            import regex  # full \p{..} class support (transformers dep)
            pat = _PRE_PATTERNS.get(pre, _PRE_PATTERNS["gpt-2"])
            _PRE_CACHE[pre] = regex.compile(pat)
        except ImportError:  # pragma: no cover -- regex ships with
            _PRE_CACHE[pre] = None  # transformers in this environment
    return _PRE_CACHE[pre]


def _gpt2_pretokenize(text: str) -> List[str]:
    """Fallback GPT-2-style splitter without the `regex` module: runs of
    letters / digits / punctuation, each optionally absorbing ONE leading
    space, plus contraction suffixes.  Approximate (see _PRE_PATTERNS for
    the exact upstream regexes used when `regex` is importable)."""
    CONTR = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

    def cls(c: str) -> str:
        cat = unicodedata.category(c)
        if cat.startswith("L"):
            return "L"
        if cat.startswith("N"):
            return "N"
        if c.isspace():
            return "S"
        return "P"

    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "'":
            low = text[i:i + 3].lower()
            hit = next((s for s in CONTR if low.startswith(s)), None)
            if hit is not None:
                out.append(text[i:i + len(hit)])
                i += len(hit)
                continue
        k = cls(c)
        if k == "S":
            j = i
            while j < n and text[j].isspace():
                j += 1
            # last space binds to a following letter/digit/punct word
            if j < n and j - i >= 1 and text[j - 1] == " ":
                if j - 1 > i:
                    out.append(text[i:j - 1])
                i = j - 1
                c = text[i]
                j = i + 1
                k2 = cls(text[j]) if j < n else "S"
                while j < n and cls(text[j]) == k2 and text[j] != "'":
                    j += 1
                out.append(text[i:j])
                i = j
            else:
                out.append(text[i:j])
                i = j
        else:
            j = i + 1
            while j < n and cls(text[j]) == k and text[j] != "'":
                j += 1
            out.append(text[i:j])
            i = j
    return out


class BPETokenizer(_Base):
    """Byte-level BPE by merge rank (llama.cpp llm_tokenizer_bpe; the
    gpt2 family covers llama-3 / qwen2 / phi-3.5 ggufs)."""

    MODEL = "gpt2"

    def __init__(self, tokens, token_types, merges, bos_token_id=None,
                 eos_token_id=None, unk_token_id=None, add_bos=False,
                 chat_template="", pre: str = "gpt-2"):
        super().__init__(tokens, token_types, bos_token_id, eos_token_id,
                         unk_token_id, add_bos, chat_template)
        self.pre = pre  # tokenizer.ggml.pre pretokenizer family
        self.merges = list(merges)
        self.ranks = {}
        for r, m in enumerate(self.merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r

    def _bpe_word(self, word: str) -> List[str]:
        parts = list(word)
        while len(parts) > 1:
            best_r, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_r is None or r < best_r):
                    best_r, best_i = r, i
            if best_i < 0:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def _pretokenize(self, text: str) -> List[str]:
        rx = _pre_regex(self.pre)
        if rx is not None:
            return rx.findall(text)
        return _gpt2_pretokenize(text)

    def _encode_piece(self, text: str, first: bool) -> List[int]:
        ids: List[int] = []
        for word in self._pretokenize(text):
            enc = "".join(_BYTE_ENC[b] for b in word.encode("utf-8"))
            for part in self._bpe_word(enc):
                j = self.vocab.get(part)
                if j is not None:
                    ids.append(j)
                elif self.unk_token_id is not None:
                    ids.append(self.unk_token_id)
        return ids

    def _piece_bytes(self, i: int) -> bytes:
        # tokens live in byte-unicode space; map back through the table to
        # RAW bytes (multi-byte characters may span tokens -- the shared
        # decode() buffer reassembles them before UTF-8 decoding)
        return bytes(_BYTE_DEC.get(ch, ord(ch) & 0xFF)
                     for ch in self.tokens[i])

    def _state(self):
        s = super()._state()
        s["merges"] = self.merges
        s["pre"] = self.pre
        return s


# -- gguf + disk entry points -------------------------------------------------

def tokenizer_from_gguf(metadata: Dict[str, Any]):
    """Build a tokenizer from gguf `tokenizer.ggml.*` metadata; None when
    the artifact carries no token table (pure-weights interchange files)."""
    g = metadata.get
    tokens = g("tokenizer.ggml.tokens")
    if not tokens:
        return None
    model = g("tokenizer.ggml.model", "llama")
    n = len(tokens)
    types = g("tokenizer.ggml.token_type") or [TT_NORMAL] * n
    bos = g("tokenizer.ggml.bos_token_id")
    eos = g("tokenizer.ggml.eos_token_id")
    unk = g("tokenizer.ggml.unknown_token_id")
    tmpl = g("tokenizer.chat_template", "")
    if model in ("llama", "spm"):
        scores = g("tokenizer.ggml.scores") or [0.0] * n
        return SPMTokenizer(
            tokens, types, scores,
            bos_token_id=1 if bos is None else bos,
            eos_token_id=2 if eos is None else eos,
            unk_token_id=0 if unk is None else unk,
            add_bos=bool(g("tokenizer.ggml.add_bos_token", True)),
            add_space_prefix=bool(g("tokenizer.ggml.add_space_prefix", True)),
            chat_template=tmpl)
    if model in ("gpt2", "bpe"):
        return BPETokenizer(
            tokens, types, g("tokenizer.ggml.merges") or [],
            bos_token_id=bos, eos_token_id=eos, unk_token_id=unk,
            add_bos=bool(g("tokenizer.ggml.add_bos_token", False)),
            chat_template=tmpl, pre=g("tokenizer.ggml.pre", "gpt-2"))
    raise NotImplementedError(f"tokenizer.ggml.model={model!r}")


def load_tokenizer(ckpt_dir: str):
    """Tokenizer saved beside a converted checkpoint, else None."""
    path = os.path.join(ckpt_dir, TOKENIZER_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        s = json.load(f)
    if s["model"] == "llama":
        return SPMTokenizer(
            s["tokens"], s["token_types"], s["scores"],
            bos_token_id=s["bos_token_id"], eos_token_id=s["eos_token_id"],
            unk_token_id=s["unk_token_id"], add_bos=s["add_bos"],
            add_space_prefix=s["add_space_prefix"],
            chat_template=s.get("chat_template", ""))
    return BPETokenizer(
        s["tokens"], s["token_types"], s["merges"],
        bos_token_id=s["bos_token_id"], eos_token_id=s["eos_token_id"],
        unk_token_id=s["unk_token_id"], add_bos=s["add_bos"],
        chat_template=s.get("chat_template", ""),
        pre=s.get("pre", "gpt-2"))
