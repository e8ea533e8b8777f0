"""The port's copy of the tokenizers (tmac_tpu_torch/runtime/tokenizer.py):
the synthetic cases of tests/test_tokenizer.py that need no CLI and no HF
package, run against the port, and the two packages' tokenizers against
each other (the same ids and text, and each loading what the other saves).
The gguf cases read their metadata with the JAX package's gguf reader."""

import time

import numpy as np
import pytest

from tmac_tpu.convert import gguf
from tmac_tpu.runtime import tokenizer as jtok
from tmac_tpu_torch.runtime.tokenizer import (
    BPETokenizer, SPMTokenizer, TOKENIZER_FILE, TT_BYTE, TT_CONTROL,
    TT_NORMAL, TT_UNKNOWN, _BYTE_ENC, _gpt2_pretokenize, _pre_regex,
    load_tokenizer, tokenizer_from_gguf)

SPM_TOKENS = ["<unk>", "<s>", "</s>", "▁", "▁hello", "▁world",
              "h", "e", "l", "o", "w", "r", "d",
              "he", "ll", "llo", "▁he", "hello",
              "<0xE2>", "<0x82>", "<0xAC>"]
SPM_SCORES = [0, 0, 0, -1, -5, -6,
              -10, -10, -10, -10, -10, -10, -10,
              -8, -8, -7, -7.5, -6.5,
              -20, -20, -20]
SPM_TYPES = [TT_UNKNOWN, TT_CONTROL, TT_CONTROL] + [TT_NORMAL] * 15 \
    + [TT_BYTE] * 3
BPE_TOKENS = ["h", "e", "l", "o", "w", "r", "d",
              "he", "hel", "hell", "hello",
              "Ġ", "Ġw", "Ġwo", "Ġwor", "Ġworl", "Ġworld", "<|end|>"]
BPE_TYPES = [TT_NORMAL] * 17 + [TT_CONTROL]
BPE_MERGES = ["h e", "he l", "hel l", "hell o",
              "Ġ w", "Ġw o", "Ġwo r", "Ġwor l", "Ġworl d"]


def _spm(module=None):
    return (module.SPMTokenizer if module else SPMTokenizer)(
        SPM_TOKENS, SPM_TYPES, SPM_SCORES)


def _bpe(module=None):
    return (module.BPETokenizer if module else BPETokenizer)(
        BPE_TOKENS, BPE_TYPES, BPE_MERGES, eos_token_id=17)


@pytest.mark.parametrize("make, text, add_bos, ids", [
    # ▁,h,e,l,l,o -> he(-8) -> ▁he(-7.5) -> +ll -> llo... -> ▁hello(-5)
    (_spm, "hello", None, [1, 4]),
    # ▁ then the three UTF-8 bytes of the euro sign as <0xXX> tokens
    (_spm, "€", False, [3, 18, 19, 20]),
    # a special token's text is split out as that token
    (_spm, "<s>hello", False, [1, 4]),
    (_bpe, "hello world", None, [10, 16]),
    (_bpe, "hello<|end|>", None, [10, 17]),
], ids=["spm_merge_and_bos", "spm_byte_fallback", "spm_special_split",
        "bpe_merges", "bpe_special"])
def test_encode(make, text, add_bos, ids):
    assert make().encode(text, add_bos=add_bos) == ids


@pytest.mark.parametrize("make, text, add_bos, want", [
    (_spm, "hello world", None, "hello world"),
    (_spm, "€", False, "€"),
    (_spm, "<s>hello", False, "hello"),            # control tokens hidden
    (_spm, "hello € hello", False, "hello € hello"),  # byte fallback inside
    (_bpe, "hello world", None, "hello world"),
    (_bpe, "hello<|end|>", None, "hello"),
], ids=["spm_round_trip", "spm_byte_fallback", "spm_control_hidden",
        "spm_byte_fallback_split", "bpe_round_trip", "bpe_control_hidden"])
def test_decode(make, text, add_bos, want):
    tok = make()
    assert tok.decode(tok.encode(text, add_bos=add_bos)) == want


def test_spm_bos_and_specials_shown_on_request():
    tok = _spm()
    assert tok.encode("hello world")[0] == 1
    assert "<s>" in tok.decode([1, 4], skip_special_tokens=False)


def test_spm_unknown_char_without_byte_tokens():
    toks = ["<unk>", "<s>", "</s>", "▁", "a"]
    tok = SPMTokenizer(toks, [TT_UNKNOWN, TT_CONTROL, TT_CONTROL,
                              TT_NORMAL, TT_NORMAL], [0, 0, 0, -1, -2])
    ids = tok.encode("aé", add_bos=False)
    assert ids[0] == 3 or ids[0] == 0  # ▁ prefix
    assert 0 in ids  # é has no byte tokens -> unk


def test_bpe_eos():
    assert _bpe().eos_token_id == 17


@pytest.mark.parametrize("text, pieces", [
    ("hello world", ["hello", " world"]),
    ("a1 b,c", ["a", "1", " b", ",", "c"]),
    ("it's ok", ["it", "'s", " ok"]),
])
def test_gpt2_pretokenize_splits(text, pieces):
    assert _gpt2_pretokenize(text) == pieces


@pytest.mark.parametrize("pre, text, pieces", [
    ("llama-bpe", "a 12345", ["a", " ", "123", "45"]),
    ("qwen2", "12", ["1", "2"]),
    ("gpt-2", " 12345", [" 12345"]),
])
def test_pre_tokenizer_families(pre, text, pieces):
    assert _pre_regex(pre).findall(text) == pieces


def test_chat_template_visibility():
    pytest.importorskip("jinja2")
    tok = _spm()
    assert not hasattr(tok, "apply_chat_template")
    tok2 = _spm()
    tok2.chat_template = ("{% for m in messages %}{{ m['content'] }}"
                          "{% endfor %}")
    assert hasattr(tok2, "apply_chat_template")
    ids = tok2.apply_chat_template([{"role": "user", "content": "hello"}])
    assert ids == [1, 4]
    text = tok2.apply_chat_template([{"role": "user", "content": "x"}],
                                    tokenize=False)
    assert text == "x"


def _gguf_metadata(tmp_path, meta):
    path = str(tmp_path / "tok.gguf")
    gguf.write_gguf(path, meta, {
        "dummy.weight": (gguf.GGML_F32, np.zeros((2, 4), np.float32))})
    r = gguf.GGUFReader(path)
    try:
        return r.metadata
    finally:
        r.close()


def test_gguf_spm_metadata(tmp_path):
    src = _spm()
    tok = tokenizer_from_gguf(_gguf_metadata(tmp_path, {
        "general.architecture": "llama",
        "tokenizer.ggml.model": "llama",
        "tokenizer.ggml.tokens": src.tokens,
        "tokenizer.ggml.scores": [float(s) for s in src.scores],
        "tokenizer.ggml.token_type": src.token_types,
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
        "tokenizer.ggml.unknown_token_id": 0,
        "tokenizer.ggml.add_bos_token": True,
        "tokenizer.chat_template": "{{ messages }}",
    }))
    assert isinstance(tok, SPMTokenizer)
    for text in ("hello", "hello world", "€ hello"):
        assert tok.encode(text) == src.encode(text)
        assert tok.decode(tok.encode(text)) == text
    assert tok.chat_template == "{{ messages }}"


def test_gguf_bpe_metadata(tmp_path):
    src = _bpe()
    tok = tokenizer_from_gguf(_gguf_metadata(tmp_path, {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": src.tokens,
        "tokenizer.ggml.token_type": src.token_types,
        "tokenizer.ggml.merges": src.merges,
        "tokenizer.ggml.eos_token_id": 17,
        "tokenizer.ggml.add_bos_token": False,
        "tokenizer.ggml.pre": "qwen2",
    }))
    assert isinstance(tok, BPETokenizer)
    assert tok.encode("hello world") == src.encode("hello world")
    assert tok.eos_token_id == 17 and tok.pre == "qwen2"


def test_no_tokenizer_metadata_gives_none():
    assert tokenizer_from_gguf({"general.architecture": "llama"}) is None


def test_load_tokenizer_absent(tmp_path):
    assert load_tokenizer(str(tmp_path)) is None


@pytest.mark.parametrize("make", [_spm, _bpe])
def test_save_load_round_trip(tmp_path, make):
    src = make()
    if make is _bpe:
        src.pre = "llama-bpe"   # the pretokenizer family survives the save
    src.save(str(tmp_path))
    assert (tmp_path / TOKENIZER_FILE).exists()
    tok = load_tokenizer(str(tmp_path))
    assert type(tok) is type(src)
    assert getattr(tok, "pre", None) == getattr(src, "pre", None)
    for text in ("hello", "hello world"):
        assert tok.encode(text) == src.encode(text)
        assert tok.decode(tok.encode(text)) == src.decode(src.encode(text))
    assert tok.eos_token_id == src.eos_token_id


TEXTS = ("hello", "hello world", "€ hello", "<s>hello</s> world",
         "hello<|end|> world", "héllo wörld 12345", "")


@pytest.mark.parametrize("make", [_spm, _bpe])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_what_the_other_saves(tmp_path, make, writer):
    """A tokenizer saved by one package loads in the other, and both give
    the same ids and text as the JAX package's own tokenizer."""
    ref = make(jtok)
    (ref if writer == "jax" else make()).save(str(tmp_path))
    loaded = (load_tokenizer if writer == "jax"
              else jtok.load_tokenizer)(str(tmp_path))
    for text in TEXTS:
        ids = ref.encode(text)
        assert loaded.encode(text) == ids == make().encode(text), text
        assert loaded.decode(ids) == ref.decode(ids) == make().decode(ids)


def test_bpe_decode_multibyte_split_across_tokens():
    """A multi-byte UTF-8 char split across BPE tokens reassembles."""
    t1, t2 = _BYTE_ENC[0xC3], _BYTE_ENC[0xA9]   # 'é' = 0xC3 0xA9
    tok = BPETokenizer([t1, t2], [TT_NORMAL, TT_NORMAL], [])
    assert tok.decode([0, 1]) == "é"


def test_spm_long_corpus_encode_is_fast():
    """The word-chunked merge keeps whole-corpus encoding near linear."""
    tok = _spm()
    text = "hello world " * 5000  # ~60k chars
    t0 = time.time()
    tok.encode(text)
    assert time.time() - t0 < 10.0
    small = "hello world hello"
    assert tok.decode(tok.encode(small)) == small


def test_specials_index_scales():
    """Special-token splitting is indexed by first char: a 256-special
    vocab over a large text stays fast."""
    toks = ["<unk>"] + [f"<|reserved_{i}|>" for i in range(256)] + ["a", "b"]
    types = [TT_UNKNOWN] + [TT_CONTROL] * 256 + [TT_NORMAL, TT_NORMAL]
    tok = SPMTokenizer(toks, types, [0.0] * len(toks), bos_token_id=None,
                       add_bos=False)
    text = "ab" * 30000 + "<|reserved_7|>"
    t0 = time.time()
    ids = tok.encode(text)
    assert time.time() - t0 < 5.0
    assert ids[-1] == 8  # the special resolved
