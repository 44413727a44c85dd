"""The port's CLIP tokenizer (stdlib ``re``) against the JAX package's
(``regex``), token for token, on one merges file the test writes in the
real file's format: every question of music_avqa_val.json raw and with its
template filled, non-ASCII and edge strings, the split itself over every
code point Unicode 15.0 assigns, truncation, decoding, the specials, and
where the merges file is looked for. Every comparison is exact."""
import unicodedata
from pathlib import Path

import numpy as np
import pytest

from qa_tiger_tpu.data import tokenizer as jtok
from qa_tiger_tpu.data.annotations import substitute_template as j_substitute
from qa_tiger_tpu_torch.data import tokenizer as ttok
from torch_corpus import val_questions, write_merges

EDGE = [
    "\u00bd", "\u216b", "\u0663", "\u00b2 \u00b3 \u00bc 10\u00bd \u216bth",
    "caf\u00e9 d\u00e9j\u00e0 vu", "\u00c5NGSTR\u00d6M na\u00efve \u00c6r\u00f8",
    "\u97f3\u4e50 \u4e50\u5668 \u7684", "\U0001f3bb\U0001f3b8 violin \U0001f3b9!",
    "a\u0301b e\u0308", "\u1f40\u03b4\u03c5\u03c3\u03c3\u03b5\u03cd\u03c2",
    "x\u0345y \u0345", "\u001cseparated\u001d\u001e\u001f words",
    "no\u00a0break\u00a0space", "?'s", "what's", "WHAT'S IT'LL", "what'\u017f",
    "&amp;amp;", "&lt;b&gt; &#39;quoted&#39;", "<|startoftext|> inside text",
    "text <|endoftext|>", "<|\u017ftartoftext|>", "  lots \t of\n\r space  ", "",
    "12345", "k\u212a", "\u0130stanbul", "\u01c5emal", "\ufb01ne \ufb02ute",
    "\u200bzero\u200bwidth", "tab\tand\u3000ideographic", "mixed123abc",
    "don't can't we've i'm you'd they're", "!!!???...", "\u0660\u0661 \u09e6 \u0f20",
]


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    texts = [q["question_content"] for q in val_questions()] + EDGE
    return write_merges(tmp_path_factory.mktemp("bpe") / "vocab.txt.gz", texts, 300)


@pytest.fixture(scope="module")
def pair(vocab):
    return ttok.ClipTokenizer(vocab), jtok.ClipTokenizer(vocab)


def _assigned() -> list[int]:
    return [cp for cp in range(0x110000)
            if not 0xD800 <= cp <= 0xDFFF and unicodedata.category(chr(cp)) != "Cn"]


def test_every_val_question_raw_and_substituted(pair):
    port, jax_ = pair
    qs = val_questions()
    assert len(qs) == 4568 and len({q["question_content"] for q in qs}) == 33
    raw = [q["question_content"] for q in qs]
    filled = [j_substitute(q["question_content"], q["templ_values"]) for q in qs]
    for texts in (raw, filled):
        assert np.array_equal(port(texts, truncate=True), jax_(texts, truncate=True))


@pytest.mark.parametrize("text", EDGE, ids=[ascii(s)[1:-1][:24] for s in EDGE])
def test_edge_string(pair, text):
    port, jax_ = pair
    assert port.encode(text) == jax_.encode(text)
    assert np.array_equal(port(text), jax_(text))


def test_split_over_every_assigned_code_point(pair):
    """Runs of 37 consecutive assigned code points, as they are and
    lowercased: the split and the cleaning agree everywhere."""
    port, jax_ = pair
    cps = _assigned()
    for i in range(0, len(cps), 37):
        s = "".join(map(chr, cps[i:i + 37]))
        for text in (s, s.lower()):
            assert port._pattern.findall(text) == jax_._pattern.findall(text), ascii(text)
            assert ttok._clean(text) == jtok._clean(text), ascii(text)


@pytest.mark.parametrize("lo,hi", [(0x0, 0x400), (0x2000, 0x2200), (0x3000, 0x3040)])
def test_split_around_apostrophes_and_letters(pair, lo, hi):
    """Each code point of the range after an apostrophe, between letters
    and before a contraction: the ordered alternation's first match wins
    in both."""
    port, jax_ = pair
    for cp in range(lo, hi):
        c = chr(cp)
        for text in ("'" + c, "a" + c + "b", "1" + c + "'", c + "'s", "'" + c + "e"):
            assert port._pattern.findall(text) == jax_._pattern.findall(text), ascii(text)


def test_truncate_specials_and_decode(pair):
    port, jax_ = pair
    long_text = "how many instruments " * 40
    got = port(long_text, truncate=True)
    assert got.shape == (1, 77) and got.dtype == np.int64
    assert got[0, 0] == port.sot_id and got[0, -1] == port.eot_id
    assert np.array_equal(got, jax_(long_text, truncate=True))
    with pytest.raises(RuntimeError, match="too long"):
        port(long_text)
    assert (port.sot_id, port.eot_id) == (jax_.sot_id, jax_.eot_id)
    assert port.eot_id == len(port.encoder) - 1  # argmax pooling finds EOT
    ids = port.encode("How many flutes are playing?")
    assert port.decode(ids) == jax_.decode(ids) == "how many flutes are playing ? "
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()


def test_find_vocab_file_order(vocab, tmp_path, monkeypatch):
    """The argument, then QA_TIGER_BPE_VOCAB, then the package's assets
    directory; nothing found raises in both packages."""
    monkeypatch.delenv("QA_TIGER_BPE_VOCAB", raising=False)
    monkeypatch.setattr(ttok, "ASSETS_DIR", tmp_path / "assets")
    monkeypatch.setattr(jtok, "_VOCAB_SEARCH_PATHS", (tmp_path / "assets" / ttok.VOCAB_NAME,))
    for mod in (ttok, jtok):
        with pytest.raises(FileNotFoundError):
            mod.find_vocab_file()
    (tmp_path / "assets").mkdir()
    assets = tmp_path / "assets" / ttok.VOCAB_NAME
    assets.write_bytes(Path(vocab).read_bytes())
    assert ttok.find_vocab_file() == jtok.find_vocab_file() == assets
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(vocab))
    assert ttok.find_vocab_file() == jtok.find_vocab_file() == Path(vocab)
    assert ttok.find_vocab_file("x.gz") == jtok.find_vocab_file("x.gz") == Path("x.gz")
    # the module-level tokenize() reads the environment's file, as JAX's does
    ttok._default_tokenizer.cache_clear()
    jtok._default_tokenizer.cache_clear()
    try:
        assert np.array_equal(ttok.tokenize(["what's that?"]), jtok.tokenize(["what's that?"]))
    finally:
        ttok._default_tokenizer.cache_clear()
        jtok._default_tokenizer.cache_clear()
