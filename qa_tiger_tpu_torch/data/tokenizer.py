"""CLIP byte-level BPE tokenizer on the standard library alone.

This package's own copy of ``qa_tiger_tpu/data/tokenizer.py`` (the vendored
OpenAI tokenizer of the reference, src/models/base/clip_tokenize.py and
``tokenize()`` at src/models/clip.py:210-249): a byte -> unicode vocabulary,
the merge rules, a case-insensitive word / number / punctuation split,
``</w>`` end-of-word markers, SOT/EOT specials, and a fixed [N, 77] int64
output whose truncated rows keep EOT last.

The JAX copy splits with the ``regex`` package (``\\p{L}``, ``\\p{N}``,
``re.IGNORECASE``); this one uses the stdlib ``re``, so it needs no package
the card's machine may lack. What ``regex`` does is rebuilt from
``unicodedata``:

- letters are the code points whose category starts with "L", numbers "N".
  ``re``'s ``[^\\W\\d_]`` is not ``\\p{L}`` (they differ on 1,151 code
  points), so the classes are built explicitly. They agree with ``regex``'s
  ``\\p{L}`` / ``\\p{N}`` on every code point Unicode 15.0 assigns (the
  ``unicodedata`` of Python 3.12); where a newer ``regex`` knows a later
  Unicode, the code points on which the two differ are all unassigned
  (``Cn``) here;
- whitespace is Unicode White_Space, as in ``regex``: ``str.isspace()``
  minus U+001C-U+001F, which ``re``'s ``\\s`` would include. It applies to
  the cleaning's whitespace collapse and to the split's last class;
- under ``IGNORECASE`` ``regex`` keeps out of ``[^\\s\\p{L}\\p{N}]`` a
  character whose case mappings are letters or numbers although it is
  neither (of assigned code points, only U+0345 COMBINING GREEK
  YPOGEGRAMMENI): no alternative matches it, so the split drops it;
- the split is an ordered alternation, the first alternative that matches
  at a position wins: the two specials, ``'s|'t|'re|'ve|'m|'ll|'d``
  (case-insensitive: ``'ſ`` is a contraction too), a run of letters, one
  number, a run of other non-space characters. So ``?'s`` splits as
  ``?'`` then ``s``.

Text cleaning is the reference's ``basic_clean`` + ``whitespace_clean``:
``ftfy.fix_text`` when ``ftfy`` is installed, a double ``html.unescape``,
whitespace collapsed, stripped, lowercased.

The BPE merge table ships with OpenAI CLIP (``bpe_simple_vocab_16e6.txt.gz``)
and is not in this repository. The file is found through, in order: the
argument, the ``QA_TIGER_BPE_VOCAB`` environment variable, this package's
``data/assets/`` directory.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from collections.abc import Sequence
from pathlib import Path

import numpy as np

CONTEXT_LENGTH = 77
SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
VOCAB_NAME = "bpe_simple_vocab_16e6.txt.gz"
ASSETS_DIR = Path(__file__).resolve().parent / "assets"
# str.isspace() holds for these four separators; Unicode White_Space does not
_NOT_WHITE_SPACE = frozenset(range(0x1C, 0x20))


def find_vocab_file(path: str | Path | None = None) -> Path:
    if path is not None:
        return Path(path)
    env = os.environ.get("QA_TIGER_BPE_VOCAB")
    if env:
        return Path(env)
    cand = ASSETS_DIR / VOCAB_NAME
    if cand.exists():
        return cand
    raise FileNotFoundError(
        "CLIP BPE vocab not found; set QA_TIGER_BPE_VOCAB or pass a path")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2 style reversible byte -> printable unicode character mapping."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _class(points: list[int]) -> str:
    """A ``re`` character-class body for the sorted code points."""
    parts, i = [], 0
    while i < len(points):
        j = i
        while j + 1 < len(points) and points[j + 1] == points[j] + 1:
            j += 1
        lo, hi = (f"\\U{points[k]:08x}" for k in (i, j))
        parts.append(lo if i == j else f"{lo}-{hi}")
        i = j + 1
    return "".join(parts)


def _case_linked(c: str) -> bool:
    """True where one of a character's case mappings is a letter or a
    number: ``regex`` under IGNORECASE keeps such a character out of
    ``[^\\s\\p{L}\\p{N}]`` even when it is neither itself."""
    return any(unicodedata.category(x)[0] in "LN" for x in c.lower() + c.upper() + c.casefold())


@functools.lru_cache()
def _classes() -> tuple[str, str, str, str]:
    """(letters, numbers, White_Space, the case-linked rest) as ``re`` class
    bodies; built at first use, as a pass over every code point takes a
    fraction of a second."""
    letters, numbers, space, linked = [], [], [], []
    for cp in range(0x110000):
        c = chr(cp)
        cat = unicodedata.category(c)
        if cat[0] == "L":
            letters.append(cp)
        elif cat[0] == "N":
            numbers.append(cp)
        elif c.isspace() and cp not in _NOT_WHITE_SPACE:
            space.append(cp)
        elif cat != "Cn" and _case_linked(c):
            linked.append(cp)
    return _class(letters), _class(numbers), _class(space), _class(linked)


@functools.lru_cache()
def split_pattern() -> re.Pattern:
    """The JAX tokenizer's split pattern under the stdlib ``re``."""
    letters, numbers, space, linked = _classes()
    return re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
        f"|[{letters}]+|[{numbers}]|[^{space}{letters}{numbers}{linked}]+")


@functools.lru_cache()
def _space_run() -> re.Pattern:
    return re.compile(f"[{_classes()[2]}]+")


def _get_pairs(word: tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str) -> str:
    try:  # ftfy when available (the reference's basic_clean exactly)
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    text = _space_run().sub(" ", text)
    return text.strip()


class ClipTokenizer:
    def __init__(self, vocab_path: str | Path | None = None):
        vocab_file = find_vocab_file(vocab_path)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(vocab_file, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a header; CLIP uses merges [1 : 49152-256-2+1)
        merge_lines = lines[1: 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in merge_lines]

        base = list(bytes_to_unicode().values())
        vocab: list[str] = base + [c + "</w>" for c in base]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TOKEN, EOT_TOKEN])

        self.encoder: dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: dict[tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self._pattern = split_pattern()

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TOKEN]

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        merged = " ".join(word)
        self._cache[token] = merged
        return merged

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = _clean(text).lower()
        for token in self._pattern.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
                 truncate: bool = False) -> np.ndarray:
        """Tokenize to a fixed [N, context_length] int64 array (the
        semantics of the reference's tokenize(), src/models/clip.py:210-249)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int64)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if truncate:
                    ids = ids[:context_length]
                    ids[-1] = self.eot_id
                else:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length {context_length}")
            out[i, : len(ids)] = ids
        return out


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Module-level convenience mirroring ``clip.tokenize``."""
    return _default_tokenizer()(texts, context_length, truncate)
