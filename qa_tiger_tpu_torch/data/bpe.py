"""A BPE merges file learned from a handful of texts.

The CLIP merges file (``bpe_simple_vocab_16e6.txt.gz``) is not in the
repository. What runs without it (the benchmarks, the on-card check, the
tests) learns its own from the questions it asks: the same format (a header
line, then one merge per line, gzipped), a few hundred merges, read by
``ClipTokenizer`` like the real one.
"""
from __future__ import annotations

import collections
import gzip
from collections.abc import Iterable
from pathlib import Path

from qa_tiger_tpu_torch.data.tokenizer import _clean, bytes_to_unicode, split_pattern


def learn_merges(texts: Iterable[str], n_merges: int = 300) -> list[tuple[str, str]]:
    """Up to ``n_merges`` BPE merges from ``texts``: their split words, byte
    encoded, ``</w>`` on the last symbol; each round merges the most
    frequent pair, ties broken by the pair."""
    enc = bytes_to_unicode()
    words = collections.Counter()
    for text in texts:
        for token in split_pattern().findall(_clean(text).lower()):
            chars = [enc[b] for b in token.encode("utf-8")]
            words[tuple(chars[:-1]) + (chars[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for word, n in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for word, n in words.items():
            out, i = [], 0
            while i < len(word):
                if i + 1 < len(word) and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    return merges


def write_merges(path: Path, texts: Iterable[str], n_merges: int = 300) -> Path:
    """``learn_merges`` written gzipped under a header line to ``path``."""
    merges = learn_merges(texts, n_merges)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n")
    return path
