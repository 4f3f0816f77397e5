"""CLIP BPE tokenizer (port of ``sinddm_tpu/models/clip/tokenizer.py``).

The standard OpenAI CLIP byte-pair encoding: byte-level unicode mapping over
a 49,152-entry vocabulary (256 byte tokens, 256 ``</w>`` variants, 48,894
merges, ``<|startoftext|>`` / ``<|endoftext|>``); text is html-unescaped,
whitespace-collapsed and lowercased before encoding; :func:`tokenize` pads
to context length 77 with SOT / EOT.

The JAX package splits text with the third-party ``regex`` module
(``\\p{L}`` / ``\\p{N}`` classes). This port uses the standard library only:
:func:`split_words` is the same alternation written as a scanner over
``unicodedata`` categories, and gives the same ids. ``ftfy`` mojibake
repair, which the JAX package applies when it is installed, is left out (a
no-op on clean text).

The merge table is the port's own copy of the public OpenAI asset (MIT),
``sinddm_tpu_torch/assets/bpe_simple_vocab_16e6.txt.gz``.
"""

from __future__ import annotations

import gzip
import html
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

DEFAULT_BPE_PATH = str(
    Path(__file__).resolve().parents[2] / "assets" / "bpe_simple_vocab_16e6.txt.gz"
)
CONTEXT_LENGTH = 77

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache()
def bytes_to_unicode():
    """Reversible byte -> printable-unicode map (standard GPT-2 / CLIP)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def split_words(text: str) -> List[str]:
    """The CLIP pre-tokenizer: at each position the first alternative that
    matches, of: a special token, a contraction ('s 't 're 've 'm 'll 'd,
    any case), a run of letters, ONE number character, a run of characters
    that are neither whitespace, letters nor numbers. Whitespace separates."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        head = text[i : i + 15]
        low = head.lower()
        fixed = next((t for t in _SPECIALS + _CONTRACTIONS if low.startswith(t)), None)
        if fixed is not None:
            out.append(head[: len(fixed)])
            i += len(fixed)
            continue
        kind = _kind(text[i])
        if kind == "S":
            i += 1
            continue
        j = i + 1
        if kind != "N":
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(_SPECIALS)
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {t: t for t in _SPECIALS}

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in split_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_default_tokenizer = None


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
) -> np.ndarray:
    """Texts -> [N, context_length] int32 token matrix."""
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = SimpleTokenizer()
    tok = _default_tokenizer
    if isinstance(texts, str):
        texts = [texts]
    sot, eot = tok.sot_token, tok.eot_token
    all_tokens = [[sot] + tok.encode(t) + [eot] for t in texts]
    result = np.zeros((len(all_tokens), context_length), dtype=np.int32)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {texts[i]} is too long for context length {context_length}")
            tokens = tokens[:context_length]
            tokens[-1] = eot
        result[i, : len(tokens)] = tokens
    return result
