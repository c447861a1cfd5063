"""CLIP byte-pair-encoding tokenizer (port of
``distdiff_tpu/models/tokenizer.py``; pure Python, the port's own copy).

Given CLIP's merges file (OpenAI's ``bpe_simple_vocab_16e6.txt.gz`` or a
diffusers checkpoint's ``tokenizer/merges.txt``), ``CLIPTokenizer`` gives
CLIP's ids. Without one, ``HashTokenizer`` stands in: the same API and
shapes and stable ids, but not CLIP's, so ``load_tokenizer(strict=True)``
(real weights) refuses it.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import logging
import os
import re
from typing import List, Optional

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


# CLIP's pattern with ASCII classes for \p{L} and \p{N} (plain ``re``)
_PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                  r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+")


def _pad_ids(tokenizer, texts) -> np.ndarray:
    """``[B, max_length]`` int32: bot, the text's ids, eot, eot padding."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.full((len(texts), tokenizer.max_length), tokenizer.eot, np.int32)
    for i, t in enumerate(texts):
        ids = [tokenizer.bot] + tokenizer.encode(t)[: tokenizer.max_length - 2] + [tokenizer.eot]
        out[i, : len(ids)] = ids
    return out


class CLIPTokenizer:
    """BPE with CLIP's vocabulary layout: 256 byte tokens, the same with
    '</w>', the merges, then <|startoftext|> and <|endoftext|>."""

    def __init__(self, bpe_path: str, max_length: int = 77,
                 vocab_path: Optional[str] = None):
        """``bpe_path``: a merges file with a header line; ``vocab_path``: an
        optional HF ``vocab.json`` giving the token -> id map (else the
        standard layout is rebuilt from the merges)."""
        self.max_length = max_length
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = _bytes_to_unicode()
        if vocab_path:
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
        else:
            vocab = list(self.byte_encoder.values())
            vocab = vocab + [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab.extend(["<|startoftext|>", "<|endoftext|>"])
            self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.bot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _PAT.findall(_basic_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, texts) -> np.ndarray:
        """``[B, max_length]`` int32, eot-padded as CLIP and HF pad for SD."""
        return _pad_ids(self, texts)


class HashTokenizer:
    """Stand-in without a merges file: word -> stable md5 bucket. Not CLIP's
    ids; for tests and synthetic runs only."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        return [int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2)
                for w in _basic_clean(text).split()]

    def __call__(self, texts) -> np.ndarray:
        return _pad_ids(self, texts)


def discover_bpe(checkpoint_dir: Optional[str]):
    """The tokenizer files a diffusers checkpoint ships beside its weights
    (``{dir}/tokenizer/merges.txt`` and ``vocab.json``): (merges path,
    vocab path or None), or (None, None)."""
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None, None
    for sub in ("tokenizer", "."):
        m = os.path.join(checkpoint_dir, sub, "merges.txt")
        if os.path.exists(m):
            v = os.path.join(checkpoint_dir, sub, "vocab.json")
            return m, (v if os.path.exists(v) else None)
    return None, None


def load_tokenizer(bpe_path: Optional[str] = None, max_length: int = 77,
                   vocab_size: int = 49408, checkpoint_dir: Optional[str] = None,
                   strict: bool = False):
    """CLIP BPE when a merges file is found (``bpe_path``, then
    ``$DISTDIFF_CLIP_BPE``, then inside ``checkpoint_dir``), else the hash
    stand-in, which ``strict=True`` (real weights) refuses."""
    bpe_path = bpe_path or os.environ.get("DISTDIFF_CLIP_BPE")
    vocab_path = None
    if not (bpe_path and os.path.exists(bpe_path)):
        bpe_path, vocab_path = discover_bpe(checkpoint_dir)
    if bpe_path and os.path.exists(bpe_path):
        return CLIPTokenizer(bpe_path, max_length=max_length, vocab_path=vocab_path)
    msg = ("no CLIP BPE merges file found (tried bpe_path, $DISTDIFF_CLIP_BPE"
           + (f", {checkpoint_dir}/tokenizer/merges.txt" if checkpoint_dir else "")
           + ") — the HashTokenizer fallback produces ids that do NOT match "
           "real CLIP text-encoder weights")
    if strict:
        raise RuntimeError(msg + "; refusing to run with real SD weights.")
    logging.getLogger("distdiff.tokenizer").warning("%s; proceeding (synthetic/test run).", msg)
    return HashTokenizer(vocab_size=vocab_size, max_length=max_length)
