"""CLIP's byte-level BPE tokenizer, without ``tokenizers`` or ``regex``.

Gives the ids and attention masks of ``transformers``' ``CLIPTokenizerFast``
(what the JAX package's ``CLIPProcessor`` loads) from a checkpoint's
``vocab.json``, ``merges.txt`` and special-token files:

1. normalise: NFC, each run of whitespace to one space, then each character
   lowercased on its own (no final-sigma rule);
2. the special tokens (``<|startoftext|>``, ``<|endoftext|>``, any added
   token) are cut out of the normalised text and map to their ids;
3. pre-tokenise: the rest splits into the matches of
   ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``, and
   whitespace between them is dropped. Python's ``re`` has no ``\\p{L}``, so
   this is a scanner over ``unicodedata.category``, with the code points
   where ``tokenizers``' newer tables differ carried as data (below);
4. each piece's UTF-8 bytes map through GPT-2's ``bytes_to_unicode``, the
   last symbol takes ``</w>``, a symbol missing from the vocabulary becomes
   the unknown token, and the merges apply by rank, the leftmost occurrence
   of the best-ranked pair first;
5. ``<|startoftext|>`` ids ``<|endoftext|>``, padded on the right to the
   longest sequence with the pad token.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

# the Unicode White_Space property: what the normaliser's and the
# pre-tokeniser's \s match
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
# CLIPTokenizer keeps the merges after merges.txt's first line, at most
# 49152 - 256 - 2 of them
MAX_MERGES = 49152 - 256 - 2


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


# Where ``tokenizers`` 0.22.2 (the library CLIPTokenizerFast runs) and
# Python 3.12's Unicode 15.0.0 disagree, over every code point but the
# surrogates: the library's pre-tokeniser regex matches these (first, last)
# ranges as \p{L} or \p{N}, and its Lowercase normaliser maps these
# (first, last, lowercase of first) ranges one to one. Python's database
# leaves them unassigned. Found with the library's own Split(\p{L}),
# Split(\p{N}) and Lowercase over the whole code space; they are data
# because the library is not a dependency of this package. Its \s and NFC
# agree with Python's everywhere.
_NEWER_LETTERS = (
    (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
    (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389),
    (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
    (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA),
    (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
    (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_NEWER_NUMBERS = (
    (0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
    (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))
_NEWER_LOWERCASE = (
    (0x1C89, 0x1C89, 0x1C8A), (0xA7CB, 0xA7CB, 0x0264), (0xA7CC, 0xA7CC, 0xA7CD),
    (0xA7CE, 0xA7CE, 0xA7CF), (0xA7D2, 0xA7D2, 0xA7D3), (0xA7D4, 0xA7D4, 0xA7D5),
    (0xA7DA, 0xA7DA, 0xA7DB), (0xA7DC, 0xA7DC, 0x019B), (0x10D50, 0x10D65, 0x10D70),
    (0x16EA0, 0x16EB8, 0x16EBB))
_LOWER = {chr(c): chr(low + c - first)
          for first, last, low in _NEWER_LOWERCASE for c in range(first, last + 1)}


def _in_ranges(ch: str, ranges) -> bool:
    c = ord(ch)
    return any(first <= c <= last for first, last in ranges)


def _is_letter(ch: str) -> bool:
    cat = unicodedata.category(ch)
    return cat[0] == "L" or (cat == "Cn" and _in_ranges(ch, _NEWER_LETTERS))


def _is_number(ch: str) -> bool:
    cat = unicodedata.category(ch)
    return cat[0] == "N" or (cat == "Cn" and _in_ranges(ch, _NEWER_NUMBERS))


def _lower(ch: str) -> str:
    return _LOWER.get(ch) or ch.lower()


def normalize(text: str) -> str:
    """NFC, each whitespace run to one space, per-character lowercase."""
    out: List[str] = []
    in_run = False
    for ch in unicodedata.normalize("NFC", text):
        if ch in WHITESPACE:
            if not in_run:
                out.append(" ")
            in_run = True
        else:
            out.append(_lower(ch))
            in_run = False
    return "".join(out)


def pre_tokenize(text: str) -> List[str]:
    """The pieces of the pattern in the module docstring, whitespace dropped."""
    pieces: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch == "'":
            tail = next((c for c in CONTRACTIONS if text.startswith(c, i + 1)), None)
            if tail is not None:
                pieces.append("'" + tail)
                i += 1 + len(tail)
                continue
        if ch in WHITESPACE:
            i += 1
            continue
        j = i + 1
        if _is_letter(ch):
            while j < n and _is_letter(text[j]):
                j += 1
        elif not _is_number(ch):
            while j < n and not (text[j] in WHITESPACE or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


def _token_content(value) -> str:
    return value["content"] if isinstance(value, dict) else value


class CLIPTokenizer:
    """Byte-level BPE with CLIP's normaliser, pre-tokeniser and template."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], *,
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 unk_token: str = "<|endoftext|>", pad_token: str = "<|endoftext|>",
                 added_tokens: Sequence[str] = ()):
        self.vocab = dict(vocab)
        self.ranks = {pair: rank for rank, pair in enumerate(merges)}
        bad = [p for p in merges
               if len(p) != 2 or not {p[0], p[1], p[0] + p[1]} <= self.vocab.keys()]
        if bad:
            raise ValueError(f"merges {bad[:3]} name tokens missing from the vocabulary")
        for name, tok in (("bos", bos_token), ("eos", eos_token), ("unk", unk_token),
                          ("pad", pad_token)):
            if tok not in self.vocab:
                raise ValueError(f"the {name} token {tok!r} is not in the vocabulary")
        self.bos_id, self.eos_id = self.vocab[bos_token], self.vocab[eos_token]
        self.unk_id, self.pad_id = self.vocab[unk_token], self.vocab[pad_token]
        # the special tokens, cut out of the normalised text (longest first)
        specials = {bos_token, eos_token, unk_token, pad_token, *added_tokens}
        self.specials = sorted((t for t in specials if t in self.vocab), key=len, reverse=True)
        self.byte_encoder = bytes_to_unicode()
        self._cache: Dict[str, List[int]] = {}

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        """From ``vocab.json`` and ``merges.txt``, with the special tokens of
        ``special_tokens_map.json`` over ``tokenizer_config.json``."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]
        tokens = {}
        added: List[str] = []
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            p = os.path.join(path, name)
            if not os.path.isfile(p):
                continue
            with open(p, encoding="utf-8") as f:
                cfg = json.load(f)
            for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                if cfg.get(key) is not None:
                    tokens[key] = _token_content(cfg[key])
            added += [_token_content(v) for v in cfg.get("added_tokens_decoder", {}).values()]
            added += [_token_content(v) for v in cfg.get("additional_special_tokens", [])]
        return cls(vocab, merges, added_tokens=added, **tokens)

    def _bpe(self, piece: str) -> List[int]:
        ids = self._cache.get(piece)
        if ids is not None:
            return ids
        chars = [self.byte_encoder[b] for b in piece.encode("utf-8")]
        chars[-1] += "</w>"
        # a symbol the vocabulary lacks is the unknown token and never merges
        symbols = [c if c in self.vocab else None for c in chars]
        while len(symbols) > 1:
            best, at = None, -1
            for k in range(len(symbols) - 1):
                a, b = symbols[k], symbols[k + 1]
                if a is None or b is None:
                    continue
                rank = self.ranks.get((a, b))
                if rank is not None and (best is None or rank < best):
                    best, at = rank, k
            if best is None:
                break
            symbols[at:at + 2] = [symbols[at] + symbols[at + 1]]
        ids = [self.unk_id if s is None else self.vocab[s] for s in symbols]
        self._cache[piece] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """Ids of one text with its start and end tokens."""
        ids = [self.bos_id]
        rest = normalize(text)
        while rest:
            cut = min(((rest.find(t), t) for t in self.specials if t in rest),
                      default=(-1, ""), key=lambda x: x[0])
            head = rest if cut[0] < 0 else rest[:cut[0]]
            for piece in pre_tokenize(head):
                ids += self._bpe(piece)
            if cut[0] < 0:
                break
            ids.append(self.vocab[cut[1]])
            rest = rest[cut[0] + len(cut[1]):]
        ids.append(self.eos_id)
        return ids

    def __call__(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        """``input_ids`` and ``attention_mask``, (B, T) int64, padded on the
        right to the longest text."""
        seqs = [self.encode(t) for t in texts]
        t = max((len(s) for s in seqs), default=0)
        ids = np.full((len(seqs), t), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(seqs), t), dtype=np.int64)
        for row, s in enumerate(seqs):
            ids[row, :len(s)] = s
            mask[row, :len(s)] = 1
        return {"input_ids": ids, "attention_mask": mask}
