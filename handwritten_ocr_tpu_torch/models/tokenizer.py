"""Byte-level BPE read from a snapshot's ``tokenizer.json``, without
``transformers`` or ``tokenizers``.

The counterpart of ``HFTokenizer`` (``handwritten_ocr_tpu/models/
processor.py``, a wrapper of ``transformers.AutoTokenizer``) for the
Qwen2 / Qwen3 tokenizers: ``encode(text)`` and ``decode(ids)`` give what
``AutoTokenizer``'s ``encode(text, add_special_tokens=False)`` and
``decode(ids, skip_special_tokens=True)`` give.

Encoding, in the ``tokenizers`` library's order:
1. added tokens are cut out whole (leftmost, longest first): those marked
   ``normalized: false`` from the raw text, the others after normalising;
2. the rest is NFC-normalised and split by the Qwen2 pre-tokenizer
   pattern ``(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}|
    ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+``. The standard
   library's ``re`` has no ``\\p{L}``, so :func:`pre_tokenize` is a hand
   scanner over ``unicodedata`` categories with the alternation's
   leftmost-first semantics;
3. each piece's UTF-8 bytes map to printable characters (GPT-2's
   byte-to-unicode table) and merge pair by pair, lowest merge rank first.

Decoding drops special tokens and ids outside the vocabulary, maps each
token's characters back to bytes (a token with a character outside the
table contributes its own UTF-8, as ``tokenizers``' ByteLevel decoder
does) and decodes the bytes as UTF-8 with replacement.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Sequence

# \s of the pattern's regex engine: the ASCII controls, NEL, and the
# Unicode space / line / paragraph separators.
_SPACE_CHARS = frozenset("\t\n\x0b\x0c\r\x85")
_NEWLINES = frozenset("\r\n")
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                 r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|"
                 r"\s+(?!\S)|\s+")


def _fold(ch: str) -> str:
    """Case folding of the contraction group (``ſ`` folds to ``s``)."""
    return "s" if ch == "\u017f" else ch.lower()


@lru_cache(maxsize=None)
def _is_space(ch: str) -> bool:
    return ch in _SPACE_CHARS or unicodedata.category(ch) in ("Zs", "Zl", "Zp")


@lru_cache(maxsize=None)
def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


@lru_cache(maxsize=None)
def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _match_at(text: str, i: int) -> int:
    """End of the pattern's match at ``i`` (every position matches)."""
    n = len(text)
    ch = text[i]
    # (?i:'s|'t|'re|'ve|'m|'ll|'d)
    if ch == "'":
        for suffix in _CONTRACTIONS:
            if "".join(map(_fold, text[i + 1:i + 1 + len(suffix)])) == suffix:
                return i + 1 + len(suffix)
    # [^\r\n\p{L}\p{N}]?\p{L}+
    start = i
    if not (ch in _NEWLINES or _is_letter(ch) or _is_number(ch)) \
            and i + 1 < n and _is_letter(text[i + 1]):
        start = i + 1
    if _is_letter(text[start]):
        end = start + 1
        while end < n and _is_letter(text[end]):
            end += 1
        return end
    # \p{N}
    if _is_number(ch):
        return i + 1

    def other(c):
        return not (_is_space(c) or _is_letter(c) or _is_number(c))
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    start = i + 1 if ch == " " and i + 1 < n and other(text[i + 1]) else i
    if other(text[start]):
        end = start + 1
        while end < n and other(text[end]):
            end += 1
        while end < n and text[end] in _NEWLINES:
            end += 1
        return end
    # whitespace: \s*[\r\n]+ | \s+(?!\S) | \s+
    run = i
    while run < n and _is_space(text[run]):
        run += 1
    last_newline = max((j for j in range(i, run) if text[j] in _NEWLINES),
                       default=-1)
    if last_newline >= 0:
        return last_newline + 1
    if run == n or run - i == 1:
        return run
    return run - 1       # the run's last space goes with the next word


def pre_tokenize(text: str) -> list[str]:
    """The Qwen2 pre-tokenizer's pieces of ``text`` (its ``Split`` with
    behaviour ``Isolated``): consecutive matches of the pattern."""
    pieces, i = [], 0
    while i < len(text):
        end = _match_at(text, i)
        pieces.append(text[i:end])
        i = end
    return pieces


@lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


class BPETokenizer:
    """A byte-level BPE tokenizer from a ``tokenizer.json``."""

    def __init__(self, spec: dict):
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise ValueError(f"unsupported tokenizer model {model.get('type')}")
        self._check_pipeline(spec)
        self.vocab: dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks = {pair: rank for rank, pair in enumerate(merges)}
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.added: dict[str, int] = {}
        self.special_ids: set[int] = set()
        raw_tokens, normalized_tokens = [], []
        for token in spec.get("added_tokens", []):
            if token.get("single_word") or token.get("lstrip") \
                    or token.get("rstrip"):
                raise ValueError(f"added token {token['content']!r}: "
                                 "single_word / lstrip / rstrip unsupported")
            self.added[token["content"]] = token["id"]
            if token.get("special"):
                self.special_ids.add(token["id"])
            (normalized_tokens if token.get("normalized", not token.get(
                "special")) else raw_tokens).append(token["content"])
        self._raw_split = self._splitter(raw_tokens)
        self._normalized_split = self._splitter(normalized_tokens)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_dir(cls, model_dir: str | Path) -> "BPETokenizer":
        """The tokenizer of a snapshot directory (its ``tokenizer.json``)."""
        return cls(json.loads((Path(model_dir) / "tokenizer.json")
                              .read_text(encoding="utf-8")))

    @staticmethod
    def _check_pipeline(spec: dict) -> None:
        """Raise unless the normaliser, pre-tokenizer and decoder are the
        Qwen2 ones this class implements."""
        normalizer = spec.get("normalizer")
        if normalizer not in (None, {"type": "NFC"}):
            raise ValueError(f"unsupported normalizer {normalizer}")
        pre = spec.get("pre_tokenizer") or {}
        steps = pre.get("pretokenizers", [pre])
        kinds = [step.get("type") for step in steps]
        if kinds != ["Split", "ByteLevel"]:
            raise ValueError(f"unsupported pre_tokenizer {kinds}")
        split, byte_level = steps
        if split.get("pattern") != {"Regex": QWEN2_PATTERN}:
            raise ValueError(f"unsupported split pattern {split.get('pattern')}")
        if split.get("behavior") != "Isolated" or split.get("invert") or \
                byte_level.get("add_prefix_space") or \
                byte_level.get("use_regex", True):
            raise ValueError("unsupported pre_tokenizer settings")
        decoder = (spec.get("decoder") or {}).get("type")
        if decoder != "ByteLevel":
            raise ValueError(f"unsupported decoder {decoder}")

    @staticmethod
    def _splitter(tokens: list[str]):
        if not tokens:
            return None
        ordered = sorted(tokens, key=len, reverse=True)   # longest first
        return re.compile("(" + "|".join(map(re.escape, ordered)) + ")")

    def _cut(self, pieces: list[tuple[str, bool]], pattern):
        """Split the non-token pieces at every match of ``pattern``."""
        if pattern is None:
            return pieces
        out = []
        for text, is_token in pieces:
            if is_token:
                out.append((text, True))
                continue
            for k, part in enumerate(pattern.split(text)):
                if part:
                    out.append((part, k % 2 == 1))
        return out

    def _bpe(self, word: str) -> list[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            parts = list(word)
            while len(parts) > 1:
                best, best_rank = -1, None
                for j in range(len(parts) - 1):
                    rank = self.ranks.get((parts[j], parts[j + 1]))
                    if rank is not None and (best_rank is None
                                             or rank < best_rank):
                        best, best_rank = j, rank
                if best < 0:
                    break
                pair = (parts[best], parts[best + 1])
                merged, j = [], 0
                while j < len(parts):     # every occurrence, left to right
                    if j < len(parts) - 1 and (parts[j], parts[j + 1]) == pair:
                        merged.append(parts[j] + parts[j + 1])
                        j += 2
                    else:
                        merged.append(parts[j])
                        j += 1
                parts = merged
            ids = [self.vocab[p] for p in parts]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        pieces = self._cut([(text, False)], self._raw_split)
        pieces = [(p if is_token else unicodedata.normalize("NFC", p),
                   is_token) for p, is_token in pieces]
        pieces = self._cut(pieces, self._normalized_split)
        ids: list[int] = []
        encoder = self.byte_encoder
        for piece, is_token in pieces:
            if is_token:
                ids.append(self.added[piece])
                continue
            for word in pre_tokenize(piece):
                ids.extend(self._bpe("".join(encoder[b]
                                             for b in word.encode("utf-8"))))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        decoder = self.byte_decoder
        for i in ids:
            i = int(i)
            token = self.id_to_token.get(i)
            if token is None or i in self.special_ids:
                continue
            if all(ch in decoder for ch in token):
                out.extend(decoder[ch] for ch in token)
            else:
                out.extend(token.encode("utf-8"))
        return out.decode("utf-8", errors="replace")
