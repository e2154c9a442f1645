"""Byte-level BPE tokenizer of the CLIP text towers (counterpart of
`mico_tpu/text/bpe.py`, kept as this package's own copy).

The OpenAI/EVA-CLIP SimpleTokenizer's algorithm: GPT-2's byte → unicode
alphabet, rank-greedy pair merging over each word with an end-of-word
marker, lowercasing and whitespace collapse after a double
`html.unescape`, and the `[SOT] ids [EOT]` fixed-length layout whose
truncation forces [EOT] into the last slot. The merge table is data, a
CLIP-format `.txt(.gz)` file (a header line, then one merge per line):
`vocab_path=`, `$MICO_BPE_VOCAB`, or the package's
`assets/bpe_vocab.txt.gz` when present.

Words are split without the `regex` module. CLIP's pattern
`'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`, matched
case-insensitively, is `split_words`, a scanner over
`unicodedata.category`: the contractions first, then runs of letters (L*),
single numbers (N*), and runs of everything else that is not whitespace.
Two details of `regex` are kept: its `\\s` is `str.isspace()` without the
separators U+001C–U+001F, and under IGNORECASE its negated class also
refuses a character one of whose case variants is a letter or a number
(U+0345, whose capital is Greek Ι), which no alternative then matches. The
categories are those of Python's `unicodedata`: a character that a newer
Unicode version assigns, and Python's does not, splits as punctuation.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

# merge lines of the CLIP vocab: the 49,152-entry table minus the 256 byte
# units and the 2 specials (the 256 `</w>` units are further rows of the
# 49,408-entry vocab, not merge lines)
N_MERGES = 49152 - 256 - 2

_WORD_END = "</w>"
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
DEFAULT_VOCAB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "..", "assets", "bpe_vocab.txt.gz")


@lru_cache()
def _byte_alphabet() -> Dict[int, str]:
    """GPT-2's reversible byte → printable-unicode map: printable ASCII and
    Latin-1 bytes map to themselves, the rest to code points from 256 on.
    The insertion order (printables first) is the unit tokens' id order."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shifted = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shifted)
            shifted += 1
    return table


def _adjacent_pairs(piece: Tuple[str, ...]):
    return set(zip(piece[:-1], piece[1:]))


def _clean_text(text: str) -> str:
    # the reference also runs ftfy.fix_text, a no-op on well-formed utf-8
    text = html.unescape(html.unescape(text))
    return " ".join(text.split())


def _char_class(c: str) -> str:
    """'L' letter, 'N' number, 'P' punctuation, ' ' matched by nothing."""
    major = unicodedata.category(c)[0]
    if major in "LN":
        return major
    if c.isspace() and not "\x1c" <= c <= "\x1f":
        return " "
    if any(len(v) == 1 and unicodedata.category(v)[0] in "LN"
           for v in (c.lower(), c.upper())):
        return " "
    return "P"


def _contraction_end(text: str, i: int) -> int:
    """The end of the contraction at text[i] == "'", or 0 for none; its
    letters match case-insensitively (`ſ` as `s`)."""
    for tail in _CONTRACTIONS:
        j = i + 1 + len(tail)
        if j <= len(text) and all(
                a == b or a.upper() == b.upper()
                for a, b in zip(text[i + 1:j], tail)):
            return j
    return 0


def split_words(text: str) -> List[str]:
    """CLIP's word split of `text` (its regex's `findall`)."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = _contraction_end(text, i) if text[i] == "'" else 0
        if not j:
            kind = _char_class(text[i])
            if kind == " ":
                i += 1
                continue
            j = i + 1
            if kind != "N":
                while j < n and _char_class(text[j]) == kind:
                    j += 1
        words.append(text[i:j])
        i = j
    return words


def default_vocab_path() -> str:
    env = os.environ.get("MICO_BPE_VOCAB")
    if env:
        return env
    if os.path.exists(DEFAULT_VOCAB):
        return os.path.abspath(DEFAULT_VOCAB)
    raise FileNotFoundError(
        "no BPE merge table found: pass vocab_path= or set $MICO_BPE_VOCAB "
        "to a CLIP-format merges file (txt or txt.gz)"
    )


class ClipBpeTokenizer:
    # both published spellings of the two specials
    SOT_NAMES = ("<|startoftext|>", "<start_of_text>")
    EOT_NAMES = ("<|endoftext|>", "<end_of_text>")

    def __init__(self, vocab_path: str = None):
        vocab_path = vocab_path or default_vocab_path()
        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # line 0 is the CLIP file's header
        merges = [tuple(ln.split()) for ln in lines[1:N_MERGES + 1]]
        self.merge_rank = {m: i for i, m in enumerate(merges)}

        units = list(_byte_alphabet().values())
        tokens = units + [u + _WORD_END for u in units]
        tokens += ["".join(m) for m in merges]
        tokens += ["<|startoftext|>", "<|endoftext|>"]
        self.token_to_id = {t: i for i, t in enumerate(tokens)}
        self.id_to_token = {i: t for t, i in self.token_to_id.items()}
        self.sot_id = self.token_to_id["<|startoftext|>"]
        self.eot_id = self.token_to_id["<|endoftext|>"]
        for name in self.SOT_NAMES:
            self.token_to_id.setdefault(name, self.sot_id)
        for name in self.EOT_NAMES:
            self.token_to_id.setdefault(name, self.eot_id)

        self.byte_to_unit = _byte_alphabet()
        self.unit_to_byte = {v: k for k, v in self.byte_to_unit.items()}
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    def _merge_word(self, word: str) -> List[str]:
        """One byte-mapped word → its merged pieces."""
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        piece = tuple(word[:-1]) + (word[-1] + _WORD_END,)
        if len(piece) == 1:
            return [word + _WORD_END]
        pairs = _adjacent_pairs(piece)
        while pairs:
            best = min(pairs, key=lambda p: self.merge_rank.get(p, 1 << 30))
            if best not in self.merge_rank:
                break
            a, b = best
            merged = []
            i = 0
            while i < len(piece):
                if i < len(piece) - 1 and piece[i] == a and piece[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(piece[i])
                    i += 1
            piece = tuple(merged)
            if len(piece) == 1:
                break
            pairs = _adjacent_pairs(piece)
        out = list(piece)
        self._cache[word] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in split_words(_clean_text(text).lower()):
            mapped = "".join(self.byte_to_unit[b]
                             for b in word.encode("utf-8"))
            ids.extend(self.token_to_id[p] for p in self._merge_word(mapped))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.id_to_token[int(i)] for i in ids)
        raw = bytearray(
            self.unit_to_byte[c] for c in text if c in self.unit_to_byte)
        return raw.decode("utf-8", errors="replace").replace(_WORD_END, " ")

    def __call__(self, texts: Union[str, List[str]],
                 context_length: int = 77) -> np.ndarray:
        """→ int32 (N, context_length): [SOT] ids [EOT], zero-padded; an
        over-long input is truncated with [EOT] forced into the last slot."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot_id] + self.encode(t) + [self.eot_id]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, :len(ids)] = ids
        return out
