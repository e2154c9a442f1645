"""BERT WordPiece tokenizer (uncased), dependency-free.

Counterpart of `mico_tpu/text/wordpiece.py`, kept as this package's own
copy; the vocab defaults to the package's `assets/vocab.txt`
(bert-base-uncased, 30,522 entries).

Functional equivalent of the HF BertTokenizer the reference loads from
`model/tokenizer` (model/mico.py:109-113): basic tokenization (lowercase,
accent stripping, punctuation splitting, CJK isolation) followed by greedy
longest-match-first WordPiece, [CLS]/[SEP] wrapping, max-length padding.
Special-token bindings follow the reference: bos=[CLS], eos=[SEP],
pad=[PAD], mask=[MASK].
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import numpy as np

DEFAULT_VOCAB = Path(__file__).resolve().parent.parent / "assets" / "vocab.txt"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


class BertWordPieceTokenizer:
    def __init__(
        self,
        vocab_file: str | Path = DEFAULT_VOCAB,
        do_lower_case: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab: Dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.do_lower_case = do_lower_case
        self.max_chars = max_input_chars_per_word
        self.unk_token = "[UNK]"
        self.pad_token_id = self.vocab["[PAD]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.mask_token_id = self.vocab["[MASK]"]
        self.unk_token_id = self.vocab["[UNK]"]
        # reference runtime bindings (model/mico.py:110-113)
        self.bos_token_id = self.cls_token_id
        self.eos_token_id = self.sep_token_id

    # -- basic tokenization ------------------------------------------------
    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if ch.isspace() else ch)
        return "".join(out)

    def _split_basic(self, text: str) -> List[str]:
        text = self._clean(text)
        # isolate CJK
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        tokens = "".join(chars).split()
        out: List[str] = []
        for tok in tokens:
            if self.do_lower_case:
                tok = tok.lower()
                tok = unicodedata.normalize("NFD", tok)
                tok = "".join(
                    c for c in tok if unicodedata.category(c) != "Mn"
                )
            # split punctuation
            cur: List[str] = []
            for ch in tok:
                if _is_punctuation(ch):
                    if cur:
                        out.append("".join(cur))
                        cur = []
                    out.append(ch)
                else:
                    cur.append(ch)
            if cur:
                out.append("".join(cur))
        return out

    # -- wordpiece ---------------------------------------------------------
    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self._split_basic(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(
        self, text: str, max_length: int = None, pad_to_max: bool = True
    ) -> List[int]:
        ids = [self.cls_token_id]
        ids += [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if max_length is not None:
            ids = ids[: max_length - 1]
        ids.append(self.sep_token_id)
        if max_length is not None and pad_to_max:
            ids += [self.pad_token_id] * (max_length - len(ids))
        return ids

    def __call__(
        self,
        texts: Sequence[str] | str,
        max_length: int = 30,
        padding: str = "max_length",
    ):
        """HF-style batch encode → dict(input_ids, attention_mask) int32."""
        if isinstance(texts, str):
            texts = [texts]
        rows = [self.encode(t, max_length=max_length) for t in texts]
        ids = np.asarray(rows, np.int32)
        mask = (ids != self.pad_token_id).astype(np.int32)
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        special = {self.pad_token_id, self.cls_token_id, self.sep_token_id}
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special:
                continue
            toks.append(self.ids_to_tokens.get(i, self.unk_token))
        text = " ".join(toks).replace(" ##", "")
        return text

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(row, skip_special_tokens) for row in batch]
