"""The port's WordPiece tokenizer (`mico_tpu_torch/text/wordpiece.py`, with
its own vocab copy) against `mico_tpu.text.BertWordPieceTokenizer`."""

from pathlib import Path

import numpy as np
import pytest

from mico_tpu.text import BertWordPieceTokenizer as JaxTokenizer
from mico_tpu_torch.text import BertWordPieceTokenizer
from mico_tpu_torch.text.wordpiece import DEFAULT_VOCAB

JAX_VOCAB = (Path(__file__).resolve().parent.parent / "mico_tpu" / "assets"
             / "vocab.txt")
TEXTS = [
    "a man is skiing in a snowy day.",                  # ASCII
    "Hello, world!!! (it's 3:45pm) -- \"quoted\" & more",   # punctuation
    "Café déjà vu: naïve façade, Ångström",               # accents
    "我爱北京天安门 and 東京",                              # CJK
    "unaffable antidisestablishmentarianism xqzvbn",      # word pieces, [UNK]
    "tabs\tand\nnewlines\r\x00control​chars",       # cleaning
    "",
]


@pytest.fixture(scope="module")
def tokenizers():
    return BertWordPieceTokenizer(), JaxTokenizer(JAX_VOCAB)


def test_vocab_is_a_copy():
    with open(DEFAULT_VOCAB, encoding="utf-8") as a, \
            open(JAX_VOCAB, encoding="utf-8") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("idx", range(len(TEXTS)))
def test_tokenize_and_encode(tokenizers, idx):
    ours, theirs = tokenizers
    text = TEXTS[idx]
    assert ours.tokenize(text) == theirs.tokenize(text)
    assert ours.encode(text, max_length=16) == theirs.encode(text, max_length=16)


def test_batch_encode_and_decode(tokenizers):
    ours, theirs = tokenizers
    a, b = ours(TEXTS, max_length=30), theirs(TEXTS, max_length=30)
    for key in ("input_ids", "attention_mask"):
        assert a[key].dtype == np.int32
        np.testing.assert_array_equal(a[key], b[key])
    assert ours.batch_decode(a["input_ids"]) == theirs.batch_decode(
        b["input_ids"])
    assert (ours.bos_token_id, ours.eos_token_id, ours.pad_token_id) == (
        101, 102, 0)
