"""The port's CLIP byte-level BPE (`mico_tpu_torch/text/bpe.py`) against
`mico_tpu.text.bpe.ClipBpeTokenizer` on merges files written here (plain
and gzipped): ids compared exactly, on the JAX package's test texts and on
non-ASCII cases (decomposed accents, ², ½, Ⅻ, ٣, `_`, upper-case and
long-s contractions, U+0345) and over-long inputs; the port's word split
against CLIP's `regex` pattern, exactly. The port imports no `regex`; this
test does, as the reference."""

import collections
import gzip
import random
import unicodedata

import numpy as np
import pytest
import regex

from mico_tpu.text import bpe as jbpe
from mico_tpu_torch.text import bpe as tbpe

# tests/test_bpe.py's texts, then the cases the regex-free split must keep
TEXTS = [
    "a photo of a cat",
    "The QUICK brown fox; jumped over 12 lazy dogs!",
    "it's   spaced\tout\nweirdly &amp; escaped",
    "emoji 🌮 and café naïve résumé",
    "word" * 60,
    "",
    "1234567890",
    "multi—dash…punct!!!",
    "café déjà vu, résumé",
    "x² + ½ = 0.5, Ⅻ o'clock, ٣ apples",
    "snake_case __init__ _private",
    "IT'S WE'LL THEY'RE I'VE I'M SHE'D DON'T",
    "it'ſ the long s; ha'S",
    "ᾳ and ͅ alone",
    "a photo of " * 40,
]

PATTERN = regex.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
    regex.IGNORECASE)


def learn_merges(texts, n_merges: int):
    """Frequency BPE merges over the texts' byte-mapped words, `</w>` on
    each word's last unit."""
    units = jbpe._byte_alphabet()
    words = collections.Counter()
    for t in texts:
        for w in PATTERN.findall(jbpe._clean_text(t).lower()):
            mapped = [units[b] for b in w.encode("utf-8")]
            mapped[-1] += "</w>"
            words[tuple(mapped)] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, n in words.items():
            for p in zip(w[:-1], w[1:]):
                pairs[p] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.get)
        merges.append(best)
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    return merges


@pytest.fixture(scope="module", params=["txt", "txt.gz"])
def tokenizers(request, tmp_path_factory):
    """(JAX tokenizer, port tokenizer) over one merges file."""
    merges = learn_merges(TEXTS, 150)
    body = "#version: test\n" + "\n".join(" ".join(m) for m in merges) + "\n"
    path = tmp_path_factory.mktemp("bpe") / f"merges.{request.param}"
    if request.param.endswith(".gz"):
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(body)
    else:
        path.write_text(body, encoding="utf-8")
    return jbpe.ClipBpeTokenizer(str(path)), tbpe.ClipBpeTokenizer(str(path))


@pytest.mark.parametrize("context_length", [77, 16])
def test_ids_equal_jax(tokenizers, context_length):
    jtok, ttok = tokenizers
    want = jtok(TEXTS, context_length=context_length)
    got = ttok(TEXTS, context_length=context_length)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), context_length)
    np.testing.assert_array_equal(got, want)
    # truncation keeps [EOT] in the last slot
    long = [i for i, t in enumerate(TEXTS)
            if len(ttok.encode(t)) + 2 > context_length]
    assert TEXTS.index("a photo of " * 40) in long
    assert (got[long, -1] == ttok.eot_id).all()


def test_tables_equal_jax(tokenizers):
    jtok, ttok = tokenizers
    assert ttok.token_to_id == jtok.token_to_id
    assert ttok.merge_rank == jtok.merge_rank
    assert ttok.vocab_size == jtok.vocab_size
    assert ttok.eot_id == max(ttok.id_to_token)


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_roundtrip(tokenizers, text):
    jtok, ttok = tokenizers
    ids = ttok.encode(text)
    assert ids == jtok.encode(text)
    assert ttok.decode(ids) == jtok.decode(ids)
    if text == "a photo of a cat":
        assert ttok.decode(ids).strip() == text


def test_special_aliases(tokenizers):
    _, tok = tokenizers
    assert tok.token_to_id["<start_of_text>"] == tok.sot_id
    assert tok.token_to_id["<|startoftext|>"] == tok.sot_id
    assert tok.token_to_id["<end_of_text>"] == tok.eot_id
    assert tok.token_to_id["<|endoftext|>"] == tok.eot_id


def test_split_words_is_the_clip_pattern():
    """Every assigned character below the supplementary private-use planes
    (their 131,068 characters are all Co, as the BMP's 6,400) between
    letters and before a contraction, and random strings over a mixed
    pool, split as CLIP's regex splits them."""
    chars = [chr(c) for c in range(0xF0000)
             if not 0xD800 <= c <= 0xDFFF
             and unicodedata.category(chr(c)) != "Cn"]
    # one string of every context, spaces between (no token crosses one)
    text = " ".join("a" + c + "'s" for c in chars)
    if tbpe.split_words(text) != PATTERN.findall(text):
        bad = [hex(ord(c)) for c in chars if tbpe.split_words(
            "a" + c + "'s") != PATTERN.findall("a" + c + "'s")]
        pytest.fail(f"split differs at {bad[:20]}")
    rnd = random.Random(0)
    pool = (list("'''sStTrReEvVmMlLdD _-.!1 \t") + ["ſ", "ͅ", "²", "½",
            "Ⅻ", "٣", "́", "\x1c"] + rnd.sample(chars, 400))
    for _ in range(3000):
        s = "".join(rnd.choice(pool) for _ in range(rnd.randint(1, 10)))
        assert tbpe.split_words(s) == PATTERN.findall(s), repr(s)


def test_vocab_lookup(monkeypatch, tmp_path):
    """`$MICO_BPE_VOCAB` first; without it and without the package's
    asset, JAX's error."""
    monkeypatch.setenv("MICO_BPE_VOCAB", str(tmp_path / "m.txt"))
    assert tbpe.default_vocab_path() == str(tmp_path / "m.txt")
    monkeypatch.delenv("MICO_BPE_VOCAB")
    monkeypatch.setattr(tbpe, "DEFAULT_VOCAB", str(tmp_path / "none.gz"))
    with pytest.raises(FileNotFoundError, match="MICO_BPE_VOCAB"):
        tbpe.ClipBpeTokenizer()
    assert tbpe.N_MERGES == jbpe.N_MERGES
