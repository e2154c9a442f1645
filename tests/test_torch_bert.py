"""The port's BERT interface (`mico_tpu_torch/models/bert.py`) against
`mico_tpu.models.bert` on the CPU: text-only (30 tokens, plain attention),
a 70-token padded text (K2's biased body), and cross-attention over a
(B, 300, 64) condition (K2's bias-free body), with and without an encoder
mask and the unique-row `kv_index` gather."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu.models import bert as jbert
from mico_tpu_torch.models import bert as tbert
from mico_tpu_torch.ops import attention as tattn

from torch_port_common import MODEL_TOL, OP_TOL, close, configs, \
    perturbed_params, port_model, t


@pytest.fixture(scope="module")
def berts():
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg)
    return params["bert"], jcfg.bert_config, port_model(params, tcfg).bert


def _text(rng, b, l, pad_from=None):
    ids = rng.integers(200, 20000, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    for row, start in enumerate(pad_from or []):
        mask[row, start:] = 0
        ids[row, start:] = 0
    return ids, mask


def _count_routes(monkeypatch):
    calls = []
    real = tattn.fa.flash_attention

    def spy(*a, **kw):
        calls.append(kw.get("bias") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(tattn.fa, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("l,pad_from,k2_calls", [
    (30, [30, 12], 0),          # Lq·Lk = 900: plain attention
    (70, [70, 41, 9], 2),       # 70·70 > 4096: K2 with a (B,1,1,L) mask
])
def test_text_only(rng, berts, monkeypatch, l, pad_from, k2_calls):
    jparams, jcfg, model = berts
    ids, mask = _text(rng, len(pad_from), l, pad_from)
    want = jbert.bert_forward(jparams, jcfg, jnp.asarray(ids),
                              jnp.asarray(mask), attn_impl="flash")
    calls = _count_routes(monkeypatch)
    got = tbert.bert_forward(model, t(ids), t(mask), attn_impl="flash")
    assert calls == [True] * k2_calls
    close(got, want.sequence_output, MODEL_TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_attention_on_k2_route(rng, berts, monkeypatch, with_mask):
    jparams, jcfg, model = berts
    ids, mask = _text(rng, 2, 30, [30, 20])
    cond = (rng.standard_normal((2, 300, 64)) * 0.5).astype(np.float32)
    enc_mask = None
    if with_mask:
        enc_mask = np.ones((2, 300), np.int32)
        enc_mask[1, 257:] = 0
    want = jbert.bert_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
        encoder_hidden_states=jnp.asarray(cond),
        encoder_attention_mask=None if enc_mask is None else jnp.asarray(enc_mask),
        attn_impl="flash")
    calls = _count_routes(monkeypatch)
    got = tbert.bert_forward(
        model, t(ids), t(mask), encoder_hidden_states=t(cond),
        encoder_attention_mask=None if enc_mask is None else t(enc_mask),
        attn_impl="flash")
    # 2 layers, each: plain 30x30 self-attention, then K2 over 300 tokens
    assert calls == [with_mask] * jcfg.num_hidden_layers
    close(got, want.sequence_output, MODEL_TOL)


def test_cross_attention_unique_rows(rng, berts):
    """kv_index: K/V projected once per unique condition row, gathered per
    query row — the same as repeating the condition (bert.py:143-156)."""
    jparams, jcfg, model = berts
    ids, mask = _text(rng, 3, 30)
    cond = (rng.standard_normal((2, 300, 64)) * 0.5).astype(np.float32)
    enc_mask = np.ones((2, 300), np.int32)
    enc_mask[0, 280:] = 0
    index = np.array([1, 0, 1], np.int32)
    want = jbert.bert_forward(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
        encoder_hidden_states=jnp.asarray(cond),
        encoder_attention_mask=jnp.asarray(enc_mask),
        encoder_row_index=jnp.asarray(index), attn_impl="flash")
    got = tbert.bert_forward(
        model, t(ids), t(mask), encoder_hidden_states=t(cond),
        encoder_attention_mask=t(enc_mask),
        encoder_row_index=t(index).long(), attn_impl="flash")
    close(got, want.sequence_output, MODEL_TOL)
    repeated = tbert.bert_forward(
        model, t(ids), t(mask), encoder_hidden_states=t(cond[index]),
        encoder_attention_mask=t(enc_mask[index]), attn_impl="flash")
    close(got, repeated.numpy(), OP_TOL)
    with pytest.raises(ValueError, match="per unique row"):
        tbert.bert_forward(model, t(ids), t(mask),
                           encoder_hidden_states=t(cond),
                           encoder_attention_mask=t(enc_mask[index]),
                           encoder_row_index=t(index).long())


def test_embeddings_token_type(rng, berts):
    """token_type_ids=None adds row 0 of the token-type table
    (bert.py:113-114); explicit ids index it."""
    jparams, jcfg, model = berts
    ids, _ = _text(rng, 2, 9)
    types = rng.integers(0, 2, (2, 9)).astype(np.int32)
    for tt in (None, types):
        want = jbert.bert_embeddings(
            jparams["embeddings"], jcfg, jnp.asarray(ids),
            token_type_ids=None if tt is None else jnp.asarray(tt))
        got = tbert.bert_embeddings(
            model.embeddings, model.cfg, t(ids),
            token_type_ids=None if tt is None else t(tt))
        close(got, want, OP_TOL)


@pytest.mark.parametrize("rank", [2, 3])
def test_extended_attention_mask(rng, rank):
    m = (rng.random((2, 5) if rank == 2 else (2, 5, 5)) > 0.4).astype(np.int32)
    want = jbert.extended_attention_mask(jnp.asarray(m))
    got = tbert.extended_attention_mask(t(m))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tbert.extended_attention_mask(torch.ones(5))
