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
    got = tbert.bert_forward(model, t(ids), t(mask),
                            attn_impl="flash").sequence_output
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
        attn_impl="flash").sequence_output
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
        encoder_row_index=t(index).long(),
        attn_impl="flash").sequence_output
    close(got, want.sequence_output, MODEL_TOL)
    repeated = tbert.bert_forward(
        model, t(ids), t(mask), encoder_hidden_states=t(cond[index]),
        encoder_attention_mask=t(enc_mask[index]),
        attn_impl="flash").sequence_output
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


# ---------------------------------------------------------------------------
# training: mlm_loss, dropout, remat
# ---------------------------------------------------------------------------


def test_mlm_loss_matches_jax(rng, berts):
    jparams, jcfg, model = berts
    ids, mask = _text(rng, 3, 12, [12, 9, 12])
    labels = np.where(rng.random((3, 12)) < 0.4, ids, -100).astype(np.int32)
    labels[2] = -100                      # a row with no label
    cond = (rng.standard_normal((3, 20, 64)) * 0.5).astype(np.float32)
    want = jbert.bert_forward(jparams, jcfg, jnp.asarray(ids),
                              jnp.asarray(mask),
                              encoder_hidden_states=jnp.asarray(cond),
                              labels=jnp.asarray(labels))
    got = tbert.bert_forward(model, t(ids), t(mask),
                             encoder_hidden_states=t(cond),
                             labels=t(labels).long())
    close(got.loss, want.loss, MODEL_TOL)
    close(got.logits, want.logits, MODEL_TOL)
    close(got.sequence_output, want.sequence_output, MODEL_TOL)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    none = np.full((2, 5), -100, np.int32)
    for lab in (labels[:2, :5] % 11, none):
        close(tbert.mlm_loss(t(logits), t(lab).long()),
              jbert.mlm_loss(jnp.asarray(logits), jnp.asarray(lab)), OP_TOL)
    assert tbert.bert_forward(model, t(ids), t(mask)).loss is None


def test_dropout_contract():
    from mico_tpu_torch.ops.layers import dropout

    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    assert dropout(x, 0.0, g) is x and dropout(x, 0.1, None) is x
    y = dropout(x, 0.1, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert abs(y.mean().item() - 1.0) < 1e-2          # the mean is kept


def test_training_dropout_rate_zero_is_eval(rng, berts):
    """A train generator with both rates at 0 changes nothing; with the
    default 0.1 rates the output moves, and follows the seed."""
    import dataclasses

    _, _, model = berts
    ids, mask = _text(rng, 2, 30, [30, 20])
    cond = t((rng.standard_normal((2, 300, 64)) * 0.5).astype(np.float32))
    evaluated = tbert.bert_forward(model, t(ids), t(mask),
                                   encoder_hidden_states=cond).sequence_output
    off = dataclasses.replace(model.cfg, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    real = model.cfg
    try:
        model.cfg = off
        zero = tbert.bert_forward(
            model, t(ids), t(mask), encoder_hidden_states=cond,
            train_rng=torch.Generator().manual_seed(0)).sequence_output
    finally:
        model.cfg = real
    torch.testing.assert_close(zero, evaluated, rtol=0, atol=0)
    runs = [tbert.bert_forward(
        model, t(ids), t(mask), encoder_hidden_states=cond,
        train_rng=torch.Generator().manual_seed(s)).sequence_output
        for s in (0, 0, 1)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.allclose(runs[0], evaluated)
    assert not torch.allclose(runs[0], runs[2])


def test_remat_recomputes_the_same_dropout(rng, berts):
    """remat (each layer under torch.utils.checkpoint) draws each layer's
    masks from a seed inside the layer, so the recomputed forward drops the
    same elements: equal loss and gradients."""
    import copy

    _, _, model = berts
    model = copy.deepcopy(model).requires_grad_(True)
    ids, mask = _text(rng, 2, 12, [12, 8])
    labels = t(np.where(rng.random((2, 12)) < 0.5, ids, -100)).long()
    cond = t((rng.standard_normal((2, 20, 64)) * 0.5).astype(np.float32))
    got = []
    for remat in (False, True):
        model.zero_grad()
        out = tbert.bert_forward(model, t(ids), t(mask),
                                 encoder_hidden_states=cond, labels=labels,
                                 remat=remat,
                                 train_rng=torch.Generator().manual_seed(5))
        out.loss.backward()
        got.append((out.loss.item(), {n: p.grad.clone()
                                      for n, p in model.named_parameters()
                                      if p.grad is not None}))
    assert got[0][0] == got[1][0]
    assert got[0][1].keys() == got[1][1].keys()
    for name, g in got[0][1].items():
        torch.testing.assert_close(got[1][1][name], g, rtol=1e-6, atol=1e-7)
