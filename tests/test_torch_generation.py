"""The port's caption and QA generation (`mico_tpu_torch/generation.py`)
against `mico_tpu.generation` on the CPU at the tiny fp32 config, weights
carried by `params_from_jax` (the MLM head included): identical tokens for
greedy and beam-3 captions and QA answers on the KV-cached and the
recompute paths, the recompute cross-attention on the K2 route, the MLM
head, the split-heads layout, teacher-forced logits, sampling by contract,
and the slice as a whole from pixels to caption tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mico_tpu import generation as jgen
from mico_tpu.models import bert as jbert
from mico_tpu.models import mico as jm
from mico_tpu_torch import generation as tgen
from mico_tpu_torch.config import BERT_MASK_ID, BERT_PAD_ID, BERT_SEP_ID
from mico_tpu_torch.models import bert as tbert
from mico_tpu_torch.ops import attention as tattn

from torch_port_common import MODEL_TOL, close, configs, decoder_setup, \
    perturbed_params, port_model, question_batch, t


@pytest.fixture(scope="module")
def decoders():
    return decoder_setup()


@pytest.fixture(scope="module")
def questions():
    return question_batch()


def test_mlm_logits_match_jax(rng, decoders):
    jparams, jcfg, model, _ = decoders
    seq = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = jbert.mlm_logits(jparams, jcfg, jnp.asarray(seq))
    got = tbert.mlm_logits(model, t(seq))
    assert got.shape == (2, 5, jcfg.vocab_size)
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("with_prefix", [False, True])
def test_part_causal_mask_matches_jax(questions, with_prefix):
    ids, mask = questions
    pm = mask if with_prefix else None
    want = jgen._part_causal_mask(16, None if pm is None else jnp.asarray(pm))
    got = tgen._part_causal_mask(16, None if pm is None else t(pm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("entry", ["caption", "qa"])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
@pytest.mark.parametrize("use_cache", [True, False])
def test_tokens_match_jax(decoders, questions, entry, mode, use_cache):
    """Port and JAX give the same tokens, exactly, on both paths; [SEP]
    finishes some rows mid-decode (SEP_BIAS), so the finished-row and
    finalised-hypothesis logic is exercised."""
    jparams, jcfg, model, cond = decoders
    kw = dict(max_new_tokens=8, mode=mode, num_beams=3, use_cache=use_cache)
    if entry == "caption":
        want = jgen.generate(jparams, jcfg, jnp.asarray(cond), **kw)
        got = tgen.generate(model, t(cond), **kw)
    else:
        ids, mask = questions
        want = jgen.generate_answers(jparams, jcfg, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(cond), **kw)
        got = tgen.generate_answers(model, t(ids), t(mask), t(cond), **kw)
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.shape == (cond.shape[0], 9)
    if entry == "caption":
        assert (got == BERT_SEP_ID).any(axis=1).sum() in (1, 2, 3)


def test_recompute_cross_attention_takes_the_k2_route(rng, decoders,
                                                      monkeypatch):
    """Over 600 condition tokens the recompute decode's cross-attention
    (Lq·Lk = 10·600 > 64·64) goes to the K2 wrapper once per layer and
    step (its plain twin on the CPU); the tokens stay JAX's."""
    jparams, jcfg, model, _ = decoders
    cond = (3.0 * rng.standard_normal((2, 600, 64))).astype(np.float32)
    calls = []
    real = tattn.fa.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tattn.fa, "flash_attention", spy)
    want = jgen.generate(jparams, jcfg, jnp.asarray(cond), max_new_tokens=8,
                         mode="greedy", use_cache=False)
    got = tgen.generate(model, t(cond), max_new_tokens=8, mode="greedy",
                        use_cache=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == [(10, 600)] * (8 * jcfg.num_hidden_layers)


def test_decode_logits_match_jax(decoders, questions):
    """One part-causal recompute pass: fp32 logits at the [MASK] slot."""
    jparams, jcfg, model, cond = decoders
    ids, mask = questions
    tok = np.full((4, 7 + 6), BERT_PAD_ID, np.int32)
    tok[:, :7] = ids
    tok[:, 7:10] = [101, 2023, 2003]
    tok[:, 10] = BERT_MASK_ID
    want = jgen._decode_logits(jparams, jcfg, jnp.asarray(tok), 10,
                               jnp.asarray(cond), None, jnp.float32,
                               prefix_mask=jnp.asarray(mask))
    got = tgen._decode_logits(model, t(tok).long(), 10, t(cond), None,
                              torch.float32, prefix_mask=t(mask))
    close(got, want, MODEL_TOL)


def test_cached_logits_and_teacher_forcing(decoders):
    """The cached decode's per-step logits equal the recompute pass on the
    same tokens, and forcing the decode's own tokens changes nothing."""
    _, _, model, cond = decoders
    c = t(cond)
    tokens, logits = tgen.cached_generate(model, c, max_new_tokens=6,
                                          return_logits=True)
    assert logits.shape == (4, 6, model.cfg.vocab_size)
    forced, flogits = tgen.cached_generate(
        model, c, max_new_tokens=6, teacher_tokens=tokens[:, 1:],
        return_logits=True)
    assert torch.equal(forced, tokens)
    close(flogits, logits.numpy(), MODEL_TOL)
    buf = torch.full((4, 8), BERT_PAD_ID, dtype=torch.long)
    for step in range(6):
        buf[:, :step + 1] = tokens[:, :step + 1]
        buf[:, step + 1] = BERT_MASK_ID
        want = tgen._decode_logits(model, buf, step + 1, c, None,
                                   torch.float32)
        close(logits[:, step], want.numpy(), MODEL_TOL)


def test_cross_kv_split_heads_changes_nothing(decoders, questions,
                                              monkeypatch):
    _, _, model, cond = decoders
    ids, mask = questions
    runs = {}
    for flag in (False, True):
        monkeypatch.setattr(tgen, "CROSS_KV_SPLIT_HEADS", flag)
        runs[flag] = [
            tgen.generate(model, t(cond), max_new_tokens=6, mode=m)
            for m in ("greedy", "beam")
        ] + [tgen.generate_answers(model, t(ids), t(mask), t(cond),
                                   max_new_tokens=4, mode=m)
             for m in ("greedy", "beam")]
    for a, b in zip(runs[False], runs[True]):
        assert torch.equal(a, b)


def test_sampling_contract(decoders):
    """Each sampled token lies in its step's fp32 top-k; top_k=1 is greedy;
    the cached and recompute paths draw the same tokens from equally seeded
    generators; another seed draws other tokens."""
    _, _, model, cond = decoders
    c = t(cond)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    tokens, logits = tgen.cached_generate(
        model, c, max_new_tokens=8, mode="sample", top_k=5, generator=gen(1),
        return_logits=True)
    top5 = logits.topk(5, dim=-1).indices
    live = torch.ones(4, dtype=torch.bool)
    for step in range(8):
        nxt = tokens[:, step + 1]
        assert (top5[live, step] == nxt[live, None]).any(dim=1).all()
        assert (nxt[~live] == BERT_PAD_ID).all()
        live &= nxt != BERT_SEP_ID
    recompute = tgen.generate(model, c, max_new_tokens=8, mode="sample",
                              top_k=5, generator=gen(1), use_cache=False)
    assert torch.equal(recompute, tokens)
    assert not torch.equal(
        tgen.generate(model, c, max_new_tokens=8, mode="sample", top_k=5,
                      generator=gen(2)), tokens)
    greedy = tgen.generate(model, c, max_new_tokens=8, mode="greedy")
    assert torch.equal(tgen.generate(model, c, max_new_tokens=8,
                                     mode="sample", top_k=1), greedy)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = torch.tensor([[1.0, 3.0, -1e7, 3.0, -1e7, -1e7, 2.0]])
    vals, idx = tgen._top_k(x, 5)
    assert idx.tolist() == [[1, 3, 6, 0, 2]]
    _, want = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(want).tolist()


def test_slice_end_to_end():
    """Pixels → the port's MiCo (vision tower, condition) → beam caption,
    against the same flow through the JAX package: same tokens."""
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, seed=1)
    model = port_model(params, tcfg)
    px = np.random.default_rng(5).standard_normal(
        (2, 2, 3, 28, 28)).astype(np.float32)
    jcond = jm.get_multimodal_forward_input_vision(
        params, jcfg, jm.forward_vision_encoder(params, jcfg, jnp.asarray(px)))
    cond = model.get_multimodal_forward_input_vision(
        model.forward_vision_encoder(t(px)))
    close(cond, jcond, MODEL_TOL)
    want = jgen.generate(params["bert"], jcfg.bert_config, jcond,
                         max_new_tokens=6, mode="beam", num_beams=3,
                         length_penalty=0.6)
    got = tgen.generate(model.bert, cond, max_new_tokens=6, mode="beam",
                        num_beams=3, length_penalty=0.6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
