"""Caption and QA generation for the BERT interface branch (counterpart of
`mico_tpu/generation.py`, with its names).

The reference decodes by appending a [MASK] probe each step and growing a
3D attention mask whose new row copies the previous one (model/bert.py:
1110-1143). That mask is causal, so the decode runs over one fixed-length
token buffer with a lower-triangular mask, writing token t at slot t+1 and
reading the logits at the [MASK] slot. Modes: greedy, top-k sampling (the
VAST captioner's), full-softmax sampling (`scst`, the SCST rule) and beam
search with HF's length penalty (score = logp_sum / len**penalty).

Two paths give the same tokens:
  - recompute (`use_cache=False`): the whole buffer goes through
    `bert_encoder` every step (`_decode_logits`); its cross-attention over
    the 257·n condition tokens takes kernel K2 once Lq·Lk > 64·64.
  - KV-cached (the default): each layer's cross K/V are projected once, and
    each step runs the decoder over two positions, the committed token
    (which writes the self K/V caches in place) and the [MASK] probe (which
    writes the caches' last, preallocated slot). Beam search keeps the
    caches append-only per physical row and masks self-attention by each
    beam's ancestry instead of regathering them. With `int8_cross_kv=True`
    the cross K/V are stored as int8 with per-(row, head) fp32 scales and
    every step's cross-attention takes kernel K7 (`ops/int8_attention.py`);
    otherwise it is plain torch, as it is plain XLA in JAX.

The step loop is a Python loop over a fixed number of steps (JAX's scan
always runs `max_new_tokens` steps), with no host synchronisation inside.
Top-k selections break ties toward the lower index, as `jax.lax.top_k`
does. Sampling draws from a `torch.Generator`, whose stream is not JAX's.

`generate_scst` (generation.py:931-977) is differentiable: it returns each
sampled token's fp32 log-probability, zeroed after [SEP], with its
gradient, on either path. When autograd records the decode (grad mode on
and the condition or a decoder parameter requiring a gradient, decided
once a call) the cached path writes its self K/V caches out of place
(`index_copy`), so that autograd keeps every step's caches; otherwise they
are written in place as before, with the same values. `teacher_tokens`
commits given tokens in place of drawn ones (to score a trajectory again,
as the SCST update does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mico_tpu_torch.config import (
    BERT_CLS_ID,
    BERT_MASK_ID,
    BERT_PAD_ID,
    BERT_SEP_ID,
    BertConfig,
)
from mico_tpu_torch.models.bert import (
    Bert,
    bert_embeddings,
    bert_encoder,
    extended_attention_mask,
    mlm_logits,
)
from mico_tpu_torch.ops.int8_attention import int8_cross_attention, quantize_kv
from mico_tpu_torch.ops.layers import (gelu, layer_norm, linear, matmul_f32,
                                      records_grad)
from mico_tpu_torch.parallel.tensor_parallel import row_parallel_linear

NEG_INF = -1.0e7
MODES = ("greedy", "sample", "beam", "scst")

# Store the per-layer cross K/V split per head, (B, nh, Lk, hd) contiguous,
# so each (batch, head) panel is read in one run instead of strided across
# the packed (B, Lk, nh·hd) rows. A pure transpose: tokens are identical.
# The int8 route keeps the packed layout K7 reads.
CROSS_KV_SPLIT_HEADS = False


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties toward the lower index (the
    order of `jax.lax.top_k`; `torch.topk` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gumbel_argmax(x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """A draw from softmax(x) over the last axis by the Gumbel-max rule, as
    `jax.random.categorical` draws."""
    u = torch.rand(x.shape, generator=generator, device=x.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(x + gumbel, dim=-1)


def _next_token(logits: torch.Tensor, mode: str, top_k: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax (first maximum), a draw from the whole softmax
    (`scst`, generation.py:545-548), or a draw from the top-k logits."""
    if mode == "greedy":
        return torch.argmax(logits, dim=-1)
    if mode == "scst":
        return _gumbel_argmax(logits.detach(), generator)
    vals, idx = _top_k(logits, top_k)
    choice = _gumbel_argmax(vals, generator)
    return idx.gather(-1, choice[:, None])[:, 0]


def _token_logp(logits: torch.Tensor, nxt: torch.Tensor,
                finished: torch.Tensor) -> torch.Tensor:
    """log softmax(logits)[nxt] in fp32, 0 where the row had finished
    (generation.py:550-553)."""
    logp = torch.log_softmax(logits.float(), dim=-1).gather(
        1, nxt[:, None])[:, 0]
    return torch.where(finished, 0.0, logp)


def _choose(logits, t: int, mode: str, top_k: int, generator,
            teacher_tokens: Optional[torch.Tensor]) -> torch.Tensor:
    """Step t's token: teacher_tokens[:, t] when given, else drawn."""
    if teacher_tokens is not None:
        return teacher_tokens[:, t].to(logits.device, torch.long)
    return _next_token(logits, mode, top_k, generator)



def _length_penalty(n: int, penalty: float, device) -> torch.Tensor:
    """n ** penalty in fp32 as a device scalar (a tensor divisor, so the
    division is a true fp32 division on every device). Made by a fill, not
    a host-to-device copy, which would synchronise the step loop."""
    pen = np.power(np.float32(n), np.float32(penalty), dtype=np.float32)
    return torch.full((), float(pen), dtype=torch.float32, device=device)


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, L, nh·hd) → (B, nh, L, hd) view."""
    b, l, h = x.shape
    return x.reshape(b, l, nh, h // nh).transpose(1, 2)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    b, nh, l, hd = o.shape
    return o.transpose(1, 2).reshape(b, l, nh * hd)


def _softmax_pv(s: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """fp32 softmax, probabilities rounded to v's dtype, PV in v's dtype
    with fp32 accumulation (one rounding), as the JAX einsum."""
    p = torch.softmax(s, dim=-1).to(vh.dtype)
    return torch.matmul(p, vh)


# ---------------------------------------------------------------------------
# recompute path
# ---------------------------------------------------------------------------


def _part_causal_mask(l: int, prefix_mask: Optional[torch.Tensor],
                      device=None) -> torch.Tensor:
    """(B|1, L, L) mask: with no prefix, lower-triangular. With a prefix of
    length Lq (prefix_mask's width): prefix rows attend the valid prefix
    bidirectionally and never the generated part; generated rows attend the
    valid prefix plus themselves causally (the reference's part-causal QA
    mask, data/model/vast.py:595-600, extended stepwise)."""
    if prefix_mask is not None:
        device = prefix_mask.device
    causal = torch.tril(torch.ones((1, l, l), device=device))
    if prefix_mask is None:
        return causal
    lq = prefix_mask.shape[1]
    col = torch.arange(l, device=device)[None, None, :]
    row = torch.arange(l, device=device)[None, :, None]
    prefix_cols = F.pad(prefix_mask.float(), (0, l - lq))[:, None, :]
    in_prefix_col = (col < lq).float()
    gen_row = (row >= lq).float()
    return prefix_cols * in_prefix_col + gen_row * causal * (1.0 - in_prefix_col)


def _decode_logits(model: Bert, tokens: torch.Tensor, slot: int,
                   cond: torch.Tensor, cond_bias: Optional[torch.Tensor],
                   compute_dtype: torch.dtype,
                   prefix_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decoder pass over tokens (B, L) with [MASK] at `slot`; fp32
    logits (B, V) at the slot. The attention goes through 'flash', so the
    cross-attention takes K2 once Lq·Lk > 64·64 (JAX's 'auto' on a TPU)."""
    l = tokens.shape[1]
    self_bias = extended_attention_mask(
        _part_causal_mask(l, prefix_mask, tokens.device))
    hidden = bert_embeddings(model.embeddings, model.cfg, tokens,
                             compute_dtype=compute_dtype)
    seq = bert_encoder(model, hidden, self_bias, cond, cond_bias,
                       attn_impl="flash")
    return mlm_logits(model, seq[:, slot:slot + 1])[:, 0].float()


def _records_grad(model: Bert, cond: torch.Tensor) -> bool:
    """Whether autograd records a decode: grad mode is on and the condition
    or a decoder parameter requires a gradient. Decided once a call: the
    step functions take it as an argument."""
    return records_grad(cond, *model.parameters())


def _sequential_generate(model: Bert, cond, max_new: int, mode: str,
                         top_k: int, generator, compute_dtype,
                         prefix_ids=None, prefix_mask=None,
                         teacher_tokens: Optional[torch.Tensor] = None,
                         return_logp: bool = False):
    """The recompute loop; with return_logp also each step's token logp
    (B, max_new), differentiable (the recompute `generate_scst`)."""
    b, dev = cond.shape[0], cond.device
    lq = 0 if prefix_ids is None else prefix_ids.shape[1]
    l = lq + max_new + 2               # [prefix] [CLS] + max_new + [MASK] slot
    tokens = torch.full((b, l), BERT_PAD_ID, dtype=torch.long, device=dev)
    if prefix_ids is not None:
        tokens[:, :lq] = prefix_ids
    tokens[:, lq] = BERT_CLS_ID
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    record = _records_grad(model, cond)
    logps = []
    for t in range(max_new):
        slot = lq + t + 1
        # slots past `slot` are never attended (causal), so the probe is
        # written into the buffer itself and overwritten by the token
        tokens[:, slot] = BERT_MASK_ID
        # a recorded embedding saves its ids: give it its own copy
        ids = tokens.clone() if record else tokens
        logits = _decode_logits(model, ids, slot, cond, None,
                                compute_dtype, prefix_mask=prefix_mask)
        nxt = _choose(logits, t, mode, top_k, generator, teacher_tokens)
        if return_logp:
            logps.append(_token_logp(logits, nxt, finished))
        nxt = torch.where(finished, BERT_PAD_ID, nxt)
        tokens[:, slot] = nxt
        finished = finished | (nxt == BERT_SEP_ID)   # a where saved it
    out = tokens[:, lq:lq + max_new + 1]
    return (out, torch.stack(logps, dim=1)) if return_logp else out


def _beam_step(logits: torch.Tensor, k: int, slot: int, length: int,
               length_penalty: float, tokens, live_scores, fin_tokens,
               fin_scores):
    """One beam update from fp32 logits (b·k, V), shared by both paths;
    the chosen tokens go to `slot` of the (b, k, L) buffers, and `length`
    is the sequence length the penalty sees.

    The 2k best (beam, token) candidates guarantee k non-EOS survivors. HF
    BeamSearchScorer.process semantics (the stack the reference's generate
    rides, model/bert.py:1126-1143): an EOS candidate is finalised only
    from the top `num_beams` ranks, keeps its EOS, and its length penalty
    runs over the full length, any question prefix and [CLS] included.
    Returns the new (tokens, live_scores, fin_tokens, fin_scores), then
    the live beams' new tokens and their parent beams."""
    b, _, L = tokens.shape
    v = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1).reshape(b, k, v)
    cand = live_scores[:, :, None] + logp
    top_scores, top_idx = _top_k(cand.reshape(b, k * v), 2 * k)
    beam_idx = top_idx // v
    tok_idx = top_idx % v
    is_eos = tok_idx == BERT_SEP_ID
    new_tokens = tokens.gather(1, beam_idx[:, :, None].expand(b, 2 * k, L))
    new_tokens[:, :, slot] = tok_idx
    rank_ok = torch.arange(2 * k, device=logits.device)[None, :] < k
    pen = _length_penalty(length, length_penalty, logits.device)
    eos_scores = torch.where(is_eos & rank_ok, top_scores / pen, NEG_INF)
    all_fin_scores = torch.cat([fin_scores, eos_scores], dim=1)
    all_fin_tokens = torch.cat([fin_tokens, new_tokens], dim=1)
    fin_scores, fin_keep = _top_k(all_fin_scores, k)
    fin_tokens = all_fin_tokens.gather(1, fin_keep[:, :, None].expand(b, k, L))
    live_cand = torch.where(is_eos, NEG_INF, top_scores)
    live_scores, live_keep = _top_k(live_cand, k)
    tokens = new_tokens.gather(1, live_keep[:, :, None].expand(b, k, L))
    committed = tok_idx.gather(1, live_keep)
    parent = beam_idx.gather(1, live_keep)
    return tokens, live_scores, fin_tokens, fin_scores, committed, parent


def _beam_finalize(lq: int, max_new: int, length_penalty: float, tokens,
                   live_scores, fin_tokens, fin_scores) -> torch.Tensor:
    """Close out the still-live beams at full length (HF finalize) and take
    the best hypothesis of each row."""
    pen = _length_penalty(lq + max_new + 1, length_penalty, tokens.device)
    all_scores = torch.cat([fin_scores, live_scores / pen], dim=1)
    all_tokens = torch.cat([fin_tokens, tokens], dim=1)
    best = torch.argmax(all_scores, dim=1)
    b, _, L = all_tokens.shape
    return all_tokens.gather(1, best[:, None, None].expand(b, 1, L))[:, 0]


def _beam_init(b: int, k: int, L: int, dev):
    tokens = torch.full((b, k, L), BERT_PAD_ID, dtype=torch.long, device=dev)
    live_scores = torch.full((b, k), NEG_INF, device=dev)
    live_scores[:, 0] = 0.0
    fin_scores = torch.full((b, k), NEG_INF, device=dev)
    return tokens, live_scores, fin_scores


def _beam_generate(model: Bert, cond, max_new: int, k: int,
                   length_penalty: float, compute_dtype, prefix_ids=None,
                   prefix_mask=None) -> torch.Tensor:
    b, dev = cond.shape[0], cond.device
    lq = 0 if prefix_ids is None else prefix_ids.shape[1]
    l = lq + max_new + 2
    tokens, live_scores, fin_scores = _beam_init(b, k, l, dev)
    if prefix_ids is not None:
        tokens[:, :, :lq] = prefix_ids[:, None, :]
    tokens[:, :, lq] = BERT_CLS_ID
    fin_tokens = tokens.clone()
    cond_rep = cond.repeat_interleave(k, dim=0)          # (b·k, Lk, H)
    prefix_mask_rep = (None if prefix_mask is None
                       else prefix_mask.repeat_interleave(k, dim=0))
    for t in range(max_new):
        slot = lq + t + 1
        probe = tokens.clone()
        probe[:, :, slot] = BERT_MASK_ID
        logits = _decode_logits(model, probe.reshape(b * k, l), slot,
                                cond_rep, None, compute_dtype,
                                prefix_mask=prefix_mask_rep)
        tokens, live_scores, fin_tokens, fin_scores, _, _ = _beam_step(
            logits, k, slot, slot, length_penalty, tokens, live_scores,
            fin_tokens, fin_scores)
    out = _beam_finalize(lq, max_new, length_penalty, tokens, live_scores,
                         fin_tokens, fin_scores)
    return out[:, lq:lq + max_new + 1]


# ---------------------------------------------------------------------------
# KV-cached incremental decoding
# ---------------------------------------------------------------------------
#
# The recompute path re-encodes the whole buffer every step. The cached path
# projects the cross K/V once from the condition, keeps per-layer self K/V
# caches that each step writes in place, and runs the decoder over exactly
# two positions per step: the newly committed token and the [MASK] probe,
# whose K/V go to the caches' last slot (its own slot will hold the real
# token next step). Same tokens as the recompute path.


def _mha(q, k, v, bias, cfg: BertConfig) -> torch.Tensor:
    """Plain MHA of (B, Lq, H) over (B, Lk, H) with an additive fp32 bias;
    H the width of the heads given (all, or a tensor-parallel rank's)."""
    hd = cfg.head_dim
    nh = q.shape[-1] // hd
    kt = _heads(k, nh).transpose(-1, -2)
    s = matmul_f32(_heads(q, nh), kt) * hd ** -0.5
    if bias is not None:
        s = s + bias
    return _merge_heads(_softmax_pv(s, _heads(v, nh)))


def _cross_mha(q, k, v, cfg: BertConfig) -> torch.Tensor:
    """Plain MHA (no bias) of (B, Lq, H) over cross K/V stored packed
    (B, Lk, H) or split per head (B, nh, Lk, hd), see CROSS_KV_SPLIT_HEADS;
    the same math either way."""
    hd = cfg.head_dim
    nh = q.shape[-1] // hd
    kh, vh = (k, v) if k.dim() == 4 else (_heads(k, nh), _heads(v, nh))
    s = matmul_f32(_heads(q, nh), kh.transpose(-1, -2)) * hd ** -0.5
    return _merge_heads(_softmax_pv(s, vh))


def _group_mha(q, k, v, bias, cfg: BertConfig, n_rep: int) -> torch.Tensor:
    """Beam self-attention without a cache regather: the (bg, kq, 2) queries
    against the (bg, kc, S) cache rows of their group, softmax over the
    flattened (kc, S) axis, and the ancestry bias (bg, kq, 2, kc, S) keeping
    each query's own lineage."""
    b, _, h = q.shape
    hd = cfg.head_dim
    nh = h // hd
    bg, S = b // n_rep, k.shape[1]
    qh = _heads(q.reshape(bg, n_rep * 2, h), nh)       # (bg, nh, kq·2, hd)
    kh = _heads(k.reshape(bg, n_rep * S, h), nh)       # (bg, nh, kc·S, hd)
    vh = _heads(v.reshape(bg, n_rep * S, h), nh)
    s = matmul_f32(qh, kh.transpose(-1, -2)) * hd ** -0.5
    s = s + bias.reshape(bg, 1, n_rep * 2, n_rep * S)
    return _merge_heads(_softmax_pv(s, vh)).reshape(b, 2, h)


def _cached_layer_step(x, lp, ck, cv, xk, xv, t: int, cfg: BertConfig,
                       self_bias, n_rep: int = 1, group_bias=None,
                       record: bool = False):
    """One decoder layer over the (B, 2, H) [committed, probe] pair.

    ck/cv: (B, S, H) self K/V caches: the committed K/V go to slot t, the
    probe's to the last slot S-1, in place, or into new tensors
    (`index_copy`) when autograd records the decode (`record`). xk/xv:
    (B/n_rep, Lk, H) cross K/V (or split per head), or an (int8, scales)
    pair each, which routes the cross-attention to K7. With n_rep > 1
    (beam search) the cross K/V stay per batch element and the beams fold
    into the query rows, so the condition projections are never
    replicated per beam;
    group_bias (B/n_rep, kq, 2, kc, S) then routes self-attention through
    the ancestry-masked in-group product. Returns (x, ck, cv)."""
    b, _, h = x.shape
    q = linear(x, lp.get("q_w"), lp.get("q_b"))
    k_new = linear(x, lp.get("k_w"), lp.get("k_b"))
    v_new = linear(x, lp.get("v_w"), lp.get("v_b"))
    if record:
        # a later in-place write would change a tensor an earlier step
        # saved for the backward
        slots = torch.tensor([t, ck.shape[1] - 1], device=x.device)
        ck = ck.index_copy(1, slots, k_new)
        cv = cv.index_copy(1, slots, v_new)
    else:
        ck[:, t] = k_new[:, 0]
        cv[:, t] = v_new[:, 0]
        ck[:, -1] = k_new[:, 1]
        cv[:, -1] = v_new[:, 1]
    if group_bias is not None:
        o = _group_mha(q, ck, cv, group_bias, cfg, n_rep)
    else:
        o = _mha(q, ck, cv, self_bias, cfg)
    x = layer_norm(x + _row(lp, o, "attn_out"), lp.get("attn_ln_w"),
                   lp.get("attn_ln_b"), cfg.layer_norm_eps)

    def cross(q2):
        if isinstance(xk, tuple):
            return int8_cross_attention(q2, xk[0], xk[1], xv[0], xv[1],
                                        lp.local_heads(cfg))
        return _cross_mha(q2, xk, xv, cfg)

    xq = linear(x, lp.get("xq_w"), lp.get("xq_b"))
    if n_rep > 1:
        lq, hq = xq.shape[1], xq.shape[2]
        o = cross(xq.reshape(b // n_rep, n_rep * lq, hq)).reshape(b, lq, hq)
    else:
        o = cross(xq)
    x = layer_norm(x + _row(lp, o, "x_out"), lp.get("x_ln_w"),
                   lp.get("x_ln_b"), cfg.layer_norm_eps)
    y = gelu(linear(x, lp.get("inter_w"), lp.get("inter_b")))
    x = layer_norm(x + _row(lp, y, "out"), lp.get("out_ln_w"),
                   lp.get("out_ln_b"), cfg.layer_norm_eps)
    return x, ck, cv


def _row(lp, y: torch.Tensor, stem: str) -> torch.Tensor:
    """A row-parallel output linear of the layer (summed over the model
    group under tensor parallelism)."""
    return row_parallel_linear(y, lp.get(f"{stem}_w"), lp.get(f"{stem}_b"),
                               lp.tp)


def _local_width(model: Bert) -> int:
    """The width of the heads a layer computes (a self K/V cache's): all,
    or this tensor-parallel rank's."""
    return model.layers[0].local_heads(model.cfg) * model.cfg.head_dim


def _cross_kv(model: Bert, cond: torch.Tensor):
    """Every layer's cross K and V of the condition, projected once:
    tuples of per-layer (B, Lk, H)."""
    xk = tuple(linear(cond, lp.get("xk_w"), lp.get("xk_b"))
               for lp in model.layers)
    xv = tuple(linear(cond, lp.get("xv_w"), lp.get("xv_b"))
               for lp in model.layers)
    return xk, xv


def _unrolled_layers(x, model: Bert, ck, cv, xk, xv, t: int, cfg, bias,
                     n_rep: int = 1, group_bias=None,
                     record: bool = False) -> torch.Tensor:
    """The decoder stack for one cached step over the lists of per-layer
    caches and cross K/V; each list entry takes the layer's updated cache."""
    for l, lp in enumerate(model.layers):
        x, ck[l], cv[l] = _cached_layer_step(
            x, lp, ck[l], cv[l], xk[l], xv[l], t, cfg, bias, n_rep,
            group_bias=group_bias, record=record)
    return x


def _maybe_split_heads(x_tuple, cfg: BertConfig, enable: bool):
    """Per-layer (B, Lk, H) → contiguous (B, nh, Lk, hd), made once before
    the step loop."""
    if not enable:
        return x_tuple
    return tuple(_heads(a, a.shape[-1] // cfg.head_dim).contiguous()
                 for a in x_tuple)


def _maybe_quantize_cross(xk, xv, cfg: BertConfig, enable: bool):
    """Optionally int8-quantise the per-layer cross K/V: each layer's entry
    becomes an (int8 values, fp32 scales) pair that `_cached_layer_step`
    routes to K7."""
    if not enable:
        return xk, xv
    return (tuple(quantize_kv(k, k.shape[-1] // cfg.head_dim) for k in xk),
            tuple(quantize_kv(v, v.shape[-1] // cfg.head_dim) for v in xv))


def _empty_caches(n: int, rows: int, slots: int, h: int, dtype, dev):
    return [torch.zeros((rows, slots, h), dtype=dtype, device=dev)
            for _ in range(n)]


def _pair_positions(b: int, first: int, dev) -> torch.Tensor:
    """(b, 2) position ids of the [committed, probe] pair."""
    return (torch.arange(2, device=dev) + first).expand(b, 2)


def cached_generate(model: Bert, condition_feat: torch.Tensor, *,
                    max_new_tokens: int = 40, mode: str = "greedy",
                    top_k: int = 10,
                    generator: Optional[torch.Generator] = None,
                    compute_dtype: torch.dtype = torch.float32,
                    int8_cross_kv: bool = False,
                    teacher_tokens: Optional[torch.Tensor] = None,
                    return_logits: bool = False, return_logp: bool = False):
    """KV-cached greedy, top-k or full-softmax (`scst`) sampling decode, the
    same tokens as `generate(mode=..., use_cache=False)` at two positions
    per step. → (B, max_new_tokens + 1) starting with [CLS].

    teacher_tokens (B, max_new_tokens) are committed at each step in place
    of the chosen ones (teacher forcing, to score a given caption).
    return_logits=True also returns each step's fp32 logits
    (B, max_new_tokens, V), and return_logp=True each step's token logp
    (B, max_new_tokens), zeroed after [SEP] and differentiable (the cached
    `generate_scst`), in that order after the tokens."""
    if mode not in ("greedy", "sample", "scst"):
        raise ValueError(
            f"cached_generate mode {mode!r}: greedy, sample or scst")
    cfg = model.cfg
    b, dev = condition_feat.shape[0], condition_feat.device
    h, lmax = _local_width(model), max_new_tokens + 1
    n_layers = cfg.num_hidden_layers

    cond = condition_feat.to(compute_dtype)
    record = _records_grad(model, cond)
    xk, xv = _cross_kv(model, cond)
    # a recorded decode always takes the per-head layout: the PV product of
    # the packed layout would save a contiguous copy of V every step
    split = (CROSS_KV_SPLIT_HEADS or record) and not int8_cross_kv
    xk = _maybe_split_heads(xk, cfg, split)
    xv = _maybe_split_heads(xv, cfg, split)
    xk, xv = _maybe_quantize_cross(xk, xv, cfg, int8_cross_kv)

    # lmax committed slots + the preallocated probe slot at index lmax
    ck = _empty_caches(n_layers, b, lmax + 1, h, compute_dtype, dev)
    cv = _empty_caches(n_layers, b, lmax + 1, h, compute_dtype, dev)
    tokens = torch.full((b, lmax), BERT_PAD_ID, dtype=torch.long, device=dev)
    tokens[:, 0] = BERT_CLS_ID
    committed = tokens[:, 0].clone()
    probe_ids = torch.full_like(committed, BERT_MASK_ID)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    cols = torch.arange(lmax + 1, device=dev)
    logits_all, logps = [], []
    for t in range(max_new_tokens):
        ids = torch.stack([committed, probe_ids], dim=1)
        x = bert_embeddings(model.embeddings, cfg, ids,
                            position_ids=_pair_positions(b, t, dev),
                            compute_dtype=compute_dtype)
        # additive bias (1, 1, 2, lmax+1): the committed row sees cache ≤ t,
        # the probe row cache ≤ t plus its own slot (index lmax)
        row_c = torch.where(cols <= t, 0.0, NEG_INF)
        row_p = torch.where((cols <= t) | (cols == lmax), 0.0, NEG_INF)
        bias = torch.stack([row_c, row_p])[None, None]
        x = _unrolled_layers(x, model, ck, cv, xk, xv, t, cfg, bias,
                             record=record)
        logits = mlm_logits(model, x[:, 1:2])[:, 0].float()
        if return_logits:
            logits_all.append(logits)
        nxt = _choose(logits, t, mode, top_k, generator, teacher_tokens)
        if return_logp:
            logps.append(_token_logp(logits, nxt, finished))
        nxt = torch.where(finished, BERT_PAD_ID, nxt)
        tokens[:, t + 1] = nxt
        finished = finished | (nxt == BERT_SEP_ID)   # a where saved it
        committed = nxt
    outs = ([tokens] + [torch.stack(x, dim=1) for x, want in (
        (logits_all, return_logits), (logps, return_logp)) if want])
    return outs[0] if len(outs) == 1 else tuple(outs)


def _prefill_prefix(model: Bert, prefix_ids, prefix_mask, cond,
                    total_len: int, compute_dtype, split_heads: bool = False):
    """Encode the question prefix once (bidirectional over the valid prefix,
    with cross-attention: the prefix rows of the recompute part-causal
    decode) and keep each layer's self K/V in caches of `total_len` slots.
    Returns (ck, cv, xk, xv) per layer."""
    cfg = model.cfg
    b, lq = prefix_ids.shape
    self_bias = extended_attention_mask(prefix_mask)
    x = bert_embeddings(model.embeddings, cfg, prefix_ids,
                        compute_dtype=compute_dtype)
    xk, xv = _cross_kv(model, cond)
    xk = _maybe_split_heads(xk, cfg, split_heads)
    xv = _maybe_split_heads(xv, cfg, split_heads)
    ck, cv = [], []
    for l, lp in enumerate(model.layers):
        k = linear(x, lp.get("k_w"), lp.get("k_b"))
        v = linear(x, lp.get("v_w"), lp.get("v_b"))
        q = linear(x, lp.get("q_w"), lp.get("q_b"))
        o = _mha(q, k, v, self_bias, cfg)
        x = layer_norm(x + _row(lp, o, "attn_out"), lp.get("attn_ln_w"),
                       lp.get("attn_ln_b"), cfg.layer_norm_eps)
        xq = linear(x, lp.get("xq_w"), lp.get("xq_b"))
        o = _cross_mha(xq, xk[l], xv[l], cfg)
        x = layer_norm(x + _row(lp, o, "x_out"), lp.get("x_ln_w"),
                       lp.get("x_ln_b"), cfg.layer_norm_eps)
        y = gelu(linear(x, lp.get("inter_w"), lp.get("inter_b")))
        x = layer_norm(x + _row(lp, y, "out"), lp.get("out_ln_w"),
                       lp.get("out_ln_b"), cfg.layer_norm_eps)
        for cache, new in ((ck, k), (cv, v)):
            c = torch.zeros((b, total_len, new.shape[-1]), dtype=new.dtype,
                            device=new.device)
            c[:, :lq] = new
            cache.append(c)
    return ck, cv, xk, xv


def cached_generate_answers(model: Bert, question_ids, question_mask,
                            condition_feat, *, max_new_tokens: int = 10,
                            mode: str = "greedy", top_k: int = 10,
                            generator: Optional[torch.Generator] = None,
                            compute_dtype: torch.dtype = torch.float32,
                            int8_cross_kv: bool = False) -> torch.Tensor:
    """KV-cached part-causal QA decode, the same tokens as
    `generate_answers(mode=greedy|sample, use_cache=False)`: the question
    prefix is encoded once into the caches. → (B, max_new_tokens + 1)."""
    if mode not in ("greedy", "sample"):
        raise ValueError(f"cached_generate_answers mode {mode!r}")
    cfg = model.cfg
    b, lq = question_ids.shape
    dev = condition_feat.device
    lmax = max_new_tokens + 1
    total = lq + lmax
    cond = condition_feat.to(compute_dtype)
    # total committed slots + the preallocated probe slot at index `total`
    ck, cv, xk, xv = _prefill_prefix(
        model, question_ids, question_mask, cond, total + 1, compute_dtype,
        split_heads=CROSS_KV_SPLIT_HEADS and not int8_cross_kv)
    xk, xv = _maybe_quantize_cross(xk, xv, cfg, int8_cross_kv)

    tokens = torch.full((b, lmax), BERT_PAD_ID, dtype=torch.long, device=dev)
    tokens[:, 0] = BERT_CLS_ID
    committed = tokens[:, 0].clone()
    probe_ids = torch.full_like(committed, BERT_MASK_ID)
    finished = torch.zeros(b, dtype=torch.bool, device=dev)
    # per-row valid prefix columns of the additive bias
    prefix_cols = F.pad(question_mask.float(), (0, total + 1 - lq))
    cols = torch.arange(total + 1, device=dev)
    for t in range(max_new_tokens):
        ids = torch.stack([committed, probe_ids], dim=1)
        x = bert_embeddings(model.embeddings, cfg, ids,
                            position_ids=_pair_positions(b, lq + t, dev),
                            compute_dtype=compute_dtype)
        gen_c = ((cols >= lq) & (cols <= lq + t)).float()
        allow_c = torch.maximum(prefix_cols, gen_c[None])
        allow_p = torch.maximum(allow_c, (cols == total).float()[None])
        bias = ((1.0 - torch.stack([allow_c, allow_p], dim=1))
                * NEG_INF)[:, None]                      # (b, 1, 2, total+1)
        x = _unrolled_layers(x, model, ck, cv, xk, xv, lq + t, cfg, bias)
        logits = mlm_logits(model, x[:, 1:2])[:, 0].float()
        nxt = _next_token(logits, mode, top_k, generator)
        nxt = torch.where(finished, BERT_PAD_ID, nxt)
        tokens[:, t + 1] = nxt
        finished |= nxt == BERT_SEP_ID
        committed = nxt
    return tokens


def cached_beam_generate(model: Bert, condition_feat: torch.Tensor, *,
                         max_new_tokens: int = 40, num_beams: int = 3,
                         length_penalty: float = 0.6,
                         compute_dtype: torch.dtype = torch.float32,
                         prefix_ids: Optional[torch.Tensor] = None,
                         prefix_mask: Optional[torch.Tensor] = None,
                         int8_cross_kv: bool = False) -> torch.Tensor:
    """KV-cached beam search, the same tokens as the recompute
    `_beam_generate`: beams live as (B·k) cache rows; with prefix_ids /
    prefix_mask (QA) the question is prefilled once and replicated per beam.

    Beam reordering is ancestry-masked, not physical: each live beam writes
    its new token's K/V into its own cache row, and a (B, k, S) table
    records which row holds each position of each beam's lineage.
    Self-attention runs every query beam against every cache row of its
    sample and the ancestry bias keeps exactly the lineage positions, the
    same math as regathering the caches by parent each step, with no cache
    movement."""
    cfg = model.cfg
    b, dev = condition_feat.shape[0], condition_feat.device
    k = num_beams
    h = _local_width(model)
    lq = 0 if prefix_ids is None else prefix_ids.shape[1]
    lmax = max_new_tokens + 1
    total = lq + lmax
    n_layers = cfg.num_hidden_layers
    bk = b * k

    cond = condition_feat.to(compute_dtype)
    split = CROSS_KV_SPLIT_HEADS and not int8_cross_kv
    if prefix_ids is not None:
        # total committed slots + the preallocated probe slot
        ck, cv, xk, xv = _prefill_prefix(
            model, prefix_ids, prefix_mask, cond, total + 1, compute_dtype,
            split_heads=split)
        ck = [c.repeat_interleave(k, dim=0) for c in ck]
        cv = [c.repeat_interleave(k, dim=0) for c in cv]
        pfx_cols = F.pad(prefix_mask.float(), (0, total + 1 - lq))
    else:
        # cross K/V stay per batch element; the beams fold into query rows
        xk, xv = _cross_kv(model, cond)
        xk = _maybe_split_heads(xk, cfg, split)
        xv = _maybe_split_heads(xv, cfg, split)
        ck = _empty_caches(n_layers, bk, total + 1, h, compute_dtype, dev)
        cv = _empty_caches(n_layers, bk, total + 1, h, compute_dtype, dev)
        pfx_cols = None
    xk, xv = _maybe_quantize_cross(xk, xv, cfg, int8_cross_kv)

    # ancestry[b, j, s]: the cache row (within the sample's k-group) holding
    # beam j's position-s K/V; every beam starts as its own ancestor ([CLS]
    # and any replicated prefix live in each beam's own row)
    beam_iota = torch.arange(k, device=dev)[None, :, None].expand(
        b, k, total + 1)
    anc = beam_iota.clone()
    kc = torch.arange(k, device=dev)[None, None, :, None]
    tokens, live_scores, fin_scores = _beam_init(b, k, lmax, dev)
    tokens[:, :, 0] = BERT_CLS_ID
    fin_tokens = tokens.clone()
    committed = torch.full((b, k), BERT_CLS_ID, dtype=torch.long, device=dev)
    probe_ids = torch.full((bk,), BERT_MASK_ID, dtype=torch.long, device=dev)
    cols = torch.arange(total + 1, device=dev)
    probe_c = (cols == total).float()
    for t in range(max_new_tokens):
        ids = torch.stack([committed.reshape(bk), probe_ids], dim=1)
        x = bert_embeddings(model.embeddings, cfg, ids,
                            position_ids=_pair_positions(bk, lq + t, dev),
                            compute_dtype=compute_dtype)
        gen_c = ((cols >= lq) & (cols <= lq + t)).float()
        if pfx_cols is None:
            allow_c = gen_c[None, None].expand(b, k, total + 1)
            allow_p = torch.maximum(gen_c, probe_c)[None, None].expand(
                b, k, total + 1)
        else:
            ac = torch.maximum(pfx_cols, gen_c[None])         # (b, total+1)
            allow_c = ac[:, None].expand(b, k, total + 1)
            allow_p = torch.maximum(ac, probe_c[None])[:, None].expand(
                b, k, total + 1)
        # ancestry-masked in-group bias (b, kq, 2, kc, S): a column is
        # visible to query beam kq only in the cache row its lineage wrote
        anc_match = (anc[:, :, None, :] == kc).float()        # (b, kq, kc, S)
        colx = torch.stack([allow_c, allow_p], dim=2)        # (b, kq, 2, S)
        group_bias = (1.0 - colx[:, :, :, None, :]
                      * anc_match[:, :, None, :, :]) * NEG_INF
        x = _unrolled_layers(x, model, ck, cv, xk, xv, lq + t, cfg, None,
                             n_rep=k, group_bias=group_bias)
        logits = mlm_logits(model, x[:, 1:2])[:, 0].float()
        (tokens, live_scores, fin_tokens, fin_scores, committed,
         parent) = _beam_step(logits, k, t + 1, lq + t + 1, length_penalty,
                              tokens, live_scores, fin_tokens, fin_scores)
        # inherit the parent's ancestry row instead of moving the caches;
        # the next commit slot and the probe slot are always self-owned
        anc = anc.gather(1, parent[:, :, None].expand(b, k, total + 1))
        anc[:, :, lq + t + 1] = beam_iota[:, :, 0]
        anc[:, :, total] = beam_iota[:, :, 0]
    return _beam_finalize(lq, max_new_tokens, length_penalty, tokens,
                          live_scores, fin_tokens, fin_scores)


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------


def _prepare(model: Bert, condition_feat, compute_dtype, generator, mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    dev = next(model.parameters()).device
    cond = condition_feat.to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return cond, compute_dtype or cond.dtype, generator


@torch.no_grad()
def generate(model: Bert, condition_feat: torch.Tensor, *,
             max_new_tokens: int = 40, mode: str = "beam",
             num_beams: int = 3, top_k: int = 10,
             length_penalty: float = 0.6,
             generator: Optional[torch.Generator] = None,
             compute_dtype: Optional[torch.dtype] = None,
             use_cache: bool = True,
             int8_cross_kv: bool = False) -> torch.Tensor:
    """Caption tokens (B, max_new_tokens + 1) starting with [CLS], padded
    with [PAD] after [SEP], for the condition tokens (B, Lk, H) (e.g.
    `MiCo.get_multimodal_forward_input_vision`), on the device of `model`
    (the port's `Bert`). compute_dtype defaults to the condition's dtype.

    Every mode runs on the KV-cached path by default; use_cache=False runs
    the recompute loop (same tokens). int8_cross_kv applies to the cached
    path, whose cross-attention then takes K7. Sampling ('sample': top-k;
    'scst': the whole softmax) draws from `generator` (default: seeded 0 on
    the model's device)."""
    cond, compute_dtype, generator = _prepare(model, condition_feat,
                                              compute_dtype, generator, mode)
    if mode == "beam":
        if use_cache:
            return cached_beam_generate(
                model, cond, max_new_tokens=max_new_tokens,
                num_beams=num_beams, length_penalty=length_penalty,
                compute_dtype=compute_dtype, int8_cross_kv=int8_cross_kv)
        return _beam_generate(model, cond, max_new_tokens, num_beams,
                              length_penalty, compute_dtype)
    if use_cache:
        return cached_generate(
            model, cond, max_new_tokens=max_new_tokens, mode=mode,
            top_k=top_k, generator=generator, compute_dtype=compute_dtype,
            int8_cross_kv=int8_cross_kv)
    return _sequential_generate(model, cond, max_new_tokens, mode, top_k,
                                generator, compute_dtype)


@torch.no_grad()
def generate_answers(model: Bert, question_ids: torch.Tensor,
                     question_mask: torch.Tensor,
                     condition_feat: torch.Tensor, *,
                     max_new_tokens: int = 10, mode: str = "beam",
                     num_beams: int = 3, top_k: int = 10,
                     length_penalty: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     use_cache: bool = True,
                     int8_cross_kv: bool = False) -> torch.Tensor:
    """QA decoding: the padded question (B, Lq) is encoded bidirectionally
    and the answer decoded causally after a [CLS] (the reference's
    part-causal mask and generate flow, data/model/vast.py:617-650).
    → (B, max_new_tokens + 1) starting with [CLS]. The reference's QA
    generate passes no length penalty, so HF's default 1.0 applies."""
    cond, compute_dtype, generator = _prepare(model, condition_feat,
                                              compute_dtype, generator, mode)
    dev = cond.device
    question_ids = question_ids.to(dev, torch.long)
    question_mask = question_mask.to(dev)
    if mode == "beam":
        if use_cache:
            return cached_beam_generate(
                model, cond, max_new_tokens=max_new_tokens,
                num_beams=num_beams, length_penalty=length_penalty,
                compute_dtype=compute_dtype, prefix_ids=question_ids,
                prefix_mask=question_mask, int8_cross_kv=int8_cross_kv)
        return _beam_generate(model, cond, max_new_tokens, num_beams,
                              length_penalty, compute_dtype,
                              prefix_ids=question_ids,
                              prefix_mask=question_mask)
    if use_cache:
        return cached_generate_answers(
            model, question_ids, question_mask, cond,
            max_new_tokens=max_new_tokens, mode=mode, top_k=top_k,
            generator=generator, compute_dtype=compute_dtype,
            int8_cross_kv=int8_cross_kv)
    return _sequential_generate(model, cond, max_new_tokens, mode, top_k,
                                generator, compute_dtype,
                                prefix_ids=question_ids,
                                prefix_mask=question_mask)


def generate_scst(model: Bert, condition_feat: torch.Tensor, *,
                  max_new_tokens: int = 40,
                  generator: Optional[torch.Generator] = None,
                  compute_dtype: Optional[torch.dtype] = None,
                  use_cache: bool = False,
                  tokens: Optional[torch.Tensor] = None):
    """Self-critical (SCST) sampling (generation.py:931-977): a multinomial
    decode over the whole softmax that also returns the log-probability of
    each sampled token with its gradient. → (tokens (B, max_new_tokens + 1)
    starting with [CLS], logp (B, max_new_tokens) fp32, zeroed after
    [SEP]); only logp carries a gradient (the score-function estimator).
    Unlike `generate`, it is not wrapped in `no_grad`.

    use_cache=True takes the KV-cached path (the same tokens and logp);
    the recompute path's cross-attention takes K2 once Lq·Lk > 64·64.
    `tokens` (B, max_new_tokens + 1), a previous call's tokens, are
    committed instead of new draws: the same trajectory scored again."""
    cond, compute_dtype, generator = _prepare(model, condition_feat,
                                              compute_dtype, generator, "scst")
    teacher = None if tokens is None else tokens[:, 1:]
    if use_cache:
        return cached_generate(
            model, cond, max_new_tokens=max_new_tokens, mode="scst",
            generator=generator, compute_dtype=compute_dtype,
            teacher_tokens=teacher, return_logp=True)
    return _sequential_generate(model, cond, max_new_tokens, "scst", 0,
                                generator, compute_dtype,
                                teacher_tokens=teacher, return_logp=True)
