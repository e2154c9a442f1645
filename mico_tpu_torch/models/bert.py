"""BERT-base interface branch with cross-attention (counterpart of
`mico_tpu/models/bert.py`).

Embeddings (word + position + token type, LN eps 1e-12), then per layer:
self-attention → optional cross-attention over `encoder_hidden_states` →
FFN-GELU, each sublayer residual + LN. 2D padding masks stay bidirectional
and become additive (1 - m) * -10000. Layers are a ModuleList; attention
routes through `multi_head_attention`, so the cross-attention over the
257·n condition tokens takes kernel K2 (past 8192 tokens, a 32-frame video,
K6 and K6b when there are 128 query rows or more) and the 30-token
self-attention stays plain. `mlm_logits` is the MLM head the decoder (`generation.py`) reads its
next-token logits from.

Training (`train_rng`, a CPU `torch.Generator`): hidden dropout on the
embeddings after their LN, on each attention output and on the FFN output,
and attention-probability dropout, which takes the plain route
(bert.py:118-119, 139-168, 206-209); `labels` give `mlm_loss`, and `remat`
runs each layer under `torch.utils.checkpoint`. Each layer draws its masks
from a device generator seeded inside the layer from a per-layer seed, so a
recomputed layer draws the same masks.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mico_tpu_torch.config import BertConfig
from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.ops.attention import multi_head_attention
from mico_tpu_torch.parallel.collectives import all_reduce_sum, data_axis_size
from mico_tpu_torch.parallel.tensor_parallel import (SequenceShard,
                                                     copy_to_model,
                                                     row_parallel_linear,
                                                     seq_map)
from mico_tpu_torch.ops.layers import (
    draw_seeds,
    dropout,
    gelu,
    layer_norm,
    linear,
    seeded_generator,
)

MASK_VALUE = -10000.0


class BertOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    logits: Optional[torch.Tensor]
    sequence_output: torch.Tensor


class BertLayer(ParamGroup):
    """One layer; parameter names as in the JAX `layers/*` tree. Under
    tensor parallelism (`tp`, set by `parallel.tensor_parallel.
    shard_module`) it holds this rank's heads of q/k/v and xq/xk/xv and its
    columns of inter (column-parallel), and the matching rows of attn_out,
    x_out and out (row-parallel, summed over the model group before the
    residual); the LayerNorms stay whole on every rank."""

    tp = None

    def local_heads(self, cfg: BertConfig) -> int:
        """The heads this layer computes: all, or this rank's share."""
        return self.get("q_w").shape[1] // cfg.head_dim

    def __init__(self, cfg: BertConfig, init: Init):
        h, inter, enc = cfg.hidden_size, cfg.intermediate_size, cfg.encoder_width
        tensors = dict(
            q_w=init.normal((h, h)), q_b=init.zeros((h,)),
            k_w=init.normal((h, h)), k_b=init.zeros((h,)),
            v_w=init.normal((h, h)), v_b=init.zeros((h,)),
            attn_out_w=init.normal((h, h)), attn_out_b=init.zeros((h,)),
            attn_ln_w=init.ones((h,)), attn_ln_b=init.zeros((h,)),
            inter_w=init.normal((h, inter)), inter_b=init.zeros((inter,)),
            out_w=init.normal((inter, h)), out_b=init.zeros((h,)),
            out_ln_w=init.ones((h,)), out_ln_b=init.zeros((h,)),
        )
        if cfg.add_cross_attention:
            tensors.update(
                xq_w=init.normal((h, h)), xq_b=init.zeros((h,)),
                xk_w=init.normal((enc, h)), xk_b=init.zeros((h,)),
                xv_w=init.normal((enc, h)), xv_b=init.zeros((h,)),
                x_out_w=init.normal((h, h)), x_out_b=init.zeros((h,)),
                x_ln_w=init.ones((h,)), x_ln_b=init.zeros((h,)),
            )
        super().__init__(**tensors)


class Bert(nn.Module):
    """Parameter tree: embeddings/*, layers[i]/*, mlm_head/*."""

    def __init__(self, cfg: BertConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = ParamGroup(
            word=init.normal((cfg.vocab_size, h)),
            position=init.normal((cfg.max_position_embeddings, h)),
            token_type=init.normal((cfg.type_vocab_size, h)),
            ln_w=init.ones((h,)), ln_b=init.zeros((h,)),
        )
        self.layers = nn.ModuleList(
            [BertLayer(cfg, init) for _ in range(cfg.num_hidden_layers)]
        )
        self.mlm_head = ParamGroup(
            dense_w=init.normal((h, h)), dense_b=init.zeros((h,)),
            ln_w=init.ones((h,)), ln_b=init.zeros((h,)),
            decoder_w=init.normal((h, cfg.vocab_size)),
            decoder_b=init.zeros((cfg.vocab_size,)),
        )


def extended_attention_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """(b, L) or (b, Lq, Lk) 1/0 mask → additive (b, 1, Lq|1, Lk) fp32."""
    if attention_mask.dim() == 2:
        ext = attention_mask[:, None, None, :]
    elif attention_mask.dim() == 3:
        ext = attention_mask[:, None, :, :]
    else:
        raise ValueError(f"bad mask rank {attention_mask.dim()}")
    return (1.0 - ext.float()) * MASK_VALUE


def bert_embeddings(
    emb: ParamGroup,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    position_ids: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sum in the parameters' dtype and LN with fp32 statistics, then (in
    training, with a generator on the ids' device) hidden dropout, then the
    compute dtype (bert.py:99-120). token_type_ids=None adds row 0 of the
    table."""
    l = input_ids.shape[1]
    if position_ids is None:
        position_ids = torch.arange(l, device=input_ids.device)[None, :]
    x = emb.get("word")[input_ids.long()]
    x = x + emb.get("position")[position_ids.long()]
    if token_type_ids is None:
        x = x + emb.get("token_type")[0]
    else:
        x = x + emb.get("token_type")[token_type_ids.long()]
    x = layer_norm(x, emb.get("ln_w"), emb.get("ln_b"), cfg.layer_norm_eps)
    x = dropout(x, cfg.hidden_dropout_prob, generator)
    return x.to(compute_dtype)


def _attn_sublayer(
    x: torch.Tensor,
    kv: torch.Tensor,
    lp: BertLayer,
    cfg: BertConfig,
    bias: Optional[torch.Tensor],
    prefix: str,
    out_prefix: str,
    ln_prefix: str,
    attn_impl: str,
    kv_index: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Attention sublayer with residual + LN. kv may hold only the unique
    condition rows (u < b) with kv_index mapping each query row to its row:
    K/V are projected once per unique row and gathered (bert.py:143-156).
    With a generator: probability dropout, then output dropout before the
    residual. Under tensor parallelism the layer's heads are this rank's;
    a token-sharded kv (`SequenceShard`, sequence parallelism) is gathered
    here, its gradient reduce-scattered back."""
    b, lq, h = x.shape
    tp = lp.tp
    self_kv = kv is x
    x_in = copy_to_model(x, tp)
    kv = x_in if self_kv else (kv.gather() if isinstance(kv, SequenceShard)
                               else copy_to_model(kv, tp))
    u, lk = kv.shape[0], kv.shape[1]
    nh, hd = lp.local_heads(cfg), cfg.head_dim
    q = linear(x_in, lp.get(f"{prefix}q_w"), lp.get(f"{prefix}q_b"))
    k = linear(kv, lp.get(f"{prefix}k_w"), lp.get(f"{prefix}k_b"))
    v = linear(kv, lp.get(f"{prefix}v_w"), lp.get(f"{prefix}v_b"))
    q = q.reshape(b, lq, nh, hd).transpose(1, 2)
    k = k.reshape(u, lk, nh, hd).transpose(1, 2)
    v = v.reshape(u, lk, nh, hd).transpose(1, 2)
    if kv_index is not None:
        k = k[kv_index]
        v = v[kv_index]
    o = multi_head_attention(
        q, k, v, bias=bias, scale=hd ** -0.5, impl=attn_impl,
        dropout_generator=generator,
        dropout_rate=cfg.attention_probs_dropout_prob,
        dropout_heads=None if tp is None else (tp.index * nh,
                                               cfg.num_attention_heads))
    o = o.transpose(1, 2).reshape(b, lq, nh * hd)
    o = row_parallel_linear(o, lp.get(f"{out_prefix}_w"),
                            lp.get(f"{out_prefix}_b"), tp)
    o = dropout(o, cfg.hidden_dropout_prob, generator)
    return layer_norm(x + o, lp.get(f"{ln_prefix}_w"), lp.get(f"{ln_prefix}_b"),
                      cfg.layer_norm_eps)


def _layer(x: torch.Tensor, lp: BertLayer, cfg: BertConfig,
           self_bias: Optional[torch.Tensor],
           encoder_hidden_states: Optional[torch.Tensor],
           cross_bias: Optional[torch.Tensor], attn_impl: str,
           cross_kv_index: Optional[torch.Tensor],
           seed: Optional[int]) -> torch.Tensor:
    gen = None if seed is None else seeded_generator(seed, x.device)
    x = _attn_sublayer(x, x, lp, cfg, self_bias, "", "attn_out", "attn_ln",
                       attn_impl, generator=gen)
    if encoder_hidden_states is not None:
        x = _attn_sublayer(
            x, seq_map(lambda t: t.to(x.dtype), encoder_hidden_states), lp,
            cfg, cross_bias, "x", "x_out", "x_ln", attn_impl,
            kv_index=cross_kv_index, generator=gen,
        )
    y = gelu(linear(copy_to_model(x, lp.tp), lp.get("inter_w"),
                    lp.get("inter_b")))
    y = row_parallel_linear(y, lp.get("out_w"), lp.get("out_b"), lp.tp)
    y = dropout(y, cfg.hidden_dropout_prob, gen)
    return layer_norm(x + y, lp.get("out_ln_w"), lp.get("out_ln_b"),
                      cfg.layer_norm_eps)


def bert_encoder(
    model: Bert,
    hidden: torch.Tensor,
    self_bias: Optional[torch.Tensor],
    encoder_hidden_states: Optional[torch.Tensor] = None,
    cross_bias: Optional[torch.Tensor] = None,
    attn_impl: str = "flash",
    cross_kv_index: Optional[torch.Tensor] = None,
    remat: bool = False,
    layer_seeds: Optional[List[int]] = None,
) -> torch.Tensor:
    """The layer march; `layer_seeds` (one per layer) turn training dropout
    on, `remat` checkpoints each layer."""
    cfg = model.cfg
    x = hidden
    for i, lp in enumerate(model.layers):
        args = (x, lp, cfg, self_bias, encoder_hidden_states, cross_bias,
                attn_impl, cross_kv_index,
                None if layer_seeds is None else layer_seeds[i])
        if remat:
            x = torch.utils.checkpoint.checkpoint(_layer, *args,
                                                  use_reentrant=False)
        else:
            x = _layer(*args)
    return x


def mlm_logits(model: Bert, sequence_output: torch.Tensor) -> torch.Tensor:
    """MLM head: dense → GELU → LN(eps 1e-12) → decoder (bert.py:237-241);
    logits in the input's dtype."""
    hp = model.mlm_head
    x = gelu(linear(sequence_output, hp.get("dense_w"), hp.get("dense_b")))
    x = layer_norm(x, hp.get("ln_w"), hp.get("ln_b"), model.cfg.layer_norm_eps)
    return linear(x, hp.get("decoder_w"), hp.get("decoder_b"))


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             group=None) -> torch.Tensor:
    """Mean cross-entropy in fp32 over labels != -100, 0 when none
    (bert.py:244-251; torch's ignore_index). The mean is over the batch's
    valid tokens: under a process group (the data axis) over the global
    batch's, so this rank's share is its summed NLL over the global count,
    times the world (its mean over the ranks, which the data-parallel step
    averages, is the global mean however the ranks' counts differ)."""
    valid = labels != -100
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0).long()[..., None])
    nll = torch.where(valid, nll[..., 0], 0.0)
    count = valid.sum()
    if group is not None:
        count = all_reduce_sum(count, group)
        return nll.sum() * data_axis_size(group) / count.clamp_min(1)
    return nll.sum() / count.clamp_min(1)


def bert_forward(
    model: Bert,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_attention_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "flash",
    encoder_row_index: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    remat: bool = False,
    with_logits: bool = False,
    train_rng: Optional[torch.Generator] = None,
    data_group=None,
) -> BertOutput:
    """`BertForMaskedLM.forward` (bert.py:254-313): (loss, logits,
    sequence_output); the MLM head runs when labels are given or
    with_logits. train_rng (a CPU generator) turns training dropout on;
    `data_group` counts the loss's tokens over the ranks (`mlm_loss`)."""
    self_bias = extended_attention_mask(attention_mask)
    cross_bias = None
    if encoder_hidden_states is not None and encoder_attention_mask is not None:
        enc_mask = encoder_attention_mask
        if encoder_row_index is not None:
            rows = (encoder_hidden_states.local
                    if isinstance(encoder_hidden_states, SequenceShard)
                    else encoder_hidden_states).shape[0]
            if enc_mask.shape[0] != rows:
                raise ValueError(
                    "encoder_attention_mask must be per unique row "
                    f"({rows}) when "
                    f"encoder_row_index is given, got {enc_mask.shape[0]}"
                )
            enc_mask = enc_mask[encoder_row_index]
        cross_bias = extended_attention_mask(enc_mask)
    seeds = None
    if train_rng is not None:
        seeds = draw_seeds(train_rng, 1 + model.cfg.num_hidden_layers)
    hidden = bert_embeddings(
        model.embeddings, model.cfg, input_ids, position_ids, token_type_ids,
        compute_dtype,
        None if seeds is None else seeded_generator(seeds[0], input_ids.device))
    seq = bert_encoder(model, hidden, self_bias, encoder_hidden_states,
                       cross_bias, attn_impl, cross_kv_index=encoder_row_index,
                       remat=remat, layer_seeds=None if seeds is None else seeds[1:])
    logits = loss = None
    if labels is not None or with_logits:
        logits = mlm_logits(model, seq)
        if labels is not None:
            loss = mlm_loss(logits, labels, data_group)
    return BertOutput(loss=loss, logits=logits, sequence_output=seq)
