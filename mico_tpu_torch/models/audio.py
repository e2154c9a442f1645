"""Audio towers: AST and BEATs (counterpart of `mico_tpu/models/audio.py`).

VAST's separate audio encoders (`audio_encoder_type` "ast" or "beats"):
  - AST: a 16x16 patch embed as reshape + one matmul over the (T, M)
    spectrogram, a CLS token, learned absolute positions, 12 pre-norm
    layers (eps 1e-12, erf GELU in fp32).
  - BEATs (the AS2M checkpoint's config): the 16x16 patch embed, LN, the
    512 → 768 projection, the weight-normed grouped positional conv (k 128,
    16 groups, SamePad trim, erf GELU, in fp32), 12 post-norm layers with
    deep-norm residuals, one T5-bucketed relative-position table shared by
    every layer with the gated (`gru_rel_pos`) per-layer modulation, and
    the max-subtracted x32 softmax stabilisation.

Both are plain PyTorch: no Pallas kernel computes either tower in the JAX
package, so BEATs' attention is `torch.matmul` math with JAX's rounding
points (the scores in the compute dtype, the softmax in fp32), not SDPA.
Parameters keep JAX's names; a tower's layers are a ModuleList (JAX's list
of per-layer dicts), so a JAX tree places through
`convert.params_from_jax` as it is.

Training (`train_rng`, a CPU `torch.Generator`) turns on the reference
regularizers from one device generator forked from it: dropout (BEATs:
after the positional conv, attention probabilities, dropout1/2/3; AST:
embeddings, attention probabilities, both residual branches), LayerDrop
without rescale, and BEATs' layer-wise gradient decay (identity forward,
the gradient times the ratio per layer). Without it the forwards are the
evaluation graphs.

`ast_from_torch` and `beats_from_torch` convert the released state dicts
(VAST's AST layout and BEATs' `checkpoint['model']`) into a tower's tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.ops.layers import (dropout, fork_generator, gelu,
                                       layer_norm, linear)

# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AstConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    audio_melbins: int = 64
    audio_target_length: int = 1024
    patch_size: int = 16
    ln_eps: float = 1e-12
    # train-time regularizers (reference general_module.py:258-260)
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1

    @property
    def tokens_per_frame(self) -> int:
        return (self.audio_melbins // self.patch_size) * (
            self.audio_target_length // self.patch_size)


def _patches(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, M) → (B, T/p·M/p, p·p): a conv with kernel = stride = p as a
    reshape, tokens in the conv's row-major (T-patch, M-patch) order; a
    trailing edge that is not a multiple of p is dropped (torch's conv)."""
    b, t, m = x.shape
    x = x[:, : t // p * p, : m // p * p]
    x = x.reshape(b, t // p, p, m // p, p)
    return x.permute(0, 1, 3, 2, 4).reshape(b, -1, p * p)


def _ast_layer_params(init: Init, h: int, i: int) -> dict:
    return dict(
        q_w=init.normal((h, h)), q_b=init.zeros((h,)),
        k_w=init.normal((h, h)), k_b=init.zeros((h,)),
        v_w=init.normal((h, h)), v_b=init.zeros((h,)),
        o_w=init.normal((h, h)), o_b=init.zeros((h,)),
        ln1_scale=init.ones((h,)), ln1_bias=init.zeros((h,)),
        ln2_scale=init.ones((h,)), ln2_bias=init.zeros((h,)),
        fc1_w=init.normal((h, i)), fc1_b=init.zeros((i,)),
        fc2_w=init.normal((i, h)), fc2_b=init.zeros((h,)),
    )


class AstEncoder(nn.Module):
    """Parameter tree of `init_ast`: patch_w, patch_b, cls_token,
    pos_embed, layers[i]/*, last_ln_{scale,bias}; normal 0.02 weights,
    zero biases, unit LN weights."""

    def __init__(self, cfg: AstConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size

        def param(t):   # made without gradients; training turns them on
            return nn.Parameter(t, requires_grad=False)

        self.layers = nn.ModuleList(
            [ParamGroup(**_ast_layer_params(init, h, cfg.intermediate_size))
             for _ in range(cfg.num_hidden_layers)])
        self.patch_w = param(init.normal((cfg.patch_size ** 2, h)))
        self.patch_b = param(init.zeros((h,)))
        self.cls_token = param(init.normal((1, h)))
        self.pos_embed = param(init.normal((cfg.tokens_per_frame + 1, h)))
        self.last_ln_scale = param(init.ones((h,)))
        self.last_ln_bias = param(init.zeros((h,)))


def _ast_attention(lp: ParamGroup, x: torch.Tensor, num_heads: int,
                   gen: Optional[torch.Generator], attn_drop: float
                   ) -> torch.Tensor:
    """AST self-attention (audio.py:66-79): the scores in x's dtype, then
    divided by sqrt(d) in fp32 (JAX promotes the bf16 scores there), the
    softmax in fp32, probability dropout."""
    b, n, c = x.shape
    hd = c // num_heads

    def heads(name):
        y = linear(x, lp.get(f"{name}_w"), lp.get(f"{name}_b"))
        return y.reshape(b, n, num_heads, hd).transpose(1, 2)

    q, k, v = heads("q"), heads("k"), heads("v")
    attn = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    attn = dropout(attn, attn_drop, gen)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
    return linear(out, lp.get("o_w"), lp.get("o_b"))


def ast_forward(model: AstEncoder, spectrograms: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                train_rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, T, M) normalized fbank → (B, 1 + T/16·M/16, H), the pre-norm
    stack's last LN (audio.py:82-130). MiCo passes the slices transposed to
    (M, T), as JAX does. `train_rng` turns on embedding dropout, residual
    dropout on both branches and attention-probability dropout."""
    cfg = model.cfg
    x = _patches(spectrograms.to(compute_dtype), cfg.patch_size)
    x = linear(x, model.patch_w, model.patch_b)
    b = x.shape[0]
    cls = model.cls_token.to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + model.pos_embed.to(x.dtype)[None, : x.shape[1]]
    gen = fork_generator(train_rng, x.device)
    x = dropout(x, cfg.hidden_dropout, gen)
    for lp in model.layers:
        h = layer_norm(x, lp.get("ln1_scale"), lp.get("ln1_bias"), cfg.ln_eps)
        h = _ast_attention(lp, h, cfg.num_attention_heads, gen,
                           cfg.attention_dropout)
        x = x + dropout(h, cfg.hidden_dropout, gen)
        h = layer_norm(x, lp.get("ln2_scale"), lp.get("ln2_bias"), cfg.ln_eps)
        h = gelu(linear(h, lp.get("fc1_w"), lp.get("fc1_b")))
        h = linear(h, lp.get("fc2_w"), lp.get("fc2_b"))
        x = x + dropout(h, cfg.hidden_dropout, gen)
    return layer_norm(x, model.last_ln_scale, model.last_ln_bias, cfg.ln_eps)


def init_ast(cfg: AstConfig, seed: int = 0) -> AstEncoder:
    """A freshly drawn AST tower (`init_ast`, audio.py:133-155) on the
    CPU in fp32, from a `torch.Generator` seeded with `seed`."""
    return AstEncoder(cfg, Init(torch.Generator().manual_seed(seed)))


def ast_from_torch(sd: Mapping, cfg: AstConfig) -> Dict:
    """The tower's tree from VAST's AST state dict (`audio_embeddings.*`
    and `audio_encoder.layer.N.*` keys, general_module.py:275-310): torch
    linears transposed to (in, out), the conv patch embed as a matmul
    kernel. Leaves are torch tensors (views where they can be)."""
    from mico_tpu_torch.convert import _t, as_tensor

    g = lambda k: as_tensor(sd[k])       # noqa: E731
    conv = g("audio_embeddings.first_conv.weight")      # (H, 1, 16, 16)
    names = {"q": "attention.linears.0", "k": "attention.linears.1",
             "v": "attention.linears.2", "o": "attention.linears.3",
             "fc1": "ff_layer.linear1", "fc2": "ff_layer.linear2"}
    layers = []
    for i in range(cfg.num_hidden_layers):
        pfx = f"audio_encoder.layer.{i}."
        lp = {}
        for short, mod in names.items():
            lp[f"{short}_w"] = _t(sd[f"{pfx}{mod}.weight"])
            lp[f"{short}_b"] = g(f"{pfx}{mod}.bias")
        for n in (1, 2):
            lp[f"ln{n}_scale"] = g(f"{pfx}layernorm{n}.weight")
            lp[f"ln{n}_bias"] = g(f"{pfx}layernorm{n}.bias")
        layers.append(lp)
    return {
        "patch_w": conv.reshape(conv.shape[0], -1).t(),
        "patch_b": g("audio_embeddings.first_conv.bias"),
        "cls_token": g("audio_embeddings.cls_token").reshape(1, -1),
        "pos_embed": g("audio_embeddings.position_embeddings.weight"),
        "layers": layers,
        "last_ln_scale": g("audio_encoder.last_layernorm.weight"),
        "last_ln_bias": g("audio_encoder.last_layernorm.bias"),
    }


# ---------------------------------------------------------------------------
# BEATs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BeatsConfig:
    """Field names of the reference BEATsConfig (beats.py:1039-1077); the
    defaults are the BEATs_iter3_plus_AS2M checkpoint's."""

    input_patch_size: int = 16
    embed_dim: int = 512
    conv_bias: bool = False
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"
    layer_norm_first: bool = False
    deep_norm: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    ln_eps: float = 1e-5
    # train-time regularizers (beats.py:1055-1060)
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.0
    layer_wise_gradient_decay_ratio: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads

    @property
    def deep_norm_alpha(self) -> float:
        return (2 * self.encoder_layers) ** 0.25 if self.deep_norm else 1.0


@lru_cache(maxsize=16)
def rel_bucket_index(n: int, num_buckets: int, max_distance: int
                     ) -> np.ndarray:
    """(n, n) T5 bidirectional relative-position buckets (beats.py:647-683),
    a host constant per sequence length."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]   # memory - context
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (nb - max_exact)).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return out + np.where(is_small, rel, large)


def _beats_layer_params(init: Init, cfg: BeatsConfig) -> dict:
    e, f = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
    lp = dict(
        q_w=init.normal((e, e)), q_b=init.zeros((e,)),
        k_w=init.normal((e, e)), k_b=init.zeros((e,)),
        v_w=init.normal((e, e)), v_b=init.zeros((e,)),
        o_w=init.normal((e, e)), o_b=init.zeros((e,)),
        ln1_scale=init.ones((e,)), ln1_bias=init.zeros((e,)),
        ln2_scale=init.ones((e,)), ln2_bias=init.zeros((e,)),
        fc1_w=init.normal((e, f)), fc1_b=init.zeros((f,)),
        fc2_w=init.normal((f, e)), fc2_b=init.zeros((e,)),
    )
    if cfg.gru_rel_pos:
        lp.update(grep_w=init.normal((cfg.head_dim, 8)),
                  grep_b=init.zeros((8,)),
                  grep_a=init.ones((cfg.encoder_attention_heads,)))
    return lp


class BeatsEncoder(nn.Module):
    """Parameter tree of `init_beats`: patch_w (patch_b with conv_bias),
    ln_{scale,bias}, proj_{w,b} (when embed_dim differs from the encoder's
    width), pos_conv_{w,b} (the folded weight norm), enc_ln_{scale,bias},
    layers[i]/*, rel_bias_table (one, shared by every layer); normal 0.02
    weights, zero biases, unit LN weights and `grep_a`."""

    def __init__(self, cfg: BeatsConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        c, e = cfg.embed_dim, cfg.encoder_embed_dim

        def param(t):   # made without gradients; training turns them on
            return nn.Parameter(t, requires_grad=False)

        self.layers = nn.ModuleList(
            [ParamGroup(**_beats_layer_params(init, cfg))
             for _ in range(cfg.encoder_layers)])
        self.patch_w = param(init.normal((cfg.input_patch_size ** 2, c)))
        self.ln_scale = param(init.ones((c,)))
        self.ln_bias = param(init.zeros((c,)))
        self.pos_conv_w = param(init.normal(
            (e, e // cfg.conv_pos_groups, cfg.conv_pos)))
        self.pos_conv_b = param(init.zeros((e,)))
        self.enc_ln_scale = param(init.ones((e,)))
        self.enc_ln_bias = param(init.zeros((e,)))
        if cfg.relative_position_embedding:
            self.rel_bias_table = param(init.normal(
                (cfg.num_buckets, cfg.encoder_attention_heads)))
        if cfg.conv_bias:
            self.patch_b = param(init.zeros((c,)))
        if c != e:
            self.proj_w = param(init.normal((c, e)))
            self.proj_b = param(init.zeros((e,)))


def beats_position_bias(model: BeatsEncoder, n: int) -> torch.Tensor:
    """The (H, n, n) relative-position bias of n tokens: the shared table
    gathered at the bucket index (audio.py:348-357), in the table's
    dtype."""
    cfg = model.cfg
    idx = torch.from_numpy(rel_bucket_index(n, cfg.num_buckets,
                                            cfg.max_distance))
    idx = idx.to(model.rel_bias_table.device).reshape(-1)
    bias = model.rel_bias_table[idx]
    return bias.reshape(n, n, cfg.encoder_attention_heads).permute(2, 0, 1)


def beats_attention(lp: ParamGroup, x: torch.Tensor, cfg: BeatsConfig,
                    position_bias: Optional[torch.Tensor],
                    gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """BEATs self-attention (audio.py:258-294, beats.py:770-918) with its
    rounding points: q·d^-½/32 and the max-subtracted scores ×32 in x's
    dtype; the `gru_rel_pos` gate from the unscaled q (an 8-way linear
    summed 2×4, sigmoids, gate_a·(gate_b·grep_a − 1) + 2, which JAX's type
    promotion takes to the dtype of `grep_a`), the gated bias cast to the
    scores' dtype; the softmax in fp32, cast back; probability dropout."""
    b, n, c = x.shape
    h, hd = cfg.encoder_attention_heads, cfg.head_dim
    alpha = 32.0
    q = linear(x, lp.get("q_w"), lp.get("q_b")) * (hd ** -0.5) / alpha
    k = linear(x, lp.get("k_w"), lp.get("k_b"))
    v = linear(x, lp.get("v_w"), lp.get("v_b"))
    q, k, v = (t.reshape(b, n, h, hd).transpose(1, 2) for t in (q, k, v))

    attn = torch.matmul(q, k.transpose(-1, -2))
    attn = (attn - attn.amax(dim=-1, keepdim=True)) * alpha
    if position_bias is not None:
        bias = position_bias[None]                        # (1, H, N, N)
        if cfg.gru_rel_pos:
            ql = q * alpha / (hd ** -0.5)
            gates = linear(ql, lp.get("grep_w"), lp.get("grep_b"))
            gates = gates.reshape(b, h, n, 2, 4).sum(-1)
            gate_a = torch.sigmoid(gates[..., 0])
            gate_b = torch.sigmoid(gates[..., 1])
            gate = gate_a * (gate_b * lp.get("grep_a").reshape(1, h, 1)
                             - 1.0) + 2.0
            bias = gate[..., None] * bias
        attn = attn + bias.to(attn.dtype)
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    attn = dropout(attn, cfg.attention_dropout, gen)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
    return linear(out, lp.get("o_w"), lp.get("o_b"))


def beats_pos_conv(model: BeatsEncoder, x: torch.Tensor) -> torch.Tensor:
    """The positional conv embedding (audio.py:297-315): the folded
    weight-normed grouped conv1d over the tokens in fp32, its bias added
    apart, the SamePad trim of an even kernel, erf GELU; back in x's
    dtype."""
    cfg = model.cfg
    out = F.conv1d(x.float().transpose(1, 2), model.pos_conv_w.float(),
                   padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    out = out + model.pos_conv_b.reshape(1, -1, 1)
    if cfg.conv_pos % 2 == 0:
        out = out[:, :, :-1]
    out = F.gelu(out, approximate="none")
    return out.transpose(1, 2).to(x.dtype)


class _GradMultiply(torch.autograd.Function):
    """Identity forward; the backward scales the gradient by `ratio`
    (fairseq's GradMultiply, beats.py:381-382)."""

    @staticmethod
    def forward(ctx, x, ratio):
        ctx.ratio = ratio
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.ratio, None


def beats_forward(model: BeatsEncoder, fbank: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32,
                  train_rng: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """(B, T, M) normalized fbank → (B, T/16·M/16, encoder_embed_dim)
    (audio.py:318-399). `train_rng` turns on the training internals:
    dropout after the positional conv, attention-probability dropout,
    dropout1/2/3, LayerDrop (a whole layer skipped, no rescale) and the
    layer-wise gradient decay."""
    cfg = model.cfg
    x = _patches(fbank.to(compute_dtype), cfg.input_patch_size)
    x = linear(x, model.patch_w, getattr(model, "patch_b", None))
    x = layer_norm(x, model.ln_scale, model.ln_bias, cfg.ln_eps)
    if hasattr(model, "proj_w"):
        x = linear(x, model.proj_w, model.proj_b)
    x = x + beats_pos_conv(model, x)
    if not cfg.layer_norm_first:
        x = layer_norm(x, model.enc_ln_scale, model.enc_ln_bias, cfg.ln_eps)
    gen = fork_generator(train_rng, x.device)
    x = dropout(x, cfg.dropout, gen)

    da = cfg.deep_norm_alpha
    decay = cfg.layer_wise_gradient_decay_ratio
    position_bias = (beats_position_bias(model, x.shape[1])
                     if cfg.relative_position_embedding else None)
    for lp in model.layers:
        if gen is not None and decay != 1.0:
            x = _GradMultiply.apply(x, decay)
        x_in = x
        h = beats_attention(lp, x, cfg, position_bias, gen)
        x = x * da + dropout(h, cfg.dropout, gen)
        x = layer_norm(x, lp.get("ln1_scale"), lp.get("ln1_bias"), cfg.ln_eps)
        h = gelu(linear(x, lp.get("fc1_w"), lp.get("fc1_b")))
        h = dropout(h, cfg.activation_dropout, gen)
        h = linear(h, lp.get("fc2_w"), lp.get("fc2_b"))
        x = x * da + dropout(h, cfg.dropout, gen)
        x = layer_norm(x, lp.get("ln2_scale"), lp.get("ln2_bias"), cfg.ln_eps)
        if gen is not None and cfg.encoder_layerdrop > 0.0:
            keep = torch.rand((), generator=gen, device=x.device) >= (
                cfg.encoder_layerdrop)
            x = torch.where(keep, x, x_in)
    return x


def init_beats(cfg: BeatsConfig, seed: int = 0) -> BeatsEncoder:
    """A freshly drawn BEATs tower (`init_beats`, audio.py:402-447) on the
    CPU in fp32, from a `torch.Generator` seeded with `seed`."""
    return BeatsEncoder(cfg, Init(torch.Generator().manual_seed(seed)))


def beats_from_torch(sd: Mapping, cfg: BeatsConfig) -> Dict:
    """The tower's tree from the released BEATs state dict (its
    `checkpoint['model']`): torch linears transposed to (in, out), the conv
    patch embed as a matmul kernel, the positional conv's weight norm
    folded (g · v / ‖v‖ over the output and input channels, per tap), the
    relative table of layer 0 (which every layer shares), a missing
    k_proj bias as zeros."""
    from mico_tpu_torch.convert import _t, as_tensor

    g = lambda k: as_tensor(sd[k])       # noqa: E731
    conv = g("patch_embedding.weight")                  # (C, 1, 16, 16)
    wv = g("encoder.pos_conv.0.weight_v").float()       # (C, C/groups, K)
    wg = g("encoder.pos_conv.0.weight_g").float()       # (1, 1, K)
    norm = torch.sqrt((wv ** 2).sum(dim=(0, 1), keepdim=True))
    pos_w = wg * wv / torch.clamp(norm, min=1e-12)
    e = cfg.encoder_embed_dim
    names = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
             "v": "self_attn.v_proj", "o": "self_attn.out_proj",
             "fc1": "fc1", "fc2": "fc2"}
    layers = []
    for i in range(cfg.encoder_layers):
        pfx = f"encoder.layers.{i}."
        lp = {}
        for short, mod in names.items():
            lp[f"{short}_w"] = _t(sd[f"{pfx}{mod}.weight"])
            key = f"{pfx}{mod}.bias"
            lp[f"{short}_b"] = (g(key) if key in sd
                                else torch.zeros((e,), dtype=torch.float32))
        lp.update(ln1_scale=g(pfx + "self_attn_layer_norm.weight"),
                  ln1_bias=g(pfx + "self_attn_layer_norm.bias"),
                  ln2_scale=g(pfx + "final_layer_norm.weight"),
                  ln2_bias=g(pfx + "final_layer_norm.bias"))
        if cfg.gru_rel_pos:
            lp.update(grep_w=_t(sd[pfx + "self_attn.grep_linear.weight"]),
                      grep_b=g(pfx + "self_attn.grep_linear.bias"),
                      grep_a=g(pfx + "self_attn.grep_a").reshape(-1))
        layers.append(lp)
    params = {
        "patch_w": conv.reshape(conv.shape[0], -1).t(),
        "ln_scale": g("layer_norm.weight"), "ln_bias": g("layer_norm.bias"),
        "pos_conv_w": pos_w, "pos_conv_b": g("encoder.pos_conv.0.bias"),
        "enc_ln_scale": g("encoder.layer_norm.weight"),
        "enc_ln_bias": g("encoder.layer_norm.bias"),
        "layers": layers,
    }
    if cfg.relative_position_embedding:
        params["rel_bias_table"] = g(
            "encoder.layers.0.self_attn.relative_attention_bias.weight")
    if "patch_embedding.bias" in sd:
        params["patch_b"] = g("patch_embedding.bias")
    if "post_extract_proj.weight" in sd:
        params["proj_w"] = _t(sd["post_extract_proj.weight"])
        params["proj_b"] = g("post_extract_proj.bias")
    return params
