"""EVA/OpenAI-CLIP text tower and the two-tower CLIP (counterpart of
`mico_tpu/models/clip_text.py`).

The text tower (the reference `TextTransformer`): token embedding and
learned positions, pre-norm causal blocks with one packed qkv `linear`
each, attention on plain math (`multi_head_attention(impl="plain")`, as
JAX runs it with impl="xla") under an additive fp32 −1e9 causal mask, an
MLP with GELU (exact erf in fp32, tanh in bf16) or QuickGELU, the final LN
with fp32 statistics, and EOT-argmax pooling through the text projection,
a plain `@` in the pooled dtype. The blocks are a ModuleList of JAX's
`layers` dicts, under JAX's names.

`CLIP` is the reference `CustomCLIP`: an `EvaVisionTransformer` (`visual`,
its `head` the CLIP projection), a `ClipTextTransformer` (`text`) and a
learnable `logit_scale` = ln(1/0.07). The image side is
`eva_vit_forward(return_all_features=False)` and the head, so it reaches
the kernels as MiCo's tower does: on the card in bf16 K1 in every block of
a pre-norm EVA01 tower, K2 as an EVA02 tower's self-attention, K5 (or K8
under `FUSED_ATTN_PROJ`) on the post-norm bigE towers; the plain versions
for CPU tensors and in fp32.

`create_model` resolves the eight EVA-CLIP names (configs from
`config.EVA_VIT_CONFIGS` and `EVA_TEXT_CONFIGS`); `clip_from_torch`
converts a released `CustomCLIP` state dict into JAX's parameter tree and
`convert.clip_from_jax` places such a tree in a `CLIP`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch
from torch import nn

from mico_tpu_torch.config import EVA_VIT_CONFIGS, EvaVitConfig
from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.models.eva_vit import EvaVisionTransformer, eva_vit_forward
from mico_tpu_torch.models.mico import resolve_device
from mico_tpu_torch.ops.attention import multi_head_attention
from mico_tpu_torch.ops.layers import gelu, layer_norm, linear

NEG_INF = -1.0e9


@dataclass(frozen=True)
class ClipTextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    output_dim: int = 512
    ln_eps: float = 1e-5
    quick_gelu: bool = False    # OpenAI CLIP text towers: x·σ(1.702x)

    @property
    def mlp_width(self) -> int:
        return 4 * self.width


# the text_cfg of each EVA-CLIP config; output_dim is its embed_dim
EVA_TEXT_CONFIGS = {
    "EVA01-CLIP-B-16": ClipTextConfig(width=512, heads=8, layers=12,
                                      output_dim=512),
    "EVA01-CLIP-g-14": ClipTextConfig(width=768, heads=12, layers=12,
                                      output_dim=1024),
    "EVA01-CLIP-g-14-plus": ClipTextConfig(width=1024, heads=16, layers=24,
                                           output_dim=1024),
    "EVA02-CLIP-B-16": ClipTextConfig(width=512, heads=8, layers=12,
                                      output_dim=512),
    "EVA02-CLIP-L-14": ClipTextConfig(width=768, heads=12, layers=12,
                                      output_dim=768),
    "EVA02-CLIP-L-14-336": ClipTextConfig(width=768, heads=12, layers=12,
                                          output_dim=768),
    "EVA02-CLIP-bigE-14": ClipTextConfig(width=1024, heads=16, layers=24,
                                         output_dim=1024),
    "EVA02-CLIP-bigE-14-plus": ClipTextConfig(width=1280, heads=20,
                                              layers=32, output_dim=1024),
}


class ClipTextBlock(ParamGroup):
    """One causal pre-norm block, parameters as JAX's `layers[i]`."""

    def __init__(self, cfg: ClipTextConfig, init: Init):
        w, h = cfg.width, cfg.mlp_width
        proj_std = (w ** -0.5) * ((2 * cfg.layers) ** -0.5)
        super().__init__(
            qkv_w=init.normal((w, 3 * w), w ** -0.5),
            qkv_b=init.zeros((3 * w,)),
            proj_w=init.normal((w, w), proj_std), proj_b=init.zeros((w,)),
            ln1_w=init.ones((w,)), ln1_b=init.zeros((w,)),
            ln2_w=init.ones((w,)), ln2_b=init.zeros((w,)),
            fc_w=init.normal((w, h), (2 * w) ** -0.5),
            fc_b=init.zeros((h,)),
            out_w=init.normal((h, w), proj_std), out_b=init.zeros((w,)),
        )

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                cfg: ClipTextConfig) -> torch.Tensor:
        b, l, w = x.shape
        nh = cfg.heads
        hd = w // nh
        h = layer_norm(x, self.get("ln1_w"), self.get("ln1_b"), cfg.ln_eps)
        qkv = linear(h, self.get("qkv_w"), self.get("qkv_b"))
        q, k, v = qkv.reshape(b, l, 3, nh, hd).permute(2, 0, 3, 1, 4)
        o = multi_head_attention(q, k, v, bias=bias, scale=hd ** -0.5,
                                 impl="plain")
        o = o.transpose(1, 2).reshape(b, l, w)
        x = x + linear(o, self.get("proj_w"), self.get("proj_b"))
        h = layer_norm(x, self.get("ln2_w"), self.get("ln2_b"), cfg.ln_eps)
        h = linear(h, self.get("fc_w"), self.get("fc_b"))
        h = h * torch.sigmoid(1.702 * h) if cfg.quick_gelu else gelu(h)
        return x + linear(h, self.get("out_w"), self.get("out_b"))


class ClipTextTransformer(nn.Module):
    """Parameter tree: token_embedding, positional_embedding, layers[i]/*,
    ln_final_{w,b}, text_projection; drawn with `init_clip_text`'s stds
    (normal 0.02 tokens, 0.01 positions, width^-0.5 qkv and projection,
    width^-0.5·(2·layers)^-0.5 output linears, (2·width)^-0.5 fc)."""

    def __init__(self, cfg: ClipTextConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        w = cfg.width

        def param(t):   # made without gradients
            return nn.Parameter(t, requires_grad=False)

        self.token_embedding = param(init.normal((cfg.vocab_size, w), 0.02))
        self.positional_embedding = param(
            init.normal((cfg.context_length, w), 0.01))
        self.layers = nn.ModuleList(
            [ClipTextBlock(cfg, init) for _ in range(cfg.layers)])
        self.ln_final_w = param(init.ones((w,)))
        self.ln_final_b = param(init.zeros((w,)))
        self.text_projection = param(
            init.normal((w, cfg.output_dim), w ** -0.5))


def clip_text_forward(model: ClipTextTransformer, token_ids: torch.Tensor,
                      return_all_features: bool = False,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """(B, L) ids, 0-padded after EOT → pooled (B, output_dim), or the
    (B, L, width) token features when `return_all_features`. Pooling takes
    the row at the first largest id: the EOT id is the vocab's largest."""
    cfg = model.cfg
    ids = token_ids.long()
    l = ids.shape[1]
    x = model.token_embedding[ids].to(compute_dtype)
    x = x + model.positional_embedding[:l].to(compute_dtype)
    causal = torch.full((l, l), NEG_INF, dtype=torch.float32,
                        device=x.device).triu(1)[None, None]
    for blk in model.layers:
        x = blk(x, causal, cfg)
    x = layer_norm(x, model.ln_final_w, model.ln_final_b, cfg.ln_eps)
    if return_all_features:
        return x
    pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return pooled @ model.text_projection.to(pooled.dtype)


def clip_text_from_torch(sd: Mapping, cfg: ClipTextConfig,
                         prefix: str = "") -> Dict:
    """A reference `TextTransformer` state dict (`transformer.resblocks.N.
    attn.in_proj_weight`, ...; prefix 'text.' inside a CustomCLIP) → JAX's
    text tree, linears transposed to (in, out); leaves are torch tensors,
    views of the checkpoint's where they can be."""
    from mico_tpu_torch.convert import as_tensor

    def g(k):
        return as_tensor(sd[prefix + k])

    layers = []
    for i in range(cfg.layers):
        p = f"transformer.resblocks.{i}."
        layers.append({
            "qkv_w": g(p + "attn.in_proj_weight").t(),
            "qkv_b": g(p + "attn.in_proj_bias"),
            "proj_w": g(p + "attn.out_proj.weight").t(),
            "proj_b": g(p + "attn.out_proj.bias"),
            "ln1_w": g(p + "ln_1.weight"), "ln1_b": g(p + "ln_1.bias"),
            "ln2_w": g(p + "ln_2.weight"), "ln2_b": g(p + "ln_2.bias"),
            "fc_w": g(p + "mlp.c_fc.weight").t(),
            "fc_b": g(p + "mlp.c_fc.bias"),
            "out_w": g(p + "mlp.c_proj.weight").t(),
            "out_b": g(p + "mlp.c_proj.bias"),
        })
    return {
        "token_embedding": g("token_embedding.weight"),
        "positional_embedding": g("positional_embedding"),
        "ln_final_w": g("ln_final.weight"), "ln_final_b": g("ln_final.bias"),
        "text_projection": g("text_projection"),
        "layers": layers,
    }


# ---------------------------------------------------------------------------
# the two-tower CLIP (CustomCLIP)
# ---------------------------------------------------------------------------


class CLIP(nn.Module):
    """`visual` (EVA ViT with its projection head), `text` and
    `logit_scale`, drawn as `init_clip` draws them from one
    `torch.Generator` seeded with `seed`, in fp32 on the CPU, then moved to
    `device`. `init_weights=False` only allocates shapes (the skeleton
    `convert.clip_from_jax` fills)."""

    def __init__(self, vision_cfg: EvaVitConfig, text_cfg: ClipTextConfig,
                 *, device="cuda", seed: int = 0, init_weights: bool = True):
        super().__init__()
        dev = resolve_device(device)
        init = Init(torch.Generator().manual_seed(seed),
                    meta=not init_weights)
        self.visual = EvaVisionTransformer(vision_cfg, init)
        self.text = ClipTextTransformer(text_cfg, init)
        self.logit_scale = nn.Parameter(init.full((), math.log(1.0 / 0.07)),
                                        requires_grad=False)
        if init_weights:
            self.to(dev)


def _normalized(feats: torch.Tensor) -> torch.Tensor:
    """Rows over their norm, taken in fp32 and cast to the rows' dtype."""
    norm = torch.linalg.vector_norm(feats.float(), dim=-1, keepdim=True)
    return feats / norm.to(feats.dtype)


def clip_encode_image(model: CLIP, pixels: torch.Tensor,
                      normalize: bool = True,
                      compute_dtype: torch.dtype = torch.float32,
                      attn_impl: str = "flash") -> torch.Tensor:
    """(B, 3, H, W) → (B, embed_dim): the tower's pooled CLS through the
    head. `attn_impl='flash'` takes the kernels' wrappers (the plain
    versions on the CPU and in fp32), 'plain' the unfused plain route."""
    head = model.visual.head
    feats = eva_vit_forward(model.visual, pixels, return_all_features=False,
                            compute_dtype=compute_dtype, attn_impl=attn_impl)
    feats = linear(feats, head.get("kernel"), head.get("bias"))
    return _normalized(feats) if normalize else feats


def clip_encode_text(model: CLIP, token_ids: torch.Tensor,
                     normalize: bool = True,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    feats = clip_text_forward(model.text, token_ids,
                              compute_dtype=compute_dtype)
    return _normalized(feats) if normalize else feats


def clip_forward(model: CLIP, pixels: torch.Tensor, token_ids: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32):
    """→ (image features, text features, exp(logit_scale)), the features
    normalized; the scale in fp32."""
    img = clip_encode_image(model, pixels, compute_dtype=compute_dtype)
    txt = clip_encode_text(model, token_ids, compute_dtype=compute_dtype)
    return img, txt, model.logit_scale.float().exp()


def build_zero_shot_classifier(model: CLIP, classnames,
                               templates=("a photo of a {}.",),
                               tokenizer=None,
                               compute_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """Zero-shot weights (n_classes, embed_dim) in fp32: per class every
    template's prompt embedded, each row normalized in fp32, their mean
    normalized. Classify with `image_features @ W.T * exp(logit_scale)`.
    The default tokenizer is `ClipBpeTokenizer()`."""
    if tokenizer is None:
        from mico_tpu_torch.text.bpe import ClipBpeTokenizer

        tokenizer = ClipBpeTokenizer()
    text = model.text
    dev = text.token_embedding.device
    weights = []
    for name in classnames:
        prompts = [t.format(name) for t in templates]
        ids = torch.as_tensor(tokenizer(prompts, text.cfg.context_length),
                              device=dev)
        f = clip_text_forward(text, ids, compute_dtype=compute_dtype).float()
        m = _normalized(f).mean(dim=0)
        weights.append(m / torch.linalg.vector_norm(m))
    return torch.stack(weights)


def create_model(name: str, seed: Optional[int] = None,
                 image_size: Optional[int] = None, device="cuda"):
    """An EVA-CLIP config name → (vision_cfg, text_cfg, CLIP or None):
    `image_size` re-derives the vision grid; the model is drawn from `seed`
    on `device`, and None without a seed (load a checkpoint with
    `clip_from_torch` and `convert.clip_from_jax`). An unknown name raises
    KeyError."""
    if name not in EVA_VIT_CONFIGS:
        raise KeyError(
            f"unknown EVA-CLIP config {name!r}; have {sorted(EVA_VIT_CONFIGS)}"
        )
    vision_cfg = EVA_VIT_CONFIGS[name]
    if image_size is not None:
        vision_cfg = vision_cfg.with_image_size(image_size)
    text_cfg = EVA_TEXT_CONFIGS[name]
    model = (None if seed is None
             else CLIP(vision_cfg, text_cfg, device=device, seed=seed))
    return vision_cfg, text_cfg, model


def clip_from_torch(sd: Mapping, vision_cfg: EvaVitConfig,
                    text_cfg: ClipTextConfig) -> Dict:
    """A released CustomCLIP state dict (`visual.*`, `text.*`,
    `logit_scale`) → JAX's CLIP tree: the visual side through
    `convert.eva_vit_from_torch`, its positional embedding resized to the
    config's grid, the text side through `clip_text_from_torch`."""
    from mico_tpu_torch.convert import as_tensor, eva_vit_from_torch

    return {
        "visual": eva_vit_from_torch(sd, vision_cfg, prefix="visual."),
        "text": clip_text_from_torch(sd, text_cfg, prefix="text."),
        "logit_scale": as_tensor(sd["logit_scale"]).float(),
    }
