"""OpenAI-CLIP Vision Transformer (counterpart of `mico_tpu/models/clip_vit.py`).

MiCo's alternate vision tower (`vision_encoder_type="clip_vit_*"`): a
bias-free patch embed as reshape + one matmul in (c, dy, dx) order, class
and positional embeddings, ln_pre, residual blocks with a packed in-proj
attention and a QuickGELU MLP, optional per-block zero-init adaptor MLPs
(`ada_gamma`), ln_post over all tokens (`return_all_features`, the path
MiCo uses) or the CLS token's projection, and `clip_vit_forward_audio`
(pre-embedded tokens through the blocks only).

Every block's attention is `packed_qkv_self_attention` on the fused
projection (B, L, 3W) on every route, as in JAX (clip_vit.py:66-69): K3 in
bf16 on the card (K9 with `PACKED_CLS_SPLIT` at L = 128k + 1, such as
ViT-L/14's 257 tokens), K4 for its gradient, the plain twins on the CPU and
for fp32. Parameters keep JAX's names; the blocks are a ModuleList.

`clip_vit_from_torch` converts an OpenAI state dict (module keys or the
`visual.`-prefixed keys of the jit archive) into the tower's state dict,
`clip_vit_config_from_state_dict` infers its geometry and
`load_openai_clip` reads a file and resizes the positional embedding.
"""

from __future__ import annotations

import dataclasses
import zipfile
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.ops import flash_attention as fa
from mico_tpu_torch.ops.interpolate import interp_bilinear_2d
from mico_tpu_torch.ops.layers import layer_norm, linear


@dataclass(frozen=True)
class ClipVitConfig:
    input_resolution: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512
    adaptor_layers: int = 0
    ln_eps: float = 1e-5

    @property
    def seq_len(self) -> int:
        return (self.input_resolution // self.patch_size) ** 2 + 1


CLIP_VIT_CONFIGS = {
    "clip_vit_base_16": ClipVitConfig(),
    "clip_vit_large_14": ClipVitConfig(
        patch_size=14, width=1024, layers=24, heads=16, output_dim=768
    ),
}


def _quickgelu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(1.702·x) in x's dtype (clip_vit.py:54)."""
    return x * torch.sigmoid(1.702 * x)


class ClipBlock(ParamGroup):
    """One residual block (clip_vit.py:58-82); parameter names as in JAX's
    `blocks[i]`."""

    def __init__(self, width: int, init: Init, adaptor: bool):
        w = width
        tensors = dict(
            ln1_scale=init.ones((w,)), ln1_bias=init.zeros((w,)),
            qkv_w=init.normal((w, 3 * w)), qkv_b=init.zeros((3 * w,)),
            proj_w=init.normal((w, w)), proj_b=init.zeros((w,)),
            ln2_scale=init.ones((w,)), ln2_bias=init.zeros((w,)),
            fc_w=init.normal((w, 4 * w)), fc_b=init.zeros((4 * w,)),
            cproj_w=init.normal((4 * w, w)), cproj_b=init.zeros((w,)),
        )
        if adaptor:
            tensors.update(
                ada_ln_scale=init.ones((w,)), ada_ln_bias=init.zeros((w,)),
                ada_fc_w=init.normal((w, w // 4)),
                ada_fc_b=init.zeros((w // 4,)),
                ada_cproj_w=init.normal((w // 4, w)),
                ada_cproj_b=init.zeros((w,)),
                ada_gamma=init.zeros((w,)),
            )
        super().__init__(**tensors)

    def _mlp(self, h: torch.Tensor, pre: str) -> torch.Tensor:
        hidden = linear(h, self.get(f"{pre}fc_w"), self.get(f"{pre}fc_b"))
        return linear(_quickgelu(hidden), self.get(f"{pre}cproj_w"),
                      self.get(f"{pre}cproj_b"))

    def forward(self, x: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
        hd = x.shape[-1] // heads
        h = layer_norm(x, self.get("ln1_scale"), self.get("ln1_bias"), eps)
        qkv = linear(h, self.get("qkv_w"), self.get("qkv_b"))
        o = fa.packed_qkv_self_attention(qkv, heads, float(hd) ** -0.5)
        x = x + linear(o, self.get("proj_w"), self.get("proj_b"))
        h = layer_norm(x, self.get("ln2_scale"), self.get("ln2_bias"), eps)
        mlp = self._mlp(h, "")
        if self.get("ada_gamma") is None:
            return x + mlp
        ah = layer_norm(x, self.get("ada_ln_scale"), self.get("ada_ln_bias"),
                        eps)
        return x + mlp + self.get("ada_gamma").to(x.dtype) * self._mlp(ah,
                                                                       "ada_")


class ClipVisionTransformer(nn.Module):
    """Parameter tree: patch_w, class_embedding, positional_embedding,
    ln_pre_{scale,bias}, blocks[i]/*, ln_post_{scale,bias}, proj. Drawn as
    `init_clip_vit` draws them (clip_vit.py:133-172): normal 0.02 in the
    blocks, normal width^-0.5 for the embeddings and projections, zero
    biases and adaptor gates, unit LN weights; the adaptor on the last
    `adaptor_layers` blocks."""

    def __init__(self, cfg: ClipVitConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        scale = w ** -0.5

        def param(t):   # made without gradients; training turns them on
            return nn.Parameter(t, requires_grad=False)

        self.patch_w = param(init.normal((3 * cfg.patch_size ** 2, w), scale))
        self.class_embedding = param(init.normal((w,), scale))
        self.positional_embedding = param(init.normal((cfg.seq_len, w), scale))
        self.ln_pre_scale = param(init.ones((w,)))
        self.ln_pre_bias = param(init.zeros((w,)))
        first_ada = cfg.layers - cfg.adaptor_layers
        self.blocks = nn.ModuleList(
            [ClipBlock(w, init, i >= first_ada) for i in range(cfg.layers)])
        self.ln_post_scale = param(init.ones((w,)))
        self.ln_post_bias = param(init.zeros((w,)))
        self.proj = param(init.normal((w, cfg.output_dim), scale))


def _blocks_and_head(model: ClipVisionTransformer, x: torch.Tensor,
                     return_all_features: bool) -> torch.Tensor:
    cfg = model.cfg
    for blk in model.blocks:
        x = blk(x, cfg.heads, cfg.ln_eps)
    if return_all_features:
        return layer_norm(x, model.ln_post_scale, model.ln_post_bias,
                          cfg.ln_eps)
    cls_out = layer_norm(x[:, 0], model.ln_post_scale, model.ln_post_bias,
                         cfg.ln_eps)
    return linear(cls_out, model.proj)


def clip_vit_forward(model: ClipVisionTransformer, pixels: torch.Tensor,
                     return_all_features: bool = True,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """(B, 3, H, W) → (B, N + 1, width), the all-token ln_post output, or
    (B, output_dim), the CLS projection, when not `return_all_features`
    (clip_vit.py:85-112)."""
    cfg = model.cfg
    x = pixels.to(compute_dtype)
    b = x.shape[0]
    p, g = cfg.patch_size, cfg.input_resolution // cfg.patch_size
    x = x.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    x = linear(x.reshape(b, g * g, -1), model.patch_w)
    cls = model.class_embedding.to(x.dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + model.positional_embedding.to(x.dtype)
    x = layer_norm(x, model.ln_pre_scale, model.ln_pre_bias, cfg.ln_eps)
    return _blocks_and_head(model, x, return_all_features)


def clip_vit_forward_audio(model: ClipVisionTransformer, tokens: torch.Tensor,
                           return_all_features: bool = True,
                           compute_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Pre-embedded tokens (B, L, width) through the blocks and the head
    only (clip_vit.py:115-130)."""
    return _blocks_and_head(model, tokens.to(compute_dtype),
                            return_all_features)


def _visual(sd: Mapping) -> Tuple[Mapping, str]:
    """The vision keys without the jit archive's `visual.` prefix."""
    if any(k.startswith("visual.") for k in sd):
        return {k[len("visual."):]: v for k, v in sd.items()
                if k.startswith("visual.")}, "visual."
    return sd, ""


def clip_vit_from_torch(sd: Mapping, cfg: ClipVitConfig
                        ) -> Dict[str, torch.Tensor]:
    """The tower's state dict from an OpenAI CLIP state dict, in module keys
    (`conv1.weight`, `transformer.resblocks.N...`) or the archive's
    `visual.`-prefixed keys (clip_vit.py:175-215): linears transposed to
    (in, out), the conv kernel flattened to (3·p·p, width); the adaptor
    leaves where the dict has `ada_gamma`."""
    sd, _ = _visual(sd)

    def g(k):
        return torch.as_tensor(sd[k])

    conv = g("conv1.weight")                      # (W, 3, p, p)
    out = {
        "patch_w": conv.reshape(conv.shape[0], -1).T,
        "class_embedding": g("class_embedding"),
        "positional_embedding": g("positional_embedding"),
        "ln_pre_scale": g("ln_pre.weight"), "ln_pre_bias": g("ln_pre.bias"),
        "ln_post_scale": g("ln_post.weight"),
        "ln_post_bias": g("ln_post.bias"),
        "proj": g("proj"),
    }
    for i in range(cfg.layers):
        pfx = f"transformer.resblocks.{i}."
        leaves = {
            "ln1_scale": g(pfx + "ln_1.weight"), "ln1_bias": g(pfx + "ln_1.bias"),
            "qkv_w": g(pfx + "attn.in_proj_weight").T,
            "qkv_b": g(pfx + "attn.in_proj_bias"),
            "proj_w": g(pfx + "attn.out_proj.weight").T,
            "proj_b": g(pfx + "attn.out_proj.bias"),
            "ln2_scale": g(pfx + "ln_2.weight"), "ln2_bias": g(pfx + "ln_2.bias"),
            "fc_w": g(pfx + "mlp.c_fc.weight").T,
            "fc_b": g(pfx + "mlp.c_fc.bias"),
            "cproj_w": g(pfx + "mlp.c_proj.weight").T,
            "cproj_b": g(pfx + "mlp.c_proj.bias"),
        }
        if pfx + "ada_gamma" in sd:
            leaves.update({
                "ada_ln_scale": g(pfx + "ada_ln_2.weight"),
                "ada_ln_bias": g(pfx + "ada_ln_2.bias"),
                "ada_fc_w": g(pfx + "ada_mlp.c_fc.weight").T,
                "ada_fc_b": g(pfx + "ada_mlp.c_fc.bias"),
                "ada_cproj_w": g(pfx + "ada_mlp.c_proj.weight").T,
                "ada_cproj_b": g(pfx + "ada_mlp.c_proj.bias"),
                "ada_gamma": g(pfx + "ada_gamma"),
            })
        out.update({f"blocks.{i}.{k}": v for k, v in leaves.items()})
    return {k: v.contiguous() for k, v in out.items()}


def clip_vit_config_from_state_dict(sd: Mapping,
                                    resolution: Optional[int] = None
                                    ) -> ClipVitConfig:
    """The geometry of an OpenAI CLIP state dict (clip_vit.py:218-238):
    width from conv1, depth from the in-proj count, patch from the conv
    kernel, heads = width / 64, the grid from the positional embedding
    unless `resolution` is given."""
    vis, _ = _visual(sd)
    conv = vis["conv1.weight"]
    layers = len([k for k in vis if k.startswith("transformer.")
                  and k.endswith(".attn.in_proj_weight")])
    width, patch = int(conv.shape[0]), int(conv.shape[-1])
    grid = round((vis["positional_embedding"].shape[0] - 1) ** 0.5)
    return ClipVitConfig(
        input_resolution=resolution or grid * patch, patch_size=patch,
        width=width, layers=layers, heads=width // 64,
        output_dim=int(vis["proj"].shape[1]),
    )


def _is_torchscript(path: str) -> bool:
    """A TorchScript archive (OpenAI's released files) holds constants.pkl;
    a `torch.save` file does not."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.rsplit("/", 1)[-1] == "constants.pkl"
                   for n in z.namelist())


def load_openai_clip(path: str, resolution: Optional[int] = None,
                     adaptor_layers: int = 0
                     ) -> Tuple[Dict[str, torch.Tensor], ClipVitConfig]:
    """Read an OpenAI CLIP weight file — a torch.jit archive or a plain
    state-dict file, as the reference branches (clip_vit.py:241-285) — on
    the CPU, infer its config, resize the positional embedding's patch grid
    to `resolution` bilinearly (align_corners=False, CLS kept) and convert.
    → (the tower's state dict, ClipVitConfig)."""
    if _is_torchscript(path):
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    else:
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    sd = dict(sd)
    cfg = dataclasses.replace(clip_vit_config_from_state_dict(sd, resolution),
                              adaptor_layers=adaptor_layers)
    _, pfx = _visual(sd)
    key = pfx + "positional_embedding"
    pos = torch.as_tensor(sd[key])
    grid = cfg.input_resolution // cfg.patch_size
    src = round((pos.shape[0] - 1) ** 0.5)
    if src != grid:
        body = pos[1:].reshape(src, src, -1).permute(2, 0, 1)
        body = interp_bilinear_2d(body[None], (grid, grid))[0]
        sd[key] = torch.cat([pos[:1],
                             body.permute(1, 2, 0).reshape(grid * grid, -1)])
    return clip_vit_from_torch(sd, cfg), cfg
