"""CLIP's ModifiedResNet visual tower (counterpart of
`mico_tpu/models/modified_resnet.py`).

A three-conv stem with a 2 × 2 average pool, four stages of bottlenecks
whose strides are anti-aliased (a stride-1 conv, then `avg_pool2d` of the
stride, before conv3 and on the downsample shortcut), and the attention
pool: the mean token is the one query, over [mean; tokens] plus the learned
positions. Convolutions are NCHW `F.conv2d` (TF32 off: `ops.layers` sets
it at import); BatchNorm runs at inference as a per-channel scale and
shift, rsqrt(var + 1e-5) in fp32 and both cast to the activations' dtype.
No kernel of the port runs here. Parameters keep JAX's tree: `stem_conv*`,
`stem_bn*/{w,b,mean,var}`, `stages[i][j]/*` and `attnpool/*`, linears
stored (in, out).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.models.mico import resolve_device
from mico_tpu_torch.ops.attention import plain_attention
from mico_tpu_torch.ops.layers import linear

EXPANSION = 4


@dataclass(frozen=True)
class ModifiedResNetConfig:
    layers: Tuple[int, ...] = (3, 4, 6, 3)     # RN50
    output_dim: int = 1024
    heads: int = 32
    image_size: int = 224
    width: int = 64

    @property
    def embed_dim(self) -> int:
        return self.width * 32

    @property
    def pool_grid(self) -> int:
        return self.image_size // 32


def _he(init: Init, shape) -> torch.Tensor:
    """normal · sqrt(2 / fan_in) of a conv kernel (O, I, kh, kw)."""
    return init.normal(shape, (2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5)


def _bn_group(init: Init, c: int) -> ParamGroup:
    return ParamGroup(w=init.ones((c,)), b=init.zeros((c,)),
                      mean=init.zeros((c,)), var=init.ones((c,)))


def _stride(stage: int, block: int) -> int:
    return 2 if stage > 0 and block == 0 else 1


class Bottleneck(nn.Module):
    """conv1 1×1, conv2 3×3, conv3 1×1 (×4 channels) with their BNs, and
    `down_conv`/`down_bn` where the stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int, init: Init):
        super().__init__()

        def param(t):   # made without gradients
            return nn.Parameter(t, requires_grad=False)

        out = planes * EXPANSION
        self.stride = stride
        self.conv1 = param(_he(init, (planes, inplanes, 1, 1)))
        self.bn1 = _bn_group(init, planes)
        self.conv2 = param(_he(init, (planes, planes, 3, 3)))
        self.bn2 = _bn_group(init, planes)
        self.conv3 = param(_he(init, (out, planes, 1, 1)))
        self.bn3 = _bn_group(init, out)
        if stride > 1 or inplanes != out:
            self.down_conv = param(_he(init, (out, inplanes, 1, 1)))
            self.down_bn = _bn_group(init, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        out = F.relu(_bn(_conv(out, self.conv2, padding=1), self.bn2))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = _bn(_conv(out, self.conv3), self.bn3)
        if hasattr(self, "down_conv"):
            sc = x if self.stride == 1 else F.avg_pool2d(x, self.stride)
            x = _bn(_conv(sc, self.down_conv), self.down_bn)
        return F.relu(out + x)


class ModifiedResNet(nn.Module):
    """Drawn as `init_modified_resnet` draws it, from one `torch.Generator`
    seeded with `seed`, in fp32 on the CPU, then moved to `device`:
    He-normal convs, identity BNs, attention-pool positions and linears
    normal embed_dim^-0.5, zero biases. `init_weights=False` only allocates
    shapes."""

    def __init__(self, cfg: ModifiedResNetConfig = ModifiedResNetConfig(), *,
                 device="cuda", seed: int = 0, init_weights: bool = True):
        super().__init__()
        dev = resolve_device(device)
        init = Init(torch.Generator().manual_seed(seed),
                    meta=not init_weights)
        self.cfg = cfg
        w = cfg.width

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.stem_conv1 = param(_he(init, (w // 2, 3, 3, 3)))
        self.stem_bn1 = _bn_group(init, w // 2)
        self.stem_conv2 = param(_he(init, (w // 2, w // 2, 3, 3)))
        self.stem_bn2 = _bn_group(init, w // 2)
        self.stem_conv3 = param(_he(init, (w, w // 2, 3, 3)))
        self.stem_bn3 = _bn_group(init, w)
        stages, inplanes = [], w
        for si, n_blocks in enumerate(cfg.layers):
            planes = w * 2 ** si
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(inplanes, planes, _stride(si, bi),
                                         init))
                inplanes = planes * EXPANSION
            stages.append(nn.ModuleList(blocks))
        self.stages = nn.ModuleList(stages)
        c, std = cfg.embed_dim, cfg.embed_dim ** -0.5
        self.attnpool = ParamGroup(
            pos=init.normal((cfg.pool_grid ** 2 + 1, c), std),
            q_w=init.normal((c, c), std), q_b=init.zeros((c,)),
            k_w=init.normal((c, c), std), k_b=init.zeros((c,)),
            v_w=init.normal((c, c), std), v_b=init.zeros((c,)),
            c_w=init.normal((c, cfg.output_dim), std),
            c_b=init.zeros((cfg.output_dim,)),
        )
        if init_weights:
            self.to(dev)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(x: torch.Tensor, p: ParamGroup) -> torch.Tensor:
    """Inference BatchNorm from the stored statistics as x·s + b."""
    w = p.get("w").float()
    inv = torch.rsqrt(p.get("var").float() + 1e-5)
    s = (w * inv)[None, :, None, None].to(x.dtype)
    b = (p.get("b").float() - p.get("mean").float() * w * inv)
    return x * s + b[None, :, None, None].to(x.dtype)


def modified_resnet_trunk(model: ModifiedResNet, pixels: torch.Tensor,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(B, 3, H, W) → the last stage's (B, embed_dim, H/32, W/32)."""
    x = pixels.to(compute_dtype)
    for i in (1, 2, 3):
        x = _conv(x, getattr(model, f"stem_conv{i}"),
                  stride=2 if i == 1 else 1, padding=1)
        x = F.relu(_bn(x, getattr(model, f"stem_bn{i}")))
    x = F.avg_pool2d(x, 2)
    for stage in model.stages:
        for block in stage:
            x = block(x)
    return x


def attention_pool(model: ModifiedResNet, x: torch.Tensor) -> torch.Tensor:
    """The trunk's NCHW map → (N, output_dim): the mean token as the only
    query over [mean; tokens] with the learned positions (the reference
    runs every token as a query and keeps row 0: the same result)."""
    p, heads = model.attnpool, model.cfg.heads
    n, c, h, w = x.shape
    t = x.reshape(n, c, h * w).transpose(1, 2)              # (N, HW, C)
    t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
    t = t + p.get("pos").to(t.dtype)[None]
    hd = c // heads

    def split(y):
        return y.reshape(n, -1, heads, hd).transpose(1, 2)

    q = split(linear(t[:, :1], p.get("q_w"), p.get("q_b")))
    k = split(linear(t, p.get("k_w"), p.get("k_b")))
    v = split(linear(t, p.get("v_w"), p.get("v_b")))
    o = plain_attention(q, k, v, scale=hd ** -0.5)          # (N, H, 1, hd)
    return linear(o.reshape(n, c), p.get("c_w"), p.get("c_b"))


def modified_resnet_forward(model: ModifiedResNet, pixels: torch.Tensor,
                            compute_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """(B, 3, H, W) → (B, output_dim)."""
    return attention_pool(model, modified_resnet_trunk(model, pixels,
                                                       compute_dtype))


def modified_resnet_from_torch(sd: Mapping, cfg: ModifiedResNetConfig,
                               prefix: str = "") -> Dict:
    """A reference ModifiedResNet state dict → JAX's tree (the attention
    pool's linears transposed to (in, out); a block's downsample where its
    keys are); leaves are torch tensors."""
    from mico_tpu_torch.convert import as_tensor

    def g(k):
        return as_tensor(sd[prefix + k])

    def bn(name):
        return {"w": g(f"{name}.weight"), "b": g(f"{name}.bias"),
                "mean": g(f"{name}.running_mean"),
                "var": g(f"{name}.running_var")}

    params = {}
    for i in (1, 2, 3):
        params[f"stem_conv{i}"] = g(f"conv{i}.weight")
        params[f"stem_bn{i}"] = bn(f"bn{i}")
    stages = []
    for si, n_blocks in enumerate(cfg.layers):
        stage = []
        for bi in range(n_blocks):
            base = f"layer{si + 1}.{bi}"
            p = {"conv1": g(f"{base}.conv1.weight"), "bn1": bn(f"{base}.bn1"),
                 "conv2": g(f"{base}.conv2.weight"), "bn2": bn(f"{base}.bn2"),
                 "conv3": g(f"{base}.conv3.weight"), "bn3": bn(f"{base}.bn3")}
            if f"{prefix}{base}.downsample.0.weight" in sd:
                p["down_conv"] = g(f"{base}.downsample.0.weight")
                p["down_bn"] = bn(f"{base}.downsample.1")
            stage.append(p)
        stages.append(stage)
    params["stages"] = stages
    ap = "attnpool."
    params["attnpool"] = {"pos": g(ap + "positional_embedding")}
    for short, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("c", "c_proj")):
        params["attnpool"][f"{short}_w"] = g(f"{ap}{name}.weight").t()
        params["attnpool"][f"{short}_b"] = g(f"{ap}{name}.bias")
    return params
