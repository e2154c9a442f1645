"""Swin Transformer family (counterpart of `mico_tpu/models/swin.py`): the 2D
Swin (MiCo's `swin_*` vision tower, and `swin_encode_audio`) and the 3D
VideoSwin (VAST's `videoswin_*` video tower).

  - Window attention with the relative-position bias gathered through a
    host-built index (`relative_position_index`), shifted windows with the
    region mask (`shift_attn_mask`, -100 between tokens of different source
    regions), both built on the host in numpy and cached per (dims, window,
    shift), then per device.
  - A block pads its grid to window multiples, rolls by the shift, attends
    window by window and undoes both; on an axis not larger than the window
    the window shrinks to the axis and the shift is 0 (swin.py:286-290).
  - PatchMerging (2x2 neighbours → LN → a bias-free linear to 2C) pads an
    odd H or W; VideoSwin merges over H and W only, frame by frame.
  - The conv patch embeds are reshapes and one matmul: Swin's kernel =
    stride = patch, VideoSwin's temporal patch a slab of `patch_size[0]`
    frames sliding at `time_stride` over the clip padded by one frame.

No Pallas kernel computes these towers in the JAX package (the window
attention is an einsum there): the attention here is `torch.matmul` with
JAX's rounding points in the compute dtype — q scaled by hd^-½ before the
product, the scores in the compute dtype, the bias and the mask cast to it
and added, the softmax in fp32 rounded back, PV in the compute dtype.

Training (`train_rng`, a CPU `torch.Generator`) turns on the reference
regularizers from one device generator forked from it: positional dropout,
attention-probability, projection and MLP dropout, and per-sample
DropPath on both residual branches on the linear 0 → `drop_path_rate`
schedule over all blocks. Without it the forwards are the evaluation
graphs; a rate of 0 draws nothing.

Parameters keep JAX's names: `layers[i]` → `blocks[j]` → `attn`/`mlp`
groups, plus `downsample`, as nested ModuleLists. `swin_from_torch` and
`videoswin_from_torch` convert the towers' own released state dicts;
`swin_config_from_yaml` reads the reference's yacs yaml.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.ops.layers import (dropout, fork_generator, gelu,
                                       layer_norm, linear)

# ---------------------------------------------------------------------------
# configs (swin.py:56-135)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SwinConfig:
    """2D Swin (the reference's yacs defaults; the base-224-22k yaml sets
    embed_dim 128, depths (2, 2, 18, 2), heads (4, 8, 16, 32))."""

    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ape: bool = False
    patch_norm: bool = True
    ln_eps: float = 1e-5
    drop_path_rate: float = 0.1
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def patches_resolution(self) -> Tuple[int, int]:
        return (self.img_size // self.patch_size,
                self.img_size // self.patch_size)


SWIN_CONFIGS = {
    "swin_base_patch4_window7_224_22k": SwinConfig(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_tiny_patch4_window7_224": SwinConfig(),
}


@dataclass(frozen=True)
class VideoSwinConfig:
    """3D VideoSwin (the reference's defaults, Swin-B K600)."""

    patch_size: Tuple[int, int, int] = (2, 4, 4)
    in_chans: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_norm: bool = True
    time_stride: int = 1
    ln_eps: float = 1e-5
    drop_path_rate: float = 0.2
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))


VIDEOSWIN_CONFIGS = {
    # VAST's Swin-B with time_stride 1
    "videoswin_base": VideoSwinConfig(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}


# ---------------------------------------------------------------------------
# host-built index and mask (swin.py:144-198)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def relative_position_index(window: Tuple[int, ...]) -> np.ndarray:
    """(Nw, Nw) index into the (∏(2w−1), heads) bias table of every pair of
    a window's tokens, by their relative coordinates."""
    coords = np.stack(
        np.meshgrid(*[np.arange(w) for w in window], indexing="ij")
    ).reshape(len(window), -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    strides, s = [], 1
    for w in reversed(window):
        strides.append(s)
        s *= 2 * w - 1
    strides = list(reversed(strides))
    for i, w in enumerate(window):
        rel[:, :, i] += w - 1
        rel[:, :, i] *= strides[i]
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def shift_attn_mask(dims: Tuple[int, ...], window: Tuple[int, ...],
                    shift: Tuple[int, ...]) -> Optional[np.ndarray]:
    """(nW, Nw, Nw) fp32 mask of a shifted grid: -100 between tokens of
    different source regions (9 in 2D, 27 in 3D), 0 within one; None when
    nothing is shifted."""
    if not any(shift):
        return None
    img = np.zeros(dims, np.int32)
    slices = [(slice(0, -w), slice(-w, -s), slice(-s, None)) if s > 0
              else (slice(None),) for w, s in zip(window, shift)]
    for cnt, idx in enumerate(np.ndindex(*[len(s) for s in slices])):
        img[tuple(slices[a][i] for a, i in enumerate(idx))] = cnt
    wins = window_partition(torch.from_numpy(img[None, ..., None]), window)
    wins = wins.reshape(wins.shape[0], -1).numpy()
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _on_device(kind: str, args: tuple, device: torch.device):
    """The index or the mask, as a tensor on `device` (copied once)."""
    a = (relative_position_index(*args) if kind == "index"
         else shift_attn_mask(*args))
    return None if a is None else torch.from_numpy(a).to(device)


def window_partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, *dims, C) → (B·nW, *window, C); dims divisible by window."""
    b, c = x.shape[0], x.shape[-1]
    dims = x.shape[1:-1]
    shape = [b]
    for d, w in zip(dims, window):
        shape += [d // w, w]
    nd = len(dims)
    perm = ([0] + [1 + 2 * i for i in range(nd)]
            + [2 + 2 * i for i in range(nd)] + [2 * nd + 1])
    return x.reshape(*shape, c).permute(perm).reshape(-1, *window, c)


def window_reverse(wins: torch.Tensor, window, b: int, dims) -> torch.Tensor:
    """The inverse of `window_partition`."""
    c = wins.shape[-1]
    nd = len(dims)
    n = [d // w for d, w in zip(dims, window)]
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    perm += [2 * nd + 1]
    return wins.reshape(b, *n, *window, c).permute(perm).reshape(b, *dims, c)


# ---------------------------------------------------------------------------
# blocks (swin.py:238-339)
# ---------------------------------------------------------------------------


def drop_path(x: torch.Tensor, rate: float,
              gen: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth over the leading axis: kept samples
    scaled by 1 / keep (keep rounded to x's dtype), the rest zeroed;
    identity with no generator or a rate of 0."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=gen, device=x.device) < keep
    keep_x = torch.tensor(keep, dtype=x.dtype).item()
    return torch.where(mask, x / keep_x, 0.0)


def _mlp(p: ParamGroup, x: torch.Tensor, gen, drop: float) -> torch.Tensor:
    """fc1 → GELU → dropout → fc2 → dropout."""
    h = dropout(gelu(linear(x, p.get("fc1_w"), p.get("fc1_b"))), drop, gen)
    return dropout(linear(h, p.get("fc2_w"), p.get("fc2_b")), drop, gen)


def window_attention(p: ParamGroup, x: torch.Tensor, window, num_heads: int,
                     mask: Optional[torch.Tensor], gen=None,
                     attn_drop: float = 0.0,
                     proj_drop: float = 0.0) -> torch.Tensor:
    """x (B_, Nw, C) windows; mask (nW, Nw, Nw) or None (swin.py:245-276)."""
    b_, n, c = x.shape
    hd = c // num_heads
    qkv = linear(x, p.get("qkv_w"), p.get("qkv_b"))
    q, k, v = qkv.reshape(b_, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    attn = torch.matmul(q * hd ** -0.5, k.transpose(-1, -2))
    idx = _on_device("index", (tuple(window),), x.device)
    bias = p.get("rel_bias_table")[idx.reshape(-1)]
    bias = bias.reshape(n, n, num_heads).permute(2, 0, 1)
    attn = attn + bias[None].to(attn.dtype)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.reshape(b_ // nw, nw, num_heads, n, n)
        attn = attn + mask[None, :, None].to(attn.dtype)
        attn = attn.reshape(b_, num_heads, n, n)
    attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
    attn = dropout(attn, attn_drop, gen)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
    out = linear(out, p.get("proj_w"), p.get("proj_b"))
    return dropout(out, proj_drop, gen)


def swin_block(p: "SwinBlock", x: torch.Tensor, dims, window, shift,
               num_heads: int, eps: float, gen=None, dp_rate: float = 0.0,
               drop: float = 0.0, attn_drop: float = 0.0) -> torch.Tensor:
    """x (B, *dims, C): LN, pad to window multiples, roll by −shift,
    window attention, undo both, DropPath'd residual; then the MLP branch
    (swin.py:279-319)."""
    b, c = x.shape[0], x.shape[-1]
    dims = tuple(dims)
    window = tuple(min(w, d) for w, d in zip(window, dims))
    shift = tuple(0 if d <= w else s for s, w, d in zip(shift, window, dims))
    axes = tuple(range(1, 1 + len(dims)))

    shortcut = x
    x = layer_norm(x, p.get("norm1_scale"), p.get("norm1_bias"), eps)
    padded = tuple(-(-d // w) * w for d, w in zip(dims, window))
    if padded != dims:
        pad = []
        for pd, d in reversed(list(zip(padded, dims))):
            pad += [0, pd - d]
        x = F.pad(x, [0, 0] + pad)
    if any(shift):
        x = torch.roll(x, [-s for s in shift], dims=axes)
    mask = _on_device("mask", (padded, window, shift), x.device)
    nw_tokens = int(np.prod(window))
    wins = window_partition(x, window).reshape(-1, nw_tokens, c)
    wins = window_attention(p.attn, wins, window, num_heads, mask, gen,
                            attn_drop, drop)
    x = window_reverse(wins.reshape(-1, *window, c), window, b, padded)
    if any(shift):
        x = torch.roll(x, list(shift), dims=axes)
    if padded != dims:
        x = x[(slice(None),) + tuple(slice(0, d) for d in dims)]
    x = shortcut + drop_path(x, dp_rate, gen)
    h = layer_norm(x, p.get("norm2_scale"), p.get("norm2_bias"), eps)
    return x + drop_path(_mlp(p.mlp, h, gen, drop), dp_rate, gen)


def patch_merging(p: ParamGroup, x: torch.Tensor, eps: float) -> torch.Tensor:
    """(B, H, W, C) → (B, ⌈H/2⌉, ⌈W/2⌉, 2C); an odd H or W padded
    (swin.py:322-336)."""
    h, w = x.shape[1:3]
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    x = layer_norm(x, p.get("norm_scale"), p.get("norm_bias"), eps)
    return linear(x, p.get("reduction_w"), None)


# ---------------------------------------------------------------------------
# modules (the parameter trees of `init_swin` / `init_videoswin`)
# ---------------------------------------------------------------------------


class SwinBlock(ParamGroup):
    """norm1_{scale,bias}, attn/{qkv_w, qkv_b (when qkv_bias), proj_w,
    proj_b, rel_bias_table}, norm2_{scale,bias}, mlp/{fc1_*, fc2_*}; normal
    0.02 weights and relative table, zero biases, unit LN weights
    (swin.py:492-516)."""

    def __init__(self, init: Init, dim: int, heads: int, window,
                 mlp_hidden: int, qkv_bias: bool):
        super().__init__(norm1_scale=init.ones((dim,)),
                         norm1_bias=init.zeros((dim,)),
                         norm2_scale=init.ones((dim,)),
                         norm2_bias=init.zeros((dim,)))
        n_rel = int(np.prod([2 * w - 1 for w in window]))
        attn = dict(qkv_w=init.normal((dim, 3 * dim)))
        if qkv_bias:
            attn["qkv_b"] = init.zeros((3 * dim,))
        attn.update(proj_w=init.normal((dim, dim)),
                    proj_b=init.zeros((dim,)),
                    rel_bias_table=init.normal((n_rel, heads)))
        self.attn = ParamGroup(**attn)
        self.mlp = ParamGroup(
            fc1_w=init.normal((dim, mlp_hidden)),
            fc1_b=init.zeros((mlp_hidden,)),
            fc2_w=init.normal((mlp_hidden, dim)), fc2_b=init.zeros((dim,)))


class SwinStage(nn.Module):
    """`layers[i]`: blocks[j], and a downsample (PatchMerging) but after the
    last stage."""

    def __init__(self, init: Init, cfg, i: int, window):
        super().__init__()
        dim = int(cfg.embed_dim * 2 ** i)
        heads = cfg.num_heads[i]
        self.blocks = nn.ModuleList(
            [SwinBlock(init, dim, heads, window, int(dim * cfg.mlp_ratio),
                       cfg.qkv_bias) for _ in range(cfg.depths[i])])
        if i < cfg.num_layers - 1:
            self.downsample = ParamGroup(
                norm_scale=init.ones((4 * dim,)),
                norm_bias=init.zeros((4 * dim,)),
                reduction_w=init.normal((4 * dim, 2 * dim)))


class _SwinTower(nn.Module):
    def __init__(self, cfg, init: Init, patch_in: int, window):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.patch_embed = ParamGroup(
            w=init.normal((patch_in, e)), b=init.zeros((e,)),
            norm_scale=init.ones((e,)), norm_bias=init.zeros((e,)))
        self.layers = nn.ModuleList(
            [SwinStage(init, cfg, i, window) for i in range(cfg.num_layers)])
        # made without gradients; the training entry turns them on
        self.norm_scale = nn.Parameter(init.ones((cfg.num_features,)),
                                       requires_grad=False)
        self.norm_bias = nn.Parameter(init.zeros((cfg.num_features,)),
                                      requires_grad=False)


class SwinTransformer(_SwinTower):
    """The 2D Swin (`init_swin`, swin.py:540-559)."""

    def __init__(self, cfg: SwinConfig, init: Init):
        ws = cfg.window_size
        super().__init__(cfg, init, cfg.in_chans * cfg.patch_size ** 2,
                         (ws, ws))
        if cfg.ape:
            n = cfg.patches_resolution[0] * cfg.patches_resolution[1]
            self.absolute_pos_embed = nn.Parameter(
                init.normal((1, n, cfg.embed_dim)), requires_grad=False)


class VideoSwinTransformer(_SwinTower):
    """The 3D VideoSwin (`init_videoswin`, swin.py:562-573)."""

    def __init__(self, cfg: VideoSwinConfig, init: Init):
        super().__init__(cfg, init, cfg.in_chans * int(np.prod(cfg.patch_size)),
                         tuple(cfg.window_size))


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


def _stages(model: _SwinTower, x: torch.Tensor, dims: list, window,
            gen, merge) -> Tuple[torch.Tensor, list]:
    """Every stage's blocks (x (B, *dims, C), the odd blocks shifted by half
    a window, DropPath on the linear schedule over all blocks), each stage
    but the last followed by `merge(downsample, x, dims)`."""
    cfg = model.cfg
    dpr = np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))
    blk = 0
    for i, stage in enumerate(model.layers):
        for j, block in enumerate(stage.blocks):
            shift = ((0,) * len(window) if j % 2 == 0
                     else tuple(w // 2 for w in window))
            x = swin_block(block, x, dims, window, shift, cfg.num_heads[i],
                           cfg.ln_eps, gen, float(dpr[blk]), cfg.drop_rate,
                           cfg.attn_drop_rate)
            blk += 1
        if i < cfg.num_layers - 1:
            x, dims = merge(stage.downsample, x, dims)
    return x, dims


def swin_forward_features(model: SwinTransformer, pixels: torch.Tensor,
                          compute_dtype: torch.dtype = torch.float32,
                          train_rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """(B, 3, H, W) at `img_size` → (B, L, num_features), the final LN's
    token sequence (swin.py:342-395)."""
    cfg = model.cfg
    x = pixels.to(compute_dtype)
    b, p = x.shape[0], cfg.patch_size
    ph = cfg.patches_resolution
    x = x.reshape(b, cfg.in_chans, ph[0], p, ph[1], p)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, ph[0] * ph[1], -1)
    pe = model.patch_embed
    x = linear(x, pe.get("w"), pe.get("b"))
    if cfg.patch_norm:
        x = layer_norm(x, pe.get("norm_scale"), pe.get("norm_bias"),
                       cfg.ln_eps)
    if cfg.ape:
        x = x + model.absolute_pos_embed.to(x.dtype)
    gen = fork_generator(train_rng, x.device)
    x = dropout(x, cfg.drop_rate, gen)

    def merge(down, x, dims):
        x = patch_merging(down, x, cfg.ln_eps)
        return x, [-(-d // 2) for d in dims]

    dims = list(ph)
    x, dims = _stages(model, x.reshape(b, *dims, x.shape[-1]), dims,
                      (cfg.window_size, cfg.window_size), gen, merge)
    x = x.reshape(b, dims[0] * dims[1], -1)
    return layer_norm(x, model.norm_scale, model.norm_bias, cfg.ln_eps)


def swin_encode_audio(model: SwinTransformer, spec: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32,
                      train_rng: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """(B, 1, T, M) spectrogram → repeated to 3 channels → the features
    (swin.py:398-406)."""
    return swin_forward_features(model, spec.expand(-1, 3, -1, -1),
                                 compute_dtype, train_rng)


def videoswin_forward(model: VideoSwinTransformer, video: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32,
                      train_rng: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """(B, 3, D, H, W) → (B, num_features, D', H', W') (swin.py:413-485):
    H and W padded to patch multiples and time by one frame, always; the
    temporal patch a slab of pt frames every `time_stride`."""
    cfg = model.cfg
    x = video.to(compute_dtype)
    b, c, _, h, w = x.shape
    pt, ph, pw = cfg.patch_size
    x = F.pad(x, (0, (-w) % pw, 0, (-h) % ph, 0, 1))
    d2, h2, w2 = x.shape[2], x.shape[3] // ph, x.shape[4] // pw
    dt = (d2 - pt) // cfg.time_stride + 1
    x = x.reshape(b, c, d2, h2, ph, w2, pw).permute(0, 2, 3, 5, 1, 4, 6)
    x = x.reshape(b, d2, h2 * w2, c * ph * pw)
    slabs = torch.stack([x[:, s:s + pt] for s in
                         range(0, dt * cfg.time_stride, cfg.time_stride)],
                        dim=1)                     # (b, dt, pt, hw, cpp)
    slabs = slabs.transpose(2, 3).reshape(b, dt, h2 * w2, -1)
    pe = model.patch_embed
    x = linear(slabs, pe.get("w"), pe.get("b"))
    if cfg.patch_norm:
        x = layer_norm(x, pe.get("norm_scale"), pe.get("norm_bias"),
                       cfg.ln_eps)
    dims = [dt, h2, w2]
    x = x.reshape(b, *dims, cfg.embed_dim)
    gen = fork_generator(train_rng, x.device)
    x = dropout(x, cfg.drop_rate, gen)

    def merge(down, x, dims):
        # PatchMerging over H and W, frame by frame
        bb, dd = x.shape[:2]
        x = patch_merging(down, x.reshape(bb * dd, dims[1], dims[2], -1),
                          cfg.ln_eps)
        dims = [dd, -(-dims[1] // 2), -(-dims[2] // 2)]
        return x.reshape(bb, *dims, -1), dims

    x, _ = _stages(model, x, dims, tuple(cfg.window_size), gen, merge)
    x = layer_norm(x, model.norm_scale, model.norm_bias, cfg.ln_eps)
    return x.permute(0, 4, 1, 2, 3)


def init_swin(cfg: SwinConfig, seed: int = 0) -> SwinTransformer:
    """A freshly drawn 2D Swin on the CPU in fp32, from a
    `torch.Generator` seeded with `seed`."""
    return SwinTransformer(cfg, Init(torch.Generator().manual_seed(seed)))


def init_videoswin(cfg: VideoSwinConfig, seed: int = 0
                   ) -> VideoSwinTransformer:
    """A freshly drawn VideoSwin on the CPU in fp32, from a
    `torch.Generator` seeded with `seed`."""
    return VideoSwinTransformer(cfg,
                                Init(torch.Generator().manual_seed(seed)))


# ---------------------------------------------------------------------------
# released state dicts and the yacs config (swin.py:576-686)
# ---------------------------------------------------------------------------


def _block_from_torch(sd: Mapping, pfx: str) -> Dict:
    from mico_tpu_torch.convert import _t, as_tensor

    g = lambda k: as_tensor(sd[pfx + k])       # noqa: E731
    attn = {"qkv_w": _t(sd[pfx + "attn.qkv.weight"])}
    if pfx + "attn.qkv.bias" in sd:
        attn["qkv_b"] = g("attn.qkv.bias")
    attn.update(proj_w=_t(sd[pfx + "attn.proj.weight"]),
                proj_b=g("attn.proj.bias"),
                rel_bias_table=g("attn.relative_position_bias_table"))
    return {
        "norm1_scale": g("norm1.weight"), "norm1_bias": g("norm1.bias"),
        "attn": attn,
        "norm2_scale": g("norm2.weight"), "norm2_bias": g("norm2.bias"),
        "mlp": {"fc1_w": _t(sd[pfx + "mlp.fc1.weight"]),
                "fc1_b": g("mlp.fc1.bias"),
                "fc2_w": _t(sd[pfx + "mlp.fc2.weight"]),
                "fc2_b": g("mlp.fc2.bias")},
    }


def _stages_from_torch(sd: Mapping, cfg) -> list:
    from mico_tpu_torch.convert import _t, as_tensor

    layers = []
    for i, depth in enumerate(cfg.depths):
        stage = {"blocks": [_block_from_torch(sd, f"layers.{i}.blocks.{j}.")
                            for j in range(depth)]}
        pfx = f"layers.{i}.downsample."
        if pfx + "reduction.weight" in sd:
            stage["downsample"] = {
                "norm_scale": as_tensor(sd[pfx + "norm.weight"]),
                "norm_bias": as_tensor(sd[pfx + "norm.bias"]),
                "reduction_w": _t(sd[pfx + "reduction.weight"]),
            }
        layers.append(stage)
    return layers


def _tower_from_torch(sd: Mapping, cfg, patch_w: torch.Tensor) -> Dict:
    from mico_tpu_torch.convert import as_tensor

    params = {
        "patch_embed": {"w": patch_w,
                        "b": as_tensor(sd["patch_embed.proj.bias"])},
        "layers": _stages_from_torch(sd, cfg),
        "norm_scale": as_tensor(sd["norm.weight"]),
        "norm_bias": as_tensor(sd["norm.bias"]),
    }
    if cfg.patch_norm:
        params["patch_embed"]["norm_scale"] = as_tensor(
            sd["patch_embed.norm.weight"])
        params["patch_embed"]["norm_bias"] = as_tensor(
            sd["patch_embed.norm.bias"])
    return params


def swin_from_torch(sd: Mapping, cfg: SwinConfig) -> Dict:
    """The tower's tree from a 2D Swin state dict: torch linears transposed
    to (in, out), the conv patch embed (E, C, p, p) as a (C·p·p, E) matmul
    kernel in the forward's channel-major order. Leaves are torch tensors
    (views where they can be)."""
    from mico_tpu_torch.convert import as_tensor

    w = as_tensor(sd["patch_embed.proj.weight"])
    params = _tower_from_torch(sd, cfg, w.reshape(w.shape[0], -1).t())
    if cfg.ape and "absolute_pos_embed" in sd:
        params["absolute_pos_embed"] = as_tensor(sd["absolute_pos_embed"])
    return params


def videoswin_from_torch(sd: Mapping, cfg: VideoSwinConfig) -> Dict:
    """The tower's tree from a VideoSwin state dict: the conv3d kernel
    (E, C, pt, ph, pw) as a (pt·C·ph·pw, E) matmul kernel in the order of
    the forward's slabs."""
    from mico_tpu_torch.convert import as_tensor

    w = as_tensor(sd["patch_embed.proj.weight"])
    e, c, pt, ph, pw = w.shape
    w = w.permute(2, 1, 3, 4, 0).reshape(pt * c * ph * pw, e)
    return _tower_from_torch(sd, cfg, w)


def swin_config_from_yaml(path: str) -> SwinConfig:
    """A `SwinConfig` from the reference's yacs yaml: MODEL.SWIN.* keys
    override the defaults and DATA.IMG_SIZE sets img_size. Reads the file
    with `yaml`, imported here (no forward needs it)."""
    import yaml

    with open(path) as f:
        y = yaml.safe_load(f) or {}
    swin = (y.get("MODEL") or {}).get("SWIN") or {}
    data = y.get("DATA") or {}
    mapping = {
        "PATCH_SIZE": "patch_size", "IN_CHANS": "in_chans",
        "EMBED_DIM": "embed_dim", "DEPTHS": "depths",
        "NUM_HEADS": "num_heads", "WINDOW_SIZE": "window_size",
        "MLP_RATIO": "mlp_ratio", "QKV_BIAS": "qkv_bias",
        "APE": "ape", "PATCH_NORM": "patch_norm",
    }
    kw = {fk: (tuple(swin[yk]) if isinstance(swin[yk], list) else swin[yk])
          for yk, fk in mapping.items() if yk in swin}
    if "IMG_SIZE" in data:
        kw["img_size"] = data["IMG_SIZE"]
    return SwinConfig(**kw)
