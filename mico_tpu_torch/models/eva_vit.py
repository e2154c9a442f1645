"""EVA Vision Transformer (counterpart of `mico_tpu/models/eva_vit.py`).

The EVA01 and EVA02 families and EVA02-CLIP-bigE's post-norm blocks: conv
patch embed as reshape + one matmul in (c, dy, dx) order, CLS token +
absolute pos embed, pre-norm (x + γ·branch(LN(x))) or post-norm
(x + LN(γ·branch(x))) blocks with a packed qkv projection and q/v-only
bias, optional LayerScale γ, MLP-GELU or SwiGLU, the final LN over all
tokens and `return_all_features`. EVA02's features: 2D axial RoPE on q and
k after the CLS row (`rope_tables`, fp64 tables interpolated from
`pt_hw_seq_len` to the grid; interleaved `apply_rope`), SwiGLU
(silu(x·W1)·(x·W2)·W3), sub-LN (`inner_attn_ln` before the output
projection, `ffn_ln` before the MLP's last linear) and BEiT's
relative-position bias, per block (`use_rel_pos_bias`) or one table shared
by every block (`use_shared_rel_pos_bias`). Blocks are a ModuleList.

Routing of a block's attention (eva_vit.py:281-466 with the bf16 gates of
flash_attention.py:1186-1192, 1340, 1513, 1693), read from the knobs of
`ops/flash_attention.py` (defaults as JAX's):
  - RoPE or a relative bias, with flash attention, training or not →
    `linear` qkv → (B, H, L, D) views → RoPE → `multi_head_attention` with
    the bias: K2 (`flash_attention`; under autograd K2 forward and the
    plain recompute backward) past 64·64 scores, plain math below;
  - training (a `train_rng` is given) otherwise, with flash attention →
    (LN →) `linear` qkv → `packed_qkv_self_attention`: K3 (K9 under
    `PACKED_CLS_SPLIT` at L = 128k + 1) forward and K4 backward in bf16 on
    the card, their plain twins on the CPU and for other dtypes; never K1,
    K5 or K8 (the `is_train` gates, eva_vit.py:316, 448);
  - flash inference, pre-norm block without sub-LN, `FUSED_LN_QKV` and
    `FUSED_QKV_PROJ` on → kernel K1 (`fused_ln_qkv_self_attention`;
    affine off when the params are folded), then the output projection;
  - flash inference otherwise (a post-norm block, a sub-LN block, or a
    pre-norm one after its LN) with `FUSED_QKV_PROJ` on → K5
    (`fused_qkv_self_attention`), then sub-LN's `inner_attn_ln` and the
    output projection, or K8 (`fused_qkv_attn_proj`, both projections)
    when `FUSED_ATTN_PROJ` is on and the block has no sub-LN;
  - flash inference with `FUSED_QKV_PROJ` off → `linear` qkv →
    `packed_qkv_self_attention` (K3, or K9 under the flag), as training;
  - flash on the CPU → the same wrappers, which take their plain twins;
    flash on the card in another dtype → the twins, as the JAX gate does;
  - plain attention asked for → (LN →) linear → (RoPE →)
    `multi_head_attention`.
Training also runs PatchDropout (top-k of uniform scores, CLS exempt; the
RoPE tables gathered per sample for the kept patches) and per-sample
DropPath on the linear 0 → `drop_path_rate` schedule, drawn up front from a
device generator forked from `train_rng`, so a block under
`torch.utils.checkpoint` (`remat`) recomputes with the same masks.

`remat` checkpoints each block; `remat_policy` chooses what the backward
keeps (eva_vit.py:569-580): `save:<names>` keeps the products of the
tagged linears (`qkv`, `attn_out`, `mlp_hidden`, tagged where JAX's
`checkpoint_name` tags them) and recomputes the rest, their weight casts
included (K8's fused `attn_out` is no product of torch's: that route
recomputes it), and the names of `jax.checkpoint_policies` that take no
argument map to torch's selective checkpointing (`remat_context`).
`unroll_blocks` is a compile strategy of XLA's; the block loop here is
unrolled already, so it changes nothing.

A tower staged over pipeline stages (`parallel.pipeline_parallel.
stage_module`: this stage's blocks, `OtherStage` in the others' places)
runs its blocks through `pipelined` at `pipeline_stages` > 1
(eva_vit.py:584-620): the embedding and every draw on the rank's whole
batch first, the draws' rows and per-sample RoPE tables split with the
microbatches, the final norm after the last stage's broadcast.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from mico_tpu_torch.config import EvaVitConfig
from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.ops import flash_attention as fa
from mico_tpu_torch.ops.attention import multi_head_attention
from mico_tpu_torch.ops.layers import fork_generator, gelu, layer_norm, linear
from mico_tpu_torch.parallel.pipeline_parallel import pipelined
from mico_tpu_torch.parallel.tensor_parallel import (copy_to_model,
                                                     finish_partial,
                                                     row_parallel_linear,
                                                     sharded_layer_norm)

# the names a block tags for a `save:` remat policy (eva_vit.py:340-390)
REMAT_TAGS = ("qkv", "attn_out", "mlp_hidden")
# the tag of the ops running now (None between tagged calls)
_TAG = [None]
# the aten products of `linear`: what a `save:` policy keeps of a tagged call
_PRODUCTS = frozenset((torch.ops.aten.mm, torch.ops.aten.addmm))
# jax.checkpoint_policies names that take no argument → the aten products
# whose outputs the backward keeps
_DOT_POLICIES = {
    "nothing_saveable": (),
    "dots_saveable": ("mm", "addmm", "bmm", "baddbmm"),
    "checkpoint_dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_with_no_batch_dims_saveable": ("mm", "addmm"),
    "checkpoint_dots_with_no_batch_dims": ("mm", "addmm"),
}


def _tagged(name: str, fn, *args):
    """fn(*args), a `linear`, with the ops it runs tagged `name` (JAX's
    `checkpoint_name`): a `save:` policy naming it keeps its product."""
    prev, _TAG[0] = _TAG[0], name
    try:
        return fn(*args)
    finally:
        _TAG[0] = prev


def remat_context(policy: Optional[str]):
    """The `context_fn` of `torch.utils.checkpoint` for a remat policy, or
    None for a plain checkpoint (recompute everything). `save:a,b` keeps
    the products (`_PRODUCTS`) tagged a or b, not the casts of their
    operands; a `jax.checkpoint_policies` name keeps the
    products it names (`_DOT_POLICIES`). `everything_saveable` needs no
    checkpoint (`eva_vit_forward` runs the blocks plainly). Any other name
    raises ValueError."""
    if not policy or policy == "nothing_saveable":
        return None
    if policy.startswith("save:"):
        names = frozenset(policy[5:].split(","))

        def saved(op):
            return _TAG[0] in names and op.overloadpacket in _PRODUCTS
    elif policy in _DOT_POLICIES:
        ops = frozenset(getattr(torch.ops.aten, n)
                        for n in _DOT_POLICIES[policy])

        def saved(op):
            return op.overloadpacket in ops
    else:
        raise ValueError(
            f"remat_policy {policy!r} has no torch counterpart: use "
            f"'save:<{'|'.join(REMAT_TAGS)}>,...', 'everything_saveable' or "
            f"one of {sorted(_DOT_POLICIES)}")
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if saved(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


# ---------------------------------------------------------------------------
# EVA02: RoPE tables and BEiT's relative position (eva_vit.py:48-81, 221-252)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def rope_tables(head_dim: int, pt_seq_len: int, ft_seq_len: int,
                theta: float = 10000.0):
    """(cos, sin), each (ft_seq_len², head_dim) fp32 numpy: axial 2D rotary
    tables computed in fp64, each frequency repeated for its interleaved
    pair, positions t = arange(ft) / ft · pt (interpolated when the grid is
    not `pt_hw_seq_len`)."""
    dim = head_dim // 2
    freqs = 1.0 / (theta ** (
        np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    t = np.arange(ft_seq_len, dtype=np.float64) / ft_seq_len * pt_seq_len
    fr = np.repeat(np.einsum("i,j->ij", t, freqs), 2, axis=-1)
    full = np.concatenate([
        np.broadcast_to(fr[:, None, :], (ft_seq_len, ft_seq_len, dim)),
        np.broadcast_to(fr[None, :, :], (ft_seq_len, ft_seq_len, dim)),
    ], axis=-1).reshape(ft_seq_len * ft_seq_len, head_dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _rope_on(head_dim: int, pt_seq_len: int, ft_seq_len: int,
             device: torch.device):
    """`rope_tables` as fp32 tensors on `device` (copied once)."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in rope_tables(head_dim, pt_seq_len, ft_seq_len))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs (x0, x1) → (−x1, x0) over the last axis."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., seq, head_dim), CLS excluded by the caller: x·cos +
    rotate_half(x)·sin, the tables cast to x's dtype first."""
    return x * cos.to(x.dtype) + rotate_half(x) * sin.to(x.dtype)


def num_relative_distance(grid: int) -> int:
    """(2g−1)² in-grid offsets and 3 buckets for CLS → token, token → CLS
    and CLS → CLS."""
    return (2 * grid - 1) ** 2 + 3


@functools.lru_cache(maxsize=8)
def rel_pos_index(grid: int) -> np.ndarray:
    """(L, L) int bucket index over the CLS + grid² token sequence."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (grid - 1)
    flat = rel[:, :, 0] * (2 * grid - 1) + rel[:, :, 1]
    n = num_relative_distance(grid)
    idx = np.zeros((grid * grid + 1, grid * grid + 1), np.int32)
    idx[1:, 1:] = flat
    idx[0, :] = n - 3
    idx[:, 0] = n - 2
    idx[0, 0] = n - 1
    return idx


@functools.lru_cache(maxsize=16)
def _rel_index_on(grid: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rel_pos_index(grid).astype(np.int64)).to(device)


def rel_pos_bias_from_table(table: torch.Tensor, grid: int) -> torch.Tensor:
    """(num_relative_distance, H) table → the additive (1, H, L, L)
    attention bias, in the table's dtype."""
    idx = _rel_index_on(grid, table.device)
    bias = table[idx.reshape(-1)].reshape(*idx.shape, -1)
    return bias.permute(2, 0, 1)[None]


def _with_rope(t: torch.Tensor, rope) -> torch.Tensor:
    """RoPE on every row of t (B, H, L, D) but the CLS row."""
    if rope is None:
        return t
    return torch.cat([t[:, :, :1], apply_rope(t[:, :, 1:], *rope)], dim=2)


class EvaBlock(ParamGroup):
    """One pre-norm or post-norm block; parameter names as in the JAX
    `blocks/*` tree (eva_vit.py:98-156): the MLP's fc1/fc2, or SwiGLU's
    w1/w2/w3 and, with sub-LN, ffn_ln over the hidden width and
    inner_attn_ln over the width; a per-block relative table under
    `use_rel_pos_bias`.

    Under tensor parallelism (`tp`, set by
    `parallel.tensor_parallel.shard_module`) the block holds this rank's
    heads and hidden columns: every route takes the local head count (from
    qkv_w's columns), the column-parallel inputs pass `copy_to_model`, the
    row-parallel outputs (proj, fc2, w3; K8's fp32 partial) are summed over
    the model group before LayerScale, the post-norm LN and the residual,
    and sub-LN's two LNs take their statistics over the whole width."""

    tp = None

    def __init__(self, cfg: EvaVitConfig, init: Init, layer_id: int):
        w, h = cfg.width, cfg.mlp_hidden
        rescale = math.sqrt(2.0 * (layer_id + 1))   # fix_init_weight
        tensors = dict(
            norm1_w=init.ones((w,)), norm1_b=init.zeros((w,)),
            norm2_w=init.ones((w,)), norm2_b=init.zeros((w,)),
            qkv_w=init.trunc((w, 3 * w)),
            q_bias=init.zeros((w,)), v_bias=init.zeros((w,)),
            proj_w=init.trunc((w, w)) / rescale,
            proj_b=init.zeros((w,)),
        )
        if cfg.naiveswiglu:
            tensors.update(
                w1_w=init.trunc((w, h)), w1_b=init.zeros((h,)),
                w2_w=init.trunc((w, h)), w2_b=init.zeros((h,)),
                w3_w=init.trunc((h, w)) / rescale, w3_b=init.zeros((w,)))
        else:
            tensors.update(
                fc1_w=init.trunc((w, h)), fc1_b=init.zeros((h,)),
                fc2_w=init.trunc((h, w)) / rescale, fc2_b=init.zeros((w,)))
        if cfg.subln:
            tensors.update(
                ffn_ln_w=init.ones((h,)), ffn_ln_b=init.zeros((h,)),
                inner_attn_ln_w=init.ones((w,)),
                inner_attn_ln_b=init.zeros((w,)))
        if cfg.ls_init_value is not None:
            tensors["gamma_1"] = init.full((w,), cfg.ls_init_value)
            tensors["gamma_2"] = init.full((w,), cfg.ls_init_value)
        if cfg.use_rel_pos_bias:
            tensors["rel_pos_bias_table"] = init.zeros(
                (num_relative_distance(cfg.grid_size), cfg.num_heads))
        super().__init__(**tensors)
        self.postnorm = cfg.postnorm
        self.swiglu = cfg.naiveswiglu
        self.subln = cfg.subln

    def packed_qkv_bias(self) -> torch.Tensor:
        folded = self.get("qkv_bias")
        if folded is not None:
            return folded
        q_b = self.get("q_bias")
        return torch.cat([q_b, torch.zeros_like(q_b), self.get("v_bias")])

    def local_heads(self, cfg: EvaVitConfig) -> int:
        """The heads this block computes: all, or this rank's share."""
        return self.get("qkv_w").shape[1] // (3 * cfg.head_dim)

    def forward(self, x: torch.Tensor, cfg: EvaVitConfig, attn_impl: str,
                is_train: bool = False, keep: Optional[tuple] = None,
                rope: Optional[tuple] = None,
                shared_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """keep: DropPath's (mask, keep_prob) for this block: the per-sample
        draws of the two residual branches, (2, B) bool, and the 0-d keep
        probability they were drawn against (None: no DropPath). rope: the
        (cos, sin) tables of the patch rows, (L−1, D) or per sample
        (B, 1, L−1, D) after PatchDropout; shared_bias: the shared
        relative bias (1, H, L, L)."""
        eps = cfg.ln_eps

        def residual(x, y, i):
            return x + (y if keep is None else drop_path(y, keep[0][i],
                                                         keep[1]))

        table = self.get("rel_pos_bias_table")
        bias = (shared_bias if table is None
                else rel_pos_bias_from_table(table, cfg.grid_size))
        g1, b1 = self.get("norm1_w"), self.get("norm1_b")
        g2, b2 = self.get("norm2_w"), self.get("norm2_b")
        if self.postnorm:             # eva_vit.py:451-457
            y = self._scaled(self._attention(x, cfg, attn_impl, is_train,
                                             rope, bias), "gamma_1")
            x = residual(x, layer_norm(y, g1, b1, eps), 0)
            y = self._scaled(self._mlp(x, eps, cfg.mlp_hidden), "gamma_2")
            return residual(x, layer_norm(y, g2, b2, eps), 1)
        if (attn_impl == "flash" and not is_train and fa.FUSED_LN_QKV
                and fa.FUSED_QKV_PROJ and rope is None and bias is None
                and not self.subln):            # `_ln_fusable`, :438-449
            args = (copy_to_model(x, self.tp), g1, b1,
                    self.get("qkv_w").to(x.dtype), self.packed_qkv_bias(),
                    self.local_heads(cfg), cfg.head_dim ** -0.5, eps,
                    g1 is not None)
            o = (fa.fused_ln_qkv_self_attention(*args) if fa.kernel_route(x)
                 else fa.fused_ln_qkv_plain(*args))
            y = _tagged("attn_out", row_parallel_linear, o,
                        self.get("proj_w"), self.get("proj_b"), self.tp)
        else:
            y = self._attention(layer_norm(x, g1, b1, eps), cfg, attn_impl,
                                is_train, rope, bias)
        x = residual(x, self._scaled(y, "gamma_1"), 0)
        y = self._mlp(layer_norm(x, g2, b2, eps), eps, cfg.mlp_hidden)
        return residual(x, self._scaled(y, "gamma_2"), 1)

    def _attention(self, h: torch.Tensor, cfg: EvaVitConfig, attn_impl: str,
                   is_train: bool, rope=None, bias=None) -> torch.Tensor:
        """The attention branch on its input h, output projection included
        (`attention`, eva_vit.py:298-377): with RoPE or a relative bias the
        split heads through `multi_head_attention` (K2 under flash); else
        K5 or K8 at flash inference under `FUSED_QKV_PROJ` (K8 refused
        under sub-LN); else, with flash, the packed K3/K9 route (K4 in
        training); else plain. Sub-LN's inner_attn_ln runs before the
        output projection."""
        nh, hd = self.local_heads(cfg), cfg.head_dim
        w_qkv, qkv_bias = self.get("qkv_w"), self.packed_qkv_bias()
        plain_heads = rope is not None or bias is not None
        h = copy_to_model(h, self.tp)
        if (attn_impl == "flash" and not is_train and fa.FUSED_QKV_PROJ
                and not plain_heads):
            args = (h, w_qkv.to(h.dtype), qkv_bias, nh, hd ** -0.5)
            kernel = fa.kernel_route(h)
            if fa.FUSED_ATTN_PROJ and not self.subln:
                args = args[:3] + (self.get("proj_w").to(h.dtype),
                                   self.get("proj_b")) + args[3:]
                if self.tp is not None:     # row-parallel: the fp32 form
                    part = (fa.fused_qkv_attn_proj(*args, partial=True)
                            if kernel else
                            fa.fused_qkv_attn_proj_plain(*args, partial=True))
                    return finish_partial(part, self.get("proj_b"), self.tp,
                                          h.dtype)
                return (fa.fused_qkv_attn_proj(*args) if kernel
                        else fa.fused_qkv_attn_proj_plain(*args))
            o = (fa.fused_qkv_self_attention(*args) if kernel
                 else fa.fused_qkv_plain(*args))
        elif attn_impl == "flash" and not plain_heads:
            o = fa.packed_qkv_self_attention(
                _tagged("qkv", linear, h, w_qkv, qkv_bias), nh, hd ** -0.5)
        else:
            # v stays a strided view of the product and q, k the rotated
            # copies: K2 takes them as they are (unit last stride)
            b, l, _ = h.shape
            qkv = _tagged("qkv", linear, h, w_qkv, qkv_bias)
            q, k, v = qkv.reshape(b, l, 3, nh, hd).permute(2, 0, 3, 1, 4)
            o = multi_head_attention(_with_rope(q, rope), _with_rope(k, rope),
                                     v, bias=bias, scale=hd ** -0.5,
                                     impl=attn_impl)
            o = o.transpose(1, 2).reshape(b, l, nh * hd)
        if self.subln:
            o = sharded_layer_norm(o, self.get("inner_attn_ln_w"),
                                   self.get("inner_attn_ln_b"), cfg.ln_eps,
                                   cfg.width, self.tp)
        return _tagged("attn_out", row_parallel_linear, o,
                       self.get("proj_w"), self.get("proj_b"), self.tp)

    def _mlp(self, h: torch.Tensor, eps: float, hidden: int) -> torch.Tensor:
        """MLP-GELU (fc1 tagged `mlp_hidden`) or SwiGLU; sub-LN's ffn_ln
        (over all `hidden` columns) before the last linear
        (eva_vit.py:380-397)."""
        h = copy_to_model(h, self.tp)
        if self.swiglu:
            hh = (F.silu(linear(h, self.get("w1_w"), self.get("w1_b")))
                  * linear(h, self.get("w2_w"), self.get("w2_b")))
            last = "w3"
        else:
            hh = gelu(_tagged("mlp_hidden", linear, h, self.get("fc1_w"),
                              self.get("fc1_b")))
            last = "fc2"
        if self.subln:
            hh = sharded_layer_norm(hh, self.get("ffn_ln_w"),
                                    self.get("ffn_ln_b"), eps, hidden,
                                    self.tp)
        return row_parallel_linear(hh, self.get(f"{last}_w"),
                                   self.get(f"{last}_b"), self.tp)

    def _scaled(self, y: torch.Tensor, key: str) -> torch.Tensor:
        gamma = self.get(key)
        return y if gamma is None else y * gamma.to(y.dtype)

    def fold_inference_params(self) -> None:
        """In place (eva_vit.py:159-213), computed in fp32 and stored back in
        the parameters' dtype: in a pre-norm block the LN affines into the
        matmuls they feed (norm2 into both of SwiGLU's w1 and w2); sub-LN's
        inner_attn_ln into proj and ffn_ln into the MLP's last linear; then
        LayerScale into the matmul that produces it. A post-norm block's LNs
        feed no matmul and stay."""
        dt = self.get("qkv_w").dtype

        def f32(name):
            return self.drop(name).float()

        def fold(ln, *stems):
            """LN (γ, β) feeding each of `stems`: its input rows scaled by
            γ, β absorbed through the weight into the bias."""
            g, beta = f32(f"{ln}_w"), f32(f"{ln}_b")
            for stem in stems:
                w, b = f32(f"{stem}_w"), f32(f"{stem}_b")
                self.put(f"{stem}_b", (b + beta @ w).to(dt))
                self.put(f"{stem}_w", (w * g[:, None]).to(dt))

        last = "w3" if self.swiglu else "fc2"
        if not self.postnorm:
            n1w, n1b = f32("norm1_w"), f32("norm1_b")
            q_b, v_b = f32("q_bias"), f32("v_bias")
            qkv_w = f32("qkv_w")
            qkv_bias = (torch.cat([q_b, torch.zeros_like(q_b), v_b])
                        + n1b @ qkv_w)
            self.put("qkv_bias", qkv_bias.to(dt))
            self.put("qkv_w", (qkv_w * n1w[:, None]).to(dt))
            fold("norm2", *(("w1", "w2") if self.swiglu else ("fc1",)))
        if self.subln:
            fold("inner_attn_ln", "proj")
            fold("ffn_ln", last)
        for gamma_key, stem in (("gamma_1", "proj"), ("gamma_2", last)):
            if self.get(gamma_key) is not None:
                gam = f32(gamma_key)
                self.put(f"{stem}_w", (f32(f"{stem}_w") * gam[None, :]).to(dt))
                self.put(f"{stem}_b", (f32(f"{stem}_b") * gam).to(dt))


class EvaVisionTransformer(nn.Module):
    """Parameter tree: patch_embed/{kernel,bias}, cls_token, pos_embed,
    blocks[i]/*, norm_w, norm_b, head/{kernel,bias}, and the shared
    rel_pos_bias_table under `use_shared_rel_pos_bias`."""

    def __init__(self, cfg: EvaVitConfig, init: Init):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = ParamGroup(
            kernel=init.trunc((3 * cfg.patch_size ** 2, w)),
            bias=init.zeros((w,)),
        )
        # made without gradients; the training entry turns them on
        self.cls_token = nn.Parameter(init.trunc((1, 1, w)), requires_grad=False)
        self.pos_embed = nn.Parameter(init.trunc((1, cfg.seq_len, w)),
                                      requires_grad=False)
        self.blocks = nn.ModuleList(
            [EvaBlock(cfg, init, i) for i in range(cfg.layers)]
        )
        self.norm_w = nn.Parameter(init.ones((w,)), requires_grad=False)
        self.norm_b = nn.Parameter(init.zeros((w,)), requires_grad=False)
        self.head = ParamGroup(kernel=init.trunc((w, cfg.embed_dim)),
                               bias=init.zeros((cfg.embed_dim,)))
        if cfg.use_shared_rel_pos_bias:
            self.rel_pos_bias_table = nn.Parameter(init.zeros(
                (num_relative_distance(cfg.grid_size), cfg.num_heads)),
                requires_grad=False)

    def fold_inference_params(self) -> None:
        """In place, every block (eva_vit.fold_inference_params); the final
        norm stays (its output is the model output)."""
        for blk in self.blocks:
            blk.fold_inference_params()


def patch_embed(pe: ParamGroup, cfg: EvaVitConfig,
                pixels: torch.Tensor) -> torch.Tensor:
    """pixels (B, 3, H, W) → tokens (B, num_patches, width): the conv with
    kernel = stride = patch as one matmul over patches flattened in
    (c, dy, dx) order (no cuDNN, whose fp32 convolutions run in TF32)."""
    b = pixels.shape[0]
    p, g = cfg.patch_size, cfg.grid_size
    x = pixels.reshape(b, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, g * g, 3 * p * p)
    return linear(x, pe.get("kernel"), pe.get("bias"))


def drop_path_rates(cfg: EvaVitConfig, device=None) -> torch.Tensor:
    """The per-block DropPath rates, linear from 0 to `drop_path_rate` over
    the blocks, in fp32 as `jnp.linspace` gives them (eva_vit.py:542)."""
    return torch.linspace(0.0, cfg.drop_path_rate, cfg.layers,
                          dtype=torch.float32, device=device)


def drop_path(y: torch.Tensor, keep: torch.Tensor,
              keep_prob: torch.Tensor) -> torch.Tensor:
    """Stochastic depth on a residual branch (eva_vit.py:270-278): sample b
    of y (B, L, W) is scaled by 1 / keep_prob (rounded to y's dtype, as JAX
    divides in it) where keep[b], else zeroed."""
    return torch.where(keep[:, None, None], y / keep_prob.to(y.dtype), 0.0)


def patch_dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
                  return_index: bool = False):
    """PatchDropout (eva_vit.py:525-533): keep the CLS token and, per
    sample, the n_keep = max(1, int(n·(1 - rate))) patches with the largest
    uniform scores, in descending score order. `return_index`: also the
    kept patches' indices (B, n_keep), which gather the RoPE tables."""
    n = x.shape[1] - 1
    n_keep = max(1, int(n * (1.0 - rate)))
    scores = torch.rand((x.shape[0], n), generator=generator, device=x.device)
    keep = scores.topk(n_keep, dim=1).indices
    patches = x[:, 1:].gather(1, keep[:, :, None].expand(-1, -1, x.shape[2]))
    out = torch.cat([x[:, :1], patches], dim=1)
    return (out, keep) if return_index else out


def eva_vit_forward(
    model: EvaVisionTransformer,
    pixels: torch.Tensor,
    *,
    return_all_features: bool = True,
    compute_dtype: torch.dtype = torch.float32,
    attn_impl: str = "flash",
    remat: bool = False,
    remat_policy: Optional[str] = None,
    unroll_blocks: bool = False,
    train_rng: Optional[torch.Generator] = None,
    pipeline_stages: int = 1,
    pipeline_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """pixels (B, 3, H, W) → (B, seq_len, width) when return_all_features,
    else the pooled (B, width) (eva_vit.py:484-646). With `train_rng` (a CPU
    generator) the training route runs: PatchDropout, DropPath and the
    K3/K4 attention (K2 with RoPE or a relative bias). `remat` checkpoints each block, keeping what
    `remat_policy` names (`remat_context`; an unknown name raises
    ValueError); `unroll_blocks` is accepted with the same math.

    `pipeline_stages` > 1 takes the pipeline route (eva_vit.py:584-620):
    the tower must be staged over a model axis of that size
    (`parallel.pipeline_parallel.stage_module`, as `MiCo(mesh=)` stages
    it), else ValueError. The embedding and the draws (PatchDropout's
    scores and DropPath's (layers, 2, B) uniforms, on the rank's whole
    batch) come first, the stage's blocks run per microbatch in
    `pipelined` (`pipeline_microbatches`, or the auto choice), the shared
    relative bias computed from its table inside each stage, and the final
    norm runs after the broadcast."""
    del unroll_blocks        # the loop below is unrolled already
    if remat_policy == "everything_saveable":
        remat = False                # keep everything: no checkpoint
    context_fn = remat_context(remat_policy) if remat else None
    axis = getattr(model, "pp", None)
    if pipeline_stages > 1 and (axis is None
                                or axis.size != pipeline_stages):
        raise ValueError(
            f"pipeline parallelism: pipeline_stages={pipeline_stages} "
            f"runs the tower staged over "
            f"a mesh's model axis of {pipeline_stages} (create_mesh("
            f"model={pipeline_stages}), MiCo(mesh=)); this tower is "
            + ("whole" if axis is None else f"staged over {axis.size}"))
    if axis is not None and pipeline_stages <= 1:
        raise ValueError("a staged tower runs at pipeline_stages="
                         f"{axis.size}; gather it whole first "
                         "(pipeline_parallel.whole_tower)")
    cfg = model.cfg
    x = patch_embed(model.patch_embed, cfg, pixels.to(compute_dtype))
    b = x.shape[0]
    cls = model.cls_token.to(compute_dtype).expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + model.pos_embed.to(compute_dtype)
    rope = (_rope_on(cfg.head_dim, cfg.pt_hw_seq_len, cfg.grid_size,
                     x.device) if cfg.rope else None)
    is_train = train_rng is not None
    keeps = [None] * cfg.layers
    if is_train:
        gen = fork_generator(train_rng, x.device)
        if cfg.patch_dropout > 0.0:
            x, kept = patch_dropout(x, cfg.patch_dropout, gen,
                                    return_index=True)
            if rope is not None:     # per-sample tables (B, 1, n_keep, D)
                rope = tuple(t[kept][:, None] for t in rope)
        if cfg.drop_path_rate > 0.0:
            u = torch.rand((cfg.layers, 2, b), generator=gen, device=x.device)
            keep_prob = 1.0 - drop_path_rates(cfg, x.device)
            keeps = list(zip(u < keep_prob[:, None, None], keep_prob))

    def run_blocks(blocks, x, keeps, rope):
        shared = (rel_pos_bias_from_table(model.rel_pos_bias_table,
                                          cfg.grid_size)
                  if cfg.use_shared_rel_pos_bias else None)
        for blk, keep in zip(blocks, keeps):
            args = (x, cfg, attn_impl, is_train, keep, rope, shared)
            if remat:
                kw = {} if context_fn is None else dict(context_fn=context_fn)
                x = torch.utils.checkpoint.checkpoint(
                    blk, *args, use_reentrant=False, **kw)
            else:
                x = blk(*args)
        return x

    if axis is None:
        x = run_blocks(model.blocks, x, keeps, rope)
    else:
        x = _pipeline_blocks(model, x, keeps, rope, run_blocks,
                             pipeline_microbatches)
    if not cfg.global_average_pool:
        x = layer_norm(x, model.norm_w, model.norm_b, cfg.ln_eps)
        return x if return_all_features else x[:, 0]
    if return_all_features:
        return x
    return layer_norm(x.mean(dim=1), model.norm_w, model.norm_b, cfg.ln_eps)


def _pipeline_blocks(model: EvaVisionTransformer, x: torch.Tensor, keeps,
                     rope, run_blocks, n_micro: Optional[int]):
    """The stage's blocks of a staged tower over `pipelined`: DropPath's
    masks (B rows) and per-sample RoPE tables split with the microbatches,
    each block reading its global layer's draws."""
    a, b = model.stage_range
    masks = probs = None
    if keeps[0] is not None:             # (B, layers, 2) rows of the draws
        masks = torch.stack([k[0] for k in keeps]).permute(2, 0, 1)
        probs = [k[1] for k in keeps]
    per_sample = rope is not None and rope[0].dim() == 4

    def layer_fn(blocks, h, m, cos, sin):
        ks = ([None] * (b - a) if m is None else
              [(m[:, i].T, probs[i]) for i in range(a, b)])
        return run_blocks(blocks, h, ks, (cos, sin) if per_sample else rope)

    rows = (masks,) + (rope if per_sample else (None, None))
    return pipelined(layer_fn, model.pp, n_micro)(
        list(model.blocks)[a:b], x, *rows)
