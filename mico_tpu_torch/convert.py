"""Parameter trees into the port: from the JAX package's tree, and from the
released PyTorch checkpoints.

`params_from_jax` takes the nested dict that `mico_tpu.models.mico.init_mico`
(or its `fold_inference_params`) returns, with numpy leaves, and gives the
port's `state_dict`: the path `a/b/c` becomes the key `a.b.c`, and the
stacked depth axis of `vision_encoder/blocks/*` and `bert/layers/*` is
written out as a ModuleList index (`vision_encoder.blocks.3.qkv_w`). A list
of per-block dicts (the CLIP tower's `blocks`, `init_clip_vit`; an audio
tower's `layers`, `init_beats`/`init_ast`), and the Swin towers' nested
lists (`layers[i]` → `blocks[j]` → `attn`/`mlp`, `init_swin` /
`init_videoswin`), map onto the same ModuleList keys by their list indices;
a None leaf (Swin's `qkv_b` without a qkv bias) is no parameter. Layouts
are unchanged (linears stay (in, out)).

`eva_vit_from_torch` and `bert_from_torch` (with `models.mico.
mico_from_torch`) build that same nested tree from a released checkpoint's
state_dict (reference key surgery: inference_demo.py:29-97,
model/mico.py:250-321), as `mico_tpu/convert.py` does: linear weights
transposed to (in, out), the conv patch embed as a matmul kernel, blocks
stacked on a depth axis, the positional embedding resized bilinearly and
frame embeddings by nearest. The leaves are torch tensors in the
checkpoint's dtype, mostly views of its tensors; `mico_from_jax` places
each one on the model's device in the model's dtype with one copy.

`clip_from_jax` and `modified_resnet_from_jax` place JAX's trees of the
stand-alone towers (`init_clip`, `init_modified_resnet`, or the
`clip_from_torch` / `modified_resnet_from_torch` conversions) in the
port's `CLIP` and `ModifiedResNet` by the same keys, the EVA tower's
blocks unstacked as in MiCo.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from mico_tpu_torch.config import BertConfig, EvaVitConfig, MiCoConfig
from mico_tpu_torch.models.clip_text import CLIP
from mico_tpu_torch.models.mico import MiCo, resolve_device, stage_or_shard
from mico_tpu_torch.models.modified_resnet import ModifiedResNet
from mico_tpu_torch.ops.interpolate import interp_bilinear_2d, interp_nearest_1d
from mico_tpu_torch.parallel.partition import stage_range
from mico_tpu_torch.parallel.pipeline_parallel import check_stages
from mico_tpu_torch.parallel.tensor_parallel import leaf_split, shard

# parameter groups whose leaves carry a leading depth axis
STACKED = ("vision_encoder/blocks", "bert/layers")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, (list, tuple)):
            v = {str(i): item for i, item in enumerate(v)}
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        elif v is not None:
            out[path] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _skeleton(cfg: MiCoConfig, keys) -> MiCo:
    """A weightless (meta) MiCo with the parameter names `cfg` gives, in the
    layout the state_dict keys are in: folded when they lack a parameter
    that folding removes (a pre-norm block's LN affines and q/v biases, a
    block's LayerScale). A post-norm tower without LayerScale folds to
    itself. A block with no key at all (another pipeline stage's) tells
    nothing."""
    canonical = MiCo(cfg, device="cpu", init_weights=False)
    folded = copy.deepcopy(canonical).fold_inference_params()
    removed = set(canonical.state_dict()) - set(folded.state_dict())
    held = {k.rpartition(".")[0] for k in keys}
    lost = {k for k in removed - set(keys) if k.rpartition(".")[0] in held}
    return folded if lost else canonical


def _placed(leaf, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A leaf, contiguous, on `dev` in `dtype`, copied once from the host
    (a numpy leaf goes through an fp32 host copy first). To a card the
    leaf moves in its own dtype and layout and is cast there."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf, np.float32))
        if dev.type == "cpu" and dtype == torch.float32:
            return leaf
    if leaf.device != dev and dev.type != "meta":
        leaf = leaf.to(dev)
    return torch.empty(leaf.shape, dtype=dtype, device=dev).copy_(leaf)


def _part(key: str, leaf, cfg: MiCoConfig, axis):
    """This model-axis rank's part of a leaf (the leaf at model 1); under
    pipeline stages the leaf itself (a stage's blocks are whole)."""
    if axis is None or cfg.pipeline_stages > 1:
        return leaf
    split = leaf_split(key, leaf.shape, cfg.is_eva)
    if split is None:
        return leaf
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.asarray(leaf))
    return shard(leaf, split, axis)


def _keyed_leaves(params: Mapping, stacked):
    """(state_dict key, block index or None, leaf) of each leaf of a JAX
    tree: the path `a/b/c` as `a.b.c`, and a leaf of a `stacked` group (a
    depth axis first) as one key per row, `group.i.name`."""
    for path, leaf in _flatten(params).items():
        group, _, name = path.rpartition("/")
        if group in stacked:
            for i in range(leaf.shape[0]):
                yield f"{group.replace('/', '.')}.{i}.{name}", i, leaf[i]
        else:
            yield path.replace("/", "."), None, leaf


def _check_fills(sd: Mapping[str, torch.Tensor], model: torch.nn.Module):
    """Raise unless `sd` holds exactly `model`'s parameters, in its shapes."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    unplaced = sorted(set(sd) - set(want))
    unfilled = sorted(set(want) - set(sd))
    if unplaced or unfilled:
        raise KeyError(f"tree leaves with no port parameter: {unplaced}; "
                       f"port parameters with no tree leaf: {unfilled}")
    bad = [k for k, shape in want.items() if tuple(sd[k].shape) != shape]
    if bad:
        raise ValueError("shape mismatch: " + ", ".join(
            f"{k} {tuple(sd[k].shape)} vs {want[k]}" for k in bad))


def _place(params: Mapping, cfg: MiCoConfig, device="cpu",
           dtype: torch.dtype = torch.float32, mesh=None):
    """(state_dict on `device` in `dtype`, the skeleton it fills) for the
    params tree of `cfg`; under a `mesh` with a model axis, each sharded
    leaf's part alone, or at `cfg.pipeline_stages` > 1 the stage's EVA
    blocks alone (the skeleton laid out alike)."""
    dev = torch.device(device)
    axis = None if mesh is None else mesh.model_axis
    keep = range(0)
    if axis is not None and cfg.pipeline_stages > 1 and cfg.is_eva:
        check_stages(cfg, axis.size)
        keep = range(*stage_range(cfg.vision_tower_config.layers, axis.size,
                                  axis.index))
    sd: Dict[str, torch.Tensor] = {}
    for key, i, leaf in _keyed_leaves(params, STACKED):
        if keep and key.startswith("vision_encoder.blocks.") \
                and i not in keep:
            continue            # another pipeline stage's block
        sd[key] = _placed(_part(key, leaf, cfg, axis), dev, dtype)
    skeleton = _skeleton(cfg, sd)
    model = skeleton if mesh is None else stage_or_shard(skeleton, mesh)
    _check_fills(sd, model)
    return sd, model


def params_from_jax(params: Mapping, cfg: MiCoConfig, device="cpu"
                    ) -> Dict[str, torch.Tensor]:
    """The port's fp32 state_dict for the params tree of `cfg` (canonical
    or folded), on `device`. Raises on a leaf it does not place, on a port
    parameter it does not fill, and on a shape that differs."""
    return _place(params, cfg, device)[0]


def jax_leaves(state_dict: Mapping[str, torch.Tensor], cfg: MiCoConfig):
    """The JAX tree's leaves of a port state_dict, in its order, without
    copying: (path, tensors, stacked) triples, where the tensors are the
    rows of a stacked leaf (`vision_encoder/blocks/*` of an EVA tower,
    `bert/layers/*`) in depth order, or the one tensor of any other leaf.
    A CLIP tower's blocks, an audio tower's layers and a Swin tower's
    stages and blocks stay per block (`vision_encoder/blocks/<i>/*`,
    `audio_encoder/layers/<i>/*`, `vision_encoder/layers/<i>/blocks/<j>/*`),
    the lists JAX keeps for them."""
    stacked = [g for g in STACKED
               if cfg.is_eva or g != "vision_encoder/blocks"]
    groups: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, list] = {}
    for key, t in state_dict.items():
        path = key.replace(".", "/")
        for g in stacked:
            prefix = g + "/"
            if path.startswith(prefix):
                i, _, name = path[len(prefix):].partition("/")
                rows = groups.setdefault(f"{g}/{name}", {})
                rows[int(i)] = t
                out.setdefault(f"{g}/{name}", rows)
                break
        else:
            out[path] = t
    return [(path, [v[i] for i in range(len(v))], True) if isinstance(v, dict)
            else (path, [v], False) for path, v in out.items()]


def params_to_jax(state_dict: Mapping[str, torch.Tensor], cfg: MiCoConfig
                  ) -> Dict:
    """The inverse of `params_from_jax`: the JAX package's params tree
    (nested dicts of fp32 numpy leaves, the depth axis stacked; a CLIP
    tower's blocks, an audio tower's layers and a Swin tower's stages and
    blocks as lists) of a port state_dict of `cfg`."""
    tree: Dict = {}
    for path, rows, stacked in jax_leaves(state_dict, cfg):
        arrs = [r.detach().to("cpu", torch.float32).numpy() for r in rows]
        leaf = np.stack(arrs) if stacked else arrs[0]
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _as_lists(tree)


def _as_lists(node):
    """Every dict keyed 0..n-1 as the list JAX keeps there."""
    if not isinstance(node, dict):
        return node
    node = {k: _as_lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def mico_from_jax(params: Mapping, cfg: MiCoConfig, *, device="cuda",
                  dtype=None, mesh=None) -> MiCo:
    """A MiCo holding the params tree (JAX's, or a converted checkpoint's),
    on `device` in `dtype` (default `cfg.param_dtype`). Under a `mesh`
    with a model axis each rank places only its part of the sharded
    leaves, or at `cfg.pipeline_stages` > 1 only its stage's EVA blocks
    (a rank never holds the whole tower)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtypes()[0]
    sd, model = _place(params, cfg, dev, dtype, mesh)
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def _filled(skeleton: torch.nn.Module, params: Mapping, stacked,
            dev: torch.device) -> torch.nn.Module:
    """`skeleton` (made with `init_weights=False`) holding the leaves of a
    JAX tree in fp32, placed as `mico_from_jax` places them; raises as it
    does on a leaf it does not place, a parameter it does not fill or a
    shape."""
    sd = {key: _placed(leaf, dev, torch.float32)
          for key, _, leaf in _keyed_leaves(params, stacked)}
    _check_fills(sd, skeleton)
    skeleton.load_state_dict(sd, strict=True, assign=True)
    return skeleton


def clip_from_jax(params: Mapping, vision_cfg: EvaVitConfig, text_cfg, *,
                  device="cuda"):
    """A `models.clip_text.CLIP` holding JAX's CLIP tree (`init_clip`'s, or
    `clip_from_torch`'s): `visual` the EVA tower's tree with its blocks
    stacked, `text` with its `layers` list, the 0-d `logit_scale`."""
    dev = resolve_device(device)
    skeleton = CLIP(vision_cfg, text_cfg, device=dev, init_weights=False)
    return _filled(skeleton, params, ("visual/blocks",), dev)


def modified_resnet_from_jax(params: Mapping, cfg, *, device="cuda"):
    """A `models.modified_resnet.ModifiedResNet` holding JAX's tree
    (`init_modified_resnet`'s, or `modified_resnet_from_torch`'s)."""
    dev = resolve_device(device)
    skeleton = ModifiedResNet(cfg, device=dev, init_weights=False)
    return _filled(skeleton, params, (), dev)


# ---------------------------------------------------------------------------
# released PyTorch checkpoints
# ---------------------------------------------------------------------------


def to_numpy(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """Accepts torch tensors or numpy arrays; fp32 numpy copies."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v)
    return out


def as_tensor(v) -> torch.Tensor:
    """A checkpoint value as a torch tensor, sharing its memory where it
    can (a read-only numpy array is copied)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    a = np.asarray(v)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _t(w: torch.Tensor) -> torch.Tensor:
    """torch Linear weight (out, in) → (in, out), a view."""
    return as_tensor(w).t()


class _TrackedDict(dict):
    """State-dict view that records every consumed key (getitem / get) into
    a shared set, re-prefixed with the original checkpoint prefix: the
    complete-consumption audit of released-layout checkpoints (the load
    path warns about leftovers, so a silently dropped tensor shows)."""

    def __init__(self, data, consumed=None, prefix=""):
        super().__init__(data)
        self._consumed = consumed
        self._prefix = prefix

    def __getitem__(self, k):
        if self._consumed is not None:
            self._consumed.add(self._prefix + k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if self._consumed is not None and super().__contains__(k):
            self._consumed.add(self._prefix + k)
        return super().get(k, default)


def _sub(sd: Mapping, prefix: str, consumed) -> _TrackedDict:
    return _TrackedDict({k[len(prefix):]: as_tensor(v) for k, v in sd.items()
                         if k.startswith(prefix)}, consumed, prefix)


def _stacker(sd: Mapping, depth: int):
    def stack(fmt, transform=lambda x: x):
        return torch.stack([transform(sd[fmt.format(i)])
                            for i in range(depth)])
    return stack


def resize_vit_pos_embed(pos: torch.Tensor, new_grid: int) -> torch.Tensor:
    """(1, old_grid**2+1, w) → (1, new_grid**2+1, w); CLS kept, patch grid
    bilinearly resized in fp32 (reference: inference_demo.py:78-95)."""
    old_grid = int(round((pos.shape[1] - 1) ** 0.5))
    if old_grid == new_grid:
        return pos
    w = pos.shape[2]
    pos = pos.float()
    grid = pos[0, 1:].reshape(old_grid, old_grid, w).permute(2, 0, 1)
    grid = interp_bilinear_2d(grid, (new_grid, new_grid))
    rest = grid.permute(1, 2, 0).reshape(1, new_grid * new_grid, w)
    return torch.cat([pos[:, :1], rest], dim=1)


def resize_frame_embedding(emb: torch.Tensor, target_n: int) -> torch.Tensor:
    """(1, n, c) → (1, target_n, c) via torch-nearest over the frame axis
    (reference inference_demo.py:42-59)."""
    if emb.shape[1] == target_n:
        return emb
    return interp_nearest_1d(emb.transpose(1, 2), target_n).transpose(1, 2)


def eva_vit_from_torch(sd: Mapping, cfg: EvaVitConfig, prefix: str = "",
                       consumed: Optional[set] = None) -> dict:
    """The eva_vit param tree from a torch state_dict; `prefix` e.g.
    'vision_encoder.visual.'."""
    sd = _sub(sd, prefix, consumed)
    d, w = cfg.layers, cfg.width
    stack = _stacker(sd, d)

    blocks = {
        "norm1_w": stack("blocks.{}.norm1.weight"),
        "norm1_b": stack("blocks.{}.norm1.bias"),
        "norm2_w": stack("blocks.{}.norm2.weight"),
        "norm2_b": stack("blocks.{}.norm2.bias"),
        "proj_w": stack("blocks.{}.attn.proj.weight", _t),
        "proj_b": stack("blocks.{}.attn.proj.bias"),
    }
    if "blocks.0.attn.qkv.weight" in sd:
        blocks["qkv_w"] = stack("blocks.{}.attn.qkv.weight", _t)
    else:  # subln: separate q/k/v projections — pack to fused layout
        blocks["qkv_w"] = torch.stack([
            torch.cat([_t(sd[f"blocks.{i}.attn.{p}_proj.weight"])
                       for p in "qkv"], dim=1)
            for i in range(d)])
    if "blocks.0.attn.q_bias" in sd:
        blocks["q_bias"] = stack("blocks.{}.attn.q_bias")
        blocks["v_bias"] = stack("blocks.{}.attn.v_bias")
    else:
        blocks["q_bias"] = torch.zeros((d, w))
        blocks["v_bias"] = torch.zeros((d, w))

    if "blocks.0.mlp.w1.weight" in sd:  # SwiGLU
        for n in ("w1", "w2", "w3"):
            blocks[f"{n}_w"] = stack(f"blocks.{{}}.mlp.{n}.weight", _t)
            blocks[f"{n}_b"] = stack(f"blocks.{{}}.mlp.{n}.bias")
    else:
        for n in ("fc1", "fc2"):
            blocks[f"{n}_w"] = stack(f"blocks.{{}}.mlp.{n}.weight", _t)
            blocks[f"{n}_b"] = stack(f"blocks.{{}}.mlp.{n}.bias")
    if "blocks.0.mlp.ffn_ln.weight" in sd:
        blocks.update(ffn_ln_w=stack("blocks.{}.mlp.ffn_ln.weight"),
                      ffn_ln_b=stack("blocks.{}.mlp.ffn_ln.bias"))
    if "blocks.0.attn.inner_attn_ln.weight" in sd:
        blocks.update(
            inner_attn_ln_w=stack("blocks.{}.attn.inner_attn_ln.weight"),
            inner_attn_ln_b=stack("blocks.{}.attn.inner_attn_ln.bias"))
    if "blocks.0.gamma_1" in sd:
        blocks["gamma_1"] = stack("blocks.{}.gamma_1")
        blocks["gamma_2"] = stack("blocks.{}.gamma_2")
    if "blocks.0.attn.relative_position_bias_table" in sd:
        blocks["rel_pos_bias_table"] = stack(
            "blocks.{}.attn.relative_position_bias_table")

    conv = sd["patch_embed.proj.weight"]           # (w, 3, p, p)
    params = {
        "patch_embed": {"kernel": conv.reshape(w, -1).t(),  # ((c,dy,dx), w)
                        "bias": sd["patch_embed.proj.bias"]},
        "cls_token": sd["cls_token"],
        "pos_embed": resize_vit_pos_embed(sd["pos_embed"], cfg.grid_size),
        "blocks": blocks,
        "norm_w": sd["norm.weight"],
        "norm_b": sd["norm.bias"],
    }
    if "rel_pos_bias.relative_position_bias_table" in sd:
        params["rel_pos_bias_table"] = sd[
            "rel_pos_bias.relative_position_bias_table"]
    if "head.weight" in sd:
        params["head"] = {"kernel": _t(sd["head.weight"]),
                          "bias": sd["head.bias"]}
    return params


_BERT_LAYER = {
    "q": "attention.self.query", "k": "attention.self.key",
    "v": "attention.self.value", "attn_out": "attention.output.dense",
    "inter": "intermediate.dense", "out": "output.dense",
}
_BERT_LN = {"attn_ln": "attention.output.LayerNorm",
            "out_ln": "output.LayerNorm"}
_BERT_CROSS = {"xq": "crossattention.self.query",
               "xk": "crossattention.self.key",
               "xv": "crossattention.self.value",
               "x_out": "crossattention.output.dense"}


def bert_from_torch(sd: Mapping, cfg: BertConfig, prefix: str = "",
                    consumed: Optional[set] = None) -> dict:
    """The bert param tree from `multimodal_encoder.*` keys (HF-style:
    bert.embeddings.*, bert.encoder.layer.{i}.*, cls.predictions.*)."""
    sd = _sub(sd, prefix, consumed)
    stack = _stacker(sd, cfg.num_hidden_layers)
    layer = "bert.encoder.layer.{}."

    def linears(names):
        out = {}
        for short, mod in names.items():
            out[f"{short}_w"] = stack(f"{layer}{mod}.weight", _t)
            out[f"{short}_b"] = stack(f"{layer}{mod}.bias")
        return out

    layers = linears(_BERT_LAYER)
    for short, mod in _BERT_LN.items():
        layers[f"{short}_w"] = stack(f"{layer}{mod}.weight")
        layers[f"{short}_b"] = stack(f"{layer}{mod}.bias")
    if cfg.add_cross_attention:
        layers.update(linears(_BERT_CROSS))
        layers["x_ln_w"] = stack(f"{layer}crossattention.output.LayerNorm.weight")
        layers["x_ln_b"] = stack(f"{layer}crossattention.output.LayerNorm.bias")

    emb = "bert.embeddings."
    params = {
        "embeddings": {
            "word": sd[f"{emb}word_embeddings.weight"],
            "position": sd[f"{emb}position_embeddings.weight"],
            "token_type": sd[f"{emb}token_type_embeddings.weight"],
            "ln_w": sd[f"{emb}LayerNorm.weight"],
            "ln_b": sd[f"{emb}LayerNorm.bias"],
        },
        "layers": layers,
    }
    if "cls.predictions.transform.dense.weight" in sd:
        decoder_w = sd.get("cls.predictions.decoder.weight",
                           sd[f"{emb}word_embeddings.weight"])  # tied
        head = "cls.predictions."
        params["mlm_head"] = {
            "dense_w": _t(sd[f"{head}transform.dense.weight"]),
            "dense_b": sd[f"{head}transform.dense.bias"],
            "ln_w": sd[f"{head}transform.LayerNorm.weight"],
            "ln_b": sd[f"{head}transform.LayerNorm.bias"],
            "decoder_w": _t(decoder_w),
            "decoder_b": sd[f"{head}bias"],
        }
    return params
