"""MiCo omni-modal model assembly (counterpart of `mico_tpu/models/mico.py`).

One shared vision tower (EVA, the OpenAI-CLIP ViT of `models/clip_vit.py`,
or the Swin or VideoSwin of `models/swin.py`) encodes every knowledge
modality — video frames, images (1-frame videos),
audio fbank slices tiled to 3 channels, depth maps — unless the config
names one of VAST's separate audio towers (BEATs or AST, `models/audio.py`,
held as `audio_encoder`); a BERT with cross-attention is the language
interface for contrastive retrieval and ITM. `MiCo` is an `nn.Module` holding the parameters under the
JAX package's names (see `mico_tpu_torch.convert.params_from_jax`), with the
reference method surface of `MiCoModel` (mico.py:481-581).
`mico_from_torch` converts a released checkpoint's state_dict into the
parameter tree (mico.py:386-470), which `convert.mico_from_jax` places.

The forwards are module-level functions of the model, as in the JAX module
(`forward_vision_encoder`, `forward_multimodal_encoder`, `contra_head`,
`itm_head`, the condition-token functions), differentiable and taking
`train_rng` for the training regularizers; training
(`mico_tpu_torch.train`) calls them. `MiCo`'s methods of the same names are the inference entry points:
each runs its function under `torch.no_grad()`. Parameters are made without
gradients; the training entry turns `requires_grad` on.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.models import audio as audio_mod
from mico_tpu_torch.models import bert as bert_mod
from mico_tpu_torch.models import clip_vit as clip_mod
from mico_tpu_torch.models import eva_vit as vit_mod
from mico_tpu_torch.models import swin as swin_mod
from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.models.bert import BertOutput
from mico_tpu_torch.ops.interpolate import interp_nearest_1d
from mico_tpu_torch.ops.layers import gelu, layer_norm, linear
from mico_tpu_torch.parallel.pipeline_parallel import stage_module
from mico_tpu_torch.parallel.tensor_parallel import shard_module

MODALITIES = ("vision", "audio", "depth")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    another, and an error (not a silent CPU run) when CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mico_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain versions on the CPU"
        )
    return dev


def stage_or_shard(model: nn.Module, mesh) -> nn.Module:
    """In place, a whole model laid out over the mesh's model axis: at
    `cfg.pipeline_stages` > 1 its EVA tower staged (the axis carries
    stages, its size the stages'; every other leaf replicated, as JAX's
    run.py:222-225 leaves them), else sharded by tensor parallelism."""
    stages = model.cfg.pipeline_stages
    if stages > 1:
        if mesh.shape["model"] != stages:
            raise ValueError(
                f"pipeline_stages={stages} needs a mesh whose model axis is "
                f"{stages}, not {mesh.shape}")
        return stage_module(model, mesh.stage_axis)
    return shard_module(model, mesh.model_axis)


class MiCo(nn.Module):
    """MiCo with freshly drawn weights (`init_mico`, mico.py:36-86):
    trunc-normal 0.02 for the ViT, normal 0.02 for BERT and the heads, zero
    biases, unit LN weights, all from one `torch.Generator` seeded with
    `seed`. Weights are drawn on the CPU in fp32, so one seed gives one
    model on any device, then moved to `device` in `dtype` (default
    `cfg.param_dtype`); `init_device="cuda"` draws them on the card instead
    (other numbers, seconds instead of a minute at bigE's size). Under a
    `mesh` with a model axis the whole model is drawn, then each rank keeps
    its part of the sharded leaves
    (`parallel.tensor_parallel.shard_module`), or at `cfg.pipeline_stages`
    > 1 its stage's EVA blocks (`parallel.pipeline_parallel.stage_module`),
    and moves only that."""

    def __init__(self, cfg: MiCoConfig = MiCoConfig(), *, device="cuda",
                 seed: int = 0, dtype: Optional[torch.dtype] = None,
                 init_weights: bool = True, mesh=None, init_device="cpu"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=init_device).manual_seed(seed)
        init = Init(gen, meta=not init_weights)
        vd, md, cd = cfg.vision_dim, cfg.multimodal_dim, cfg.contra_dim

        def trans_head(in_dim):
            return ParamGroup(kernel=init.normal((in_dim, md)),
                              bias=init.zeros((md,)),
                              ln_w=init.ones((md,)), ln_b=init.zeros((md,)))

        def param(t):   # made without gradients; training turns them on
            return nn.Parameter(t, requires_grad=False)

        tower = {                     # `_init_vision_tower`, mico.py:105-121
            "eva": vit_mod.EvaVisionTransformer,
            "clip": clip_mod.ClipVisionTransformer,
            "swin": swin_mod.SwinTransformer,
            "videoswin": swin_mod.VideoSwinTransformer,
        }[cfg.vision_family]
        self.vision_encoder = tower(cfg.vision_tower_config, init)
        self.bert = bert_mod.Bert(cfg.bert_config, init)
        if cfg.audio_encoder_type != "shared":   # _init_audio_tower, :125-131
            tower = (audio_mod.BeatsEncoder
                     if cfg.audio_encoder_type.startswith("beats")
                     else audio_mod.AstEncoder)
            self.audio_encoder = tower(cfg.audio_tower_config, init)
        for m, in_dim in (("t", md), ("s", md), ("v", vd), ("a", cfg.audio_dim),
                          ("d", vd)):
            setattr(self, f"contra_head_{m}",
                    ParamGroup(kernel=init.normal((in_dim, cd))))
        for m, in_dim in (("va", vd + cfg.audio_dim), ("id", 2 * vd),
                          ("vs", vd + md), ("vas", vd + cfg.audio_dim + md)):
            setattr(self, f"contra_head_{m}",
                    ParamGroup(kernel=init.normal((in_dim, cd)),
                               bias=init.zeros((cd,))))
        self.contra_temp = param(init.full((), 0.07))
        self.itm_head = ParamGroup(
            fc1_w=init.normal((md, md)), fc1_b=init.zeros((md,)),
            ln_w=init.ones((md,)), ln_b=init.zeros((md,)),
            fc2_w=init.normal((md, 2)), fc2_b=init.zeros((2,)),
        )
        for m in MODALITIES:
            n = getattr(cfg, f"max_{m}_sample_num")
            setattr(self, f"{m}_frame_embedding", param(init.normal((1, n, md))))
        for m, in_dim in (("vision", vd), ("audio", cfg.audio_dim),
                          ("depth", vd), ("subtitle", md)):
            setattr(self, f"hidden_trans_{m}", trans_head(in_dim))
            setattr(self, f"{m}_type_embeddings", param(init.normal((1, 1, md))))
        if mesh is not None:
            stage_or_shard(self, mesh)
        if init_weights:
            self.to(device=dev, dtype=dtype or cfg.dtypes()[0])

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.cfg.dtypes()[1]

    @property
    def attn_impl(self) -> str:
        return "flash" if self.cfg.use_flash_attention else "plain"

    def fold_inference_params(self) -> "MiCo":
        """In place: an EVA tower's LN affines (pre-norm blocks) and
        LayerScale folded into the adjacent matmuls
        (mico.fold_inference_params); a pure reparametrization for
        inference, after which pre-norm blocks without sub-LN take kernel
        K1 with `affine=False` and post-norm blocks keep their LNs. The
        identity for a non-EVA tower (mico.py:89-102). Fold a whole model,
        then shard it: a rank's part of a row-parallel weight would fold
        only its part of a bias."""
        if getattr(self, "tp", None) or getattr(self, "pp", None):
            raise ValueError("fold_inference_params folds a whole model: "
                             "fold before sharding or staging over the "
                             "model axis")
        if self.cfg.is_eva:
            self.vision_encoder.fold_inference_params()
        return self

    # -- inference entry points (no autograd) -------------------------------

    @torch.no_grad()
    def forward_vision_encoder(self, pixels: torch.Tensor) -> torch.Tensor:
        """(b, n, 3, h, w) → (b, n, seq, vision_dim)."""
        return forward_vision_encoder(self, pixels)

    @torch.no_grad()
    def forward_audio_encoder(self, spectrograms: torch.Tensor) -> torch.Tensor:
        return forward_audio_encoder(self, spectrograms)

    @torch.no_grad()
    def forward_depth_encoder(self, depth_pixels: torch.Tensor) -> torch.Tensor:
        return forward_depth_encoder(self, depth_pixels)

    @torch.no_grad()
    def forward_multimodal_encoder(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        condition_feat: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        condition_row_index: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """BERT over the text, with cross-attention over `condition_feat`
        when given; returns the sequence output."""
        return forward_multimodal_encoder(
            self, input_ids, attention_mask, condition_feat,
            position_ids=position_ids,
            condition_row_index=condition_row_index).sequence_output

    def pool_vision_for_contra(self, feature: torch.Tensor) -> torch.Tensor:
        return pool_vision_for_contra(self.cfg, feature)

    def pool_audio_for_contra(self, feature: torch.Tensor) -> torch.Tensor:
        return pool_audio_for_contra(self.cfg, feature)

    def pool_depth_for_contra(self, feature: torch.Tensor) -> torch.Tensor:
        return pool_vision_for_contra(self.cfg, feature)

    @staticmethod
    def pool_text_for_contra(feature: torch.Tensor) -> torch.Tensor:
        return feature[:, 0]

    @torch.no_grad()
    def contra_head(self, name: str, feature: torch.Tensor) -> torch.Tensor:
        return contra_head(self, name, feature)

    @torch.no_grad()
    def itm_head(self, cls_token: torch.Tensor) -> torch.Tensor:
        return itm_head(self, cls_token)

    @torch.no_grad()
    def get_multimodal_forward_input_vision(self, vision_output):
        return condition_input(self, vision_output, "vision")

    @torch.no_grad()
    def get_multimodal_forward_input_audio(self, audio_output):
        return condition_input(self, audio_output, "audio")

    @torch.no_grad()
    def get_multimodal_forward_input_depth(self, depth_output):
        return condition_input(self, depth_output, "depth")


# ---------------------------------------------------------------------------
# forwards shared by inference and training (mico.py:139-350)
# ---------------------------------------------------------------------------


def forward_vision_encoder(model: MiCo, pixels: torch.Tensor,
                           train_rng: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """(b, n, 3, h, w) → (b, n, seq, vision_dim) (mico.py:139-196): frames
    folded into the batch for one pass of the EVA, CLIP or Swin tower; the
    VideoSwin tower takes the clip as one (b, 3, n, h, w) volume and gives
    (b, D', H'·W', C), its tokens per temporal patch. train_rng (a CPU
    generator) runs the EVA and Swin towers' training routes; the CLIP
    tower has no training regularizers, as in JAX (mico.py:167-173): it
    runs the same forward with or without train_rng."""
    cfg = model.cfg
    family = cfg.vision_family
    if family == "videoswin":
        vol = swin_mod.videoswin_forward(
            model.vision_encoder, pixels.transpose(1, 2),
            compute_dtype=model.compute_dtype, train_rng=train_rng)
        bb, c, d = vol.shape[:3]
        return vol.permute(0, 2, 3, 4, 1).reshape(bb, d, -1, c)
    b, n = pixels.shape[:2]
    flat = pixels.reshape(b * n, *pixels.shape[2:])
    if family == "clip":
        tokens = clip_mod.clip_vit_forward(
            model.vision_encoder, flat, return_all_features=True,
            compute_dtype=model.compute_dtype)
        return tokens.reshape(b, n, *tokens.shape[1:])
    if family == "swin":
        tokens = swin_mod.swin_forward_features(
            model.vision_encoder, flat, compute_dtype=model.compute_dtype,
            train_rng=train_rng)
        return tokens.reshape(b, n, *tokens.shape[1:])
    tokens = vit_mod.eva_vit_forward(
        model.vision_encoder, flat, return_all_features=True,
        compute_dtype=model.compute_dtype, attn_impl=model.attn_impl,
        remat=cfg.checkpointing,
        remat_policy=cfg.remat_policy,
        unroll_blocks=cfg.unroll_blocks and train_rng is not None,
        train_rng=train_rng, pipeline_stages=cfg.pipeline_stages,
        pipeline_microbatches=cfg.pipeline_microbatches,
    )
    return tokens.reshape(b, n, *tokens.shape[1:])


def forward_audio_encoder(model: MiCo, spectrograms: torch.Tensor,
                          train_rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """(b, n, T, M) fbank slices → (b, n, seq, C) (mico.py:199-229):
    through the shared ViT, tiled to 3 channels, or the separate tower with
    the slices folded into its batch in the compute dtype (AST reads each
    slice transposed to (M, T))."""
    cfg = model.cfg
    if cfg.audio_encoder_type == "shared":
        x = spectrograms[:, :, None].expand(-1, -1, 3, -1, -1)
        return forward_vision_encoder(model, x, train_rng=train_rng)
    b, n = spectrograms.shape[:2]
    flat = spectrograms.reshape(b * n, *spectrograms.shape[2:])
    if cfg.audio_encoder_type.startswith("ast"):
        tokens = audio_mod.ast_forward(
            model.audio_encoder, flat.transpose(1, 2),
            compute_dtype=model.compute_dtype, train_rng=train_rng)
    else:
        tokens = audio_mod.beats_forward(
            model.audio_encoder, flat, compute_dtype=model.compute_dtype,
            train_rng=train_rng)
    return tokens.reshape(b, n, *tokens.shape[1:])


def forward_depth_encoder(model: MiCo, depth_pixels: torch.Tensor,
                          train_rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    return forward_vision_encoder(model, depth_pixels, train_rng=train_rng)


def forward_multimodal_encoder(
    model: MiCo,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    condition_feat: Optional[torch.Tensor] = None,
    labels: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    train_rng: Optional[torch.Generator] = None,
    condition_row_index: Optional[torch.Tensor] = None,
    data_group=None,
) -> BertOutput:
    """BERT over the text with cross-attention over `condition_feat` (no
    encoder mask) and the MLM loss for `labels` (mico.py:240-266), its
    tokens counted over `data_group`'s ranks; BERT is checkpointed per
    layer by `bert_checkpointing`, else `checkpointing`."""
    cfg = model.cfg
    return bert_mod.bert_forward(
        model.bert, input_ids, attention_mask,
        encoder_hidden_states=condition_feat,
        position_ids=position_ids,
        compute_dtype=model.compute_dtype,
        attn_impl=model.attn_impl,
        encoder_row_index=condition_row_index,
        labels=labels,
        remat=(cfg.checkpointing if cfg.bert_checkpointing is None
               else cfg.bert_checkpointing),
        train_rng=train_rng,
        data_group=data_group,
    )


def contra_head(model: MiCo, name: str, feature: torch.Tensor) -> torch.Tensor:
    hp = getattr(model, f"contra_head_{name}")
    return linear(feature, hp.get("kernel"), hp.get("bias"))


def itm_head(model: MiCo, cls_token: torch.Tensor) -> torch.Tensor:
    """Linear → GELU → LN(1e-12) → Linear(2) (mico.py:311-317)."""
    hp = model._modules["itm_head"]   # the attribute's name is a method's
    x = gelu(linear(cls_token, hp.get("fc1_w"), hp.get("fc1_b")))
    x = layer_norm(x, hp.get("ln_w"), hp.get("ln_b"), 1e-12)
    return linear(x, hp.get("fc2_w"), hp.get("fc2_b"))


def condition_input(model: MiCo, output: torch.Tensor,
                    modality: str) -> torch.Tensor:
    """(b, n, x, c) encoder tokens → (b, n·x, multimodal_dim) condition
    tokens: hidden_trans (linear + LN), the adaptive frame embedding and
    the modality type embedding (mico.py:329-350)."""
    cfg = model.cfg
    b, n = output.shape[:2]
    if cfg.pool_video:
        output = torch.cat(
            [output[:, :, :1], output[:, :, 1:].mean(dim=2, keepdim=True)],
            dim=2,
        )
    tp = getattr(model, f"hidden_trans_{modality}")
    output = linear(output, tp.get("kernel"), tp.get("bias"))
    output = layer_norm(output, tp.get("ln_w"), tp.get("ln_b"), 1e-12)
    if cfg.frame_embedding_type == "adaptive":
        fe = frame_embedding(getattr(model, f"{modality}_frame_embedding"), n)
        output = output + fe.to(output.dtype)[:, :, None, :]
    output = output.reshape(b, -1, cfg.multimodal_dim)
    type_emb = getattr(model, f"{modality}_type_embeddings")
    return output + type_emb.to(output.dtype)


def subtitle_condition_input(model: MiCo,
                             subtitle_output: torch.Tensor) -> torch.Tensor:
    """BERT subtitle tokens → condition tokens (mico.py:374-378)."""
    tp = model.hidden_trans_subtitle
    out = linear(subtitle_output, tp.get("kernel"), tp.get("bias"))
    out = layer_norm(out, tp.get("ln_w"), tp.get("ln_b"), 1e-12)
    return out + model.subtitle_type_embeddings.to(out.dtype)


def pool_frames_for_contra(feature: torch.Tensor,
                           patch_mean: bool = False) -> torch.Tensor:
    """(b, n, x, c): the CLS token of each frame (the CLIP/EVA rule), or
    with `patch_mean` the mean over its tokens, then the mean over frames
    (mico.py:274-281)."""
    per_frame = feature.mean(dim=2) if patch_mean else feature[:, :, 0]
    return per_frame.mean(dim=1)


def pool_vision_for_contra(cfg: MiCoConfig,
                           feature: torch.Tensor) -> torch.Tensor:
    """Swin and VideoSwin have no CLS token: the mean over each frame's
    tokens; the EVA and CLIP towers keep their CLS (mico.py:284-288). Depth
    pools by the same rule (mico.py:299)."""
    return pool_frames_for_contra(
        feature, patch_mean=cfg.vision_family in ("swin", "videoswin"))


def pool_audio_for_contra(cfg: MiCoConfig,
                          feature: torch.Tensor) -> torch.Tensor:
    """BEATs has no CLS token: the mean over its tokens; AST and the shared
    ViT keep their CLS (mico.py:291-296)."""
    return pool_frames_for_contra(
        feature, patch_mean=cfg.audio_encoder_type.startswith("beats"))


def frame_embedding(emb: torch.Tensor, n: int) -> torch.Tensor:
    """Adaptive frame embedding (1, N, C) → (1, n, C): nearest resize over
    the frame axis when n differs from N (mico.py:320-326)."""
    if emb.shape[1] == n:
        return emb
    return interp_nearest_1d(emb.transpose(1, 2), n).transpose(1, 2)


# ---------------------------------------------------------------------------
# checkpoint conversion (mico.py:386-470)
# ---------------------------------------------------------------------------


def remap_legacy_keys(sd: Mapping) -> Dict[str, object]:
    """Reference key surgery at load time (inference_demo.py:29-40):
    video→vision, evaclip_model/clip_model→vision_encoder. Values are kept
    as they are (no copies)."""
    out = {}
    for k, v in sd.items():
        if "video" in k:
            out[k.replace("video", "vision")] = v
        elif "evaclip_model" in k:
            out[k.replace("evaclip_model", "vision_encoder")] = v
        elif "clip_model" in k:
            out[k.replace("clip_model", "vision_encoder")] = v
        else:
            out[k] = v
    return out


def mico_from_torch(sd: Mapping, cfg: MiCoConfig,
                    consumed: Optional[set] = None) -> dict:
    """A full MiCo checkpoint (a flat torch state_dict, possibly legacy-keyed)
    → the parameter tree of JAX's `mico_from_torch`, with the frame
    embeddings' nearest and the positional embedding's bilinear resize of
    the reference loader (inference_demo.py:42-97). Leaves are torch tensors
    in the checkpoint's dtype.

    consumed: optional set collecting every (post-legacy-remap) key read —
    callers diff it against the checkpoint to surface leftovers instead of
    dropping tensors silently.

    A config with a separate audio tower raises ValueError: JAX's converter
    reads no `audio_encoder.*` key, so neither package fills that tower
    from a released checkpoint (`models.audio.beats_from_torch` and
    `ast_from_torch` convert the towers' own releases); such a model
    loads from a native `.npz` checkpoint. So does a config with a non-EVA
    vision tower: JAX's converter reads the EVA layout alone (mico.py:436);
    `models.swin.swin_from_torch` and `videoswin_from_torch` convert those
    towers' own releases."""
    from mico_tpu_torch import convert

    if not cfg.is_eva:
        raise ValueError(
            f"vision tower {cfg.vision_encoder_type!r}: the "
            "released-checkpoint converter reads the EVA layout alone (as "
            "JAX's mico_from_torch); load this tower from a native .npz "
            "checkpoint")
    if cfg.audio_encoder_type != "shared":
        raise ValueError(
            f"audio tower {cfg.audio_encoder_type!r}: the released-checkpoint "
            "converter reads no audio_encoder.* key (as JAX's "
            "mico_from_torch), so it would leave the tower at random "
            "weights; load a separate audio tower from a native .npz "
            "checkpoint")
    sd = convert._TrackedDict(
        {k: convert.as_tensor(v) for k, v in remap_legacy_keys(sd).items()},
        consumed)
    t = convert._t

    def lin(name, bias=True):
        p = {"kernel": t(sd[f"{name}.weight"])}
        if bias:
            p["bias"] = sd[f"{name}.bias"]
        return p

    def trans(name):
        return {"kernel": t(sd[f"{name}.0.weight"]), "bias": sd[f"{name}.0.bias"],
                "ln_w": sd[f"{name}.1.weight"], "ln_b": sd[f"{name}.1.bias"]}

    params = {
        "vision_encoder": convert.eva_vit_from_torch(
            sd, cfg.eva_config, prefix="vision_encoder.visual.",
            consumed=consumed),
        "bert": convert.bert_from_torch(
            sd, cfg.bert_config, prefix="multimodal_encoder.",
            consumed=consumed),
        "contra_temp": sd["contra_temp"].float(),
        "itm_head": {
            "fc1_w": t(sd["itm_head.linear1.weight"]),
            "fc1_b": sd["itm_head.linear1.bias"],
            "ln_w": sd["itm_head.layernorm.weight"],
            "ln_b": sd["itm_head.layernorm.bias"],
            "fc2_w": t(sd["itm_head.linear2.weight"]),
            "fc2_b": sd["itm_head.linear2.bias"],
        },
    }
    for m in MODALITIES:
        params[f"{m}_frame_embedding"] = convert.resize_frame_embedding(
            sd[f"{m}_frame_embedding"], getattr(cfg, f"max_{m}_sample_num"))
    for m in (*MODALITIES, "subtitle"):
        params[f"hidden_trans_{m}"] = trans(f"hidden_trans_{m}_multimodal")
    for m in ("t", "s", "v", "a", "d"):
        params[f"contra_head_{m}"] = lin(f"contra_head_{m}.linear", bias=False)
    for m in ("va", "id", "vs", "vas"):
        params[f"contra_head_{m}"] = lin(f"contra_head_{m}")
    for m in (*MODALITIES, "subtitle"):
        params[f"{m}_type_embeddings"] = sd[f"{m}_type_embeddings"]
    return params
