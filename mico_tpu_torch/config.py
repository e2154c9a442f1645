"""Model configuration dataclasses and the EVA-CLIP config registry.

PyTorch counterpart of `mico_tpu/config.py`: the same field names, defaults
and registry entries, with torch dtypes in `MiCoConfig.dtypes()`. Every
vision tower of the JAX package builds: the EVA ViTs (EVA01, EVA02 with
RoPE, SwiGLU, sub-LN and relative-position bias, and the post-norm bigE),
the OpenAI-CLIP ViTs of `models/clip_vit.py` and the Swin and VideoSwin
towers of `models/swin.py`; for audio the shared route and the BEATs and
AST towers of `models/audio.py`. Asking for another tower raises
`NotImplementedError`, as the JAX package does, naming the stand-alone
encoders (`models/clip_text.py`, `models/modified_resnet.py`,
`models/timm_adapter.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_NO_MICO_TOWER = (
    "MiCo has no such vision tower, in the JAX package either "
    "(its vision_tower_config and _init_vision_tower raise "
    "NotImplementedError); the stand-alone "
    "encoders are mico_tpu_torch.models.clip_text (the EVA-CLIP two-tower "
    "model), models.modified_resnet (CLIP's ResNet) and models.timm_adapter "
    "(timm backbones)")


@dataclass(frozen=True)
class EvaVitConfig:
    """EVA Vision Transformer hyperparameters (reference `CLIPVisionCfg`
    defaults, so registry entries only state overrides)."""

    image_size: int = 224
    patch_size: int = 16
    layers: int = 12
    width: int = 768
    head_width: int = 64
    mlp_ratio: float = 4.0
    embed_dim: int = 512
    qkv_bias: bool = True
    ls_init_value: Optional[float] = None
    drop_path_rate: float = 0.0
    patch_dropout: float = 0.0
    global_average_pool: bool = False
    postnorm: bool = False
    rope: bool = False
    pt_hw_seq_len: int = 16
    intp_freq: bool = False
    naiveswiglu: bool = False
    subln: bool = False
    ln_eps: float = 1e-6
    use_shared_rel_pos_bias: bool = False
    use_rel_pos_bias: bool = False

    @property
    def num_heads(self) -> int:
        return self.width // self.head_width

    @property
    def head_dim(self) -> int:
        return self.head_width

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    def with_image_size(self, image_size: int) -> "EvaVitConfig":
        return dataclasses.replace(self, image_size=image_size)


EVA_VIT_CONFIGS = {
    "EVA01-CLIP-B-16": EvaVitConfig(
        patch_size=16, layers=12, width=768, head_width=64, embed_dim=512,
        ls_init_value=0.1,
    ),
    "EVA01-CLIP-g-14": EvaVitConfig(
        patch_size=14, layers=40, width=1408, head_width=88,
        mlp_ratio=4.3637, embed_dim=1024, drop_path_rate=0.4,
    ),
    "EVA01-CLIP-g-14-plus": EvaVitConfig(
        patch_size=14, layers=40, width=1408, head_width=88,
        mlp_ratio=4.3637, embed_dim=1024,
    ),
    "EVA02-CLIP-B-16": EvaVitConfig(
        patch_size=16, layers=12, width=768, head_width=64,
        mlp_ratio=2.6667, embed_dim=512, rope=True, intp_freq=True,
        naiveswiglu=True, subln=True,
    ),
    "EVA02-CLIP-L-14": EvaVitConfig(
        patch_size=14, layers=24, width=1024, head_width=64,
        mlp_ratio=2.6667, embed_dim=768, rope=True, intp_freq=True,
        naiveswiglu=True, subln=True,
    ),
    "EVA02-CLIP-L-14-336": EvaVitConfig(
        image_size=336, patch_size=14, layers=24, width=1024, head_width=64,
        mlp_ratio=2.6667, embed_dim=768, rope=True, intp_freq=True,
        naiveswiglu=True, subln=True,
    ),
    "EVA02-CLIP-bigE-14": EvaVitConfig(
        patch_size=14, layers=64, width=1792, head_width=112,
        mlp_ratio=8.571428571428571, embed_dim=1024, postnorm=True,
    ),
    "EVA02-CLIP-bigE-14-plus": EvaVitConfig(
        patch_size=14, layers=64, width=1792, head_width=112,
        mlp_ratio=8.571428571428571, embed_dim=1024, postnorm=True,
    ),
}

# vision_encoder_type → (EVA config name, vision_dim)
VISION_ENCODER_TYPES = {
    "evaclip02_base": ("EVA02-CLIP-B-16", 768),
    "evaclip02_base_self": ("EVA02-CLIP-B-16", 768),
    "evaclip02_large": ("EVA02-CLIP-L-14", 1024),
    "evaclip02_bige": ("EVA02-CLIP-bigE-14-plus", 1792),
    "evaclip01_giant": ("EVA01-CLIP-g-14", 1408),
}


# non-EVA vision towers, with their widths (`mico_tpu/config.py`
# ALT_VISION_DIMS)
ALT_VISION_DIMS = {
    "clip_vit_base_16": 768,
    "clip_vit_base_32": 768,
    "clip_vit_large_14_336px": 1024,
    "swin_base_patch4_window7_224_22k": 1024,   # 128 * 2**3
    "videoswin_base": 1024,
}

# vision_encoder_type → CLIP_VIT_CONFIGS entry, JAX's map as it is
# (`mico_tpu/config.py:327-337`): `clip_vit_base_32` takes the B/16 geometry
# and `clip_vit_large_14_336px` L/14 at 224 px, so that both packages build
# the same tower for the same name
CLIP_TOWER_NAMES = {
    "clip_vit_base_16": "clip_vit_base_16",
    "clip_vit_base_32": "clip_vit_base_16",
    "clip_vit_large_14_336px": "clip_vit_large_14",
}


# audio_encoder_type → the tower's output width; "shared" is MiCo's audio
# through the vision ViT, "beats" and "ast" are VAST's separate towers
# (`mico_tpu/config.py:151-154`)
AUDIO_ENCODER_DIMS = {"shared": None, "beats": 768, "ast": 768}


def eva_config_for_encoder_type(
    vision_encoder_type: str, image_size: Optional[int] = None
) -> EvaVitConfig:
    if vision_encoder_type not in VISION_ENCODER_TYPES:
        raise NotImplementedError(
            f"vision tower {vision_encoder_type!r}: {_NO_MICO_TOWER}"
        )
    name, _ = VISION_ENCODER_TYPES[vision_encoder_type]
    cfg = EVA_VIT_CONFIGS[name]
    if image_size is not None:
        cfg = cfg.with_image_size(image_size)
    return cfg


@dataclass(frozen=True)
class BertConfig:
    """BERT-base with cross-attention."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    pad_token_id: int = 0
    add_cross_attention: bool = True
    encoder_width: int = 768

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# Special token ids of the bert-base-uncased WordPiece vocab, bound as
# bos/eos/pad/mask by the decoder (the reference's model/mico.py:109-113)
BERT_CLS_ID = 101   # [CLS] -> bos
BERT_SEP_ID = 102   # [SEP] -> eos
BERT_PAD_ID = 0     # [PAD]
BERT_MASK_ID = 103  # [MASK]


@dataclass(frozen=True)
class MiCoConfig:
    """Top-level omni-modal model config; field names match the reference
    `model_cfg` keys and `mico_tpu.config.MiCoConfig`."""

    vision_encoder_type: str = "evaclip01_giant"
    vision_resolution: int = 224
    contra_dim: int = 512
    frame_embedding_type: str = "adaptive"
    max_vision_sample_num: int = 4
    max_audio_sample_num: int = 4
    max_depth_sample_num: int = 4
    pool_video: bool = False
    beam_size: int = 3
    itm_ratio: float = 1.0
    max_caption_len: int = 40
    max_omni_caption_len: int = 70
    max_subtitle_len: int = 70
    checkpointing: bool = False
    bert_checkpointing: Optional[bool] = None
    remat_policy: Optional[str] = None
    unroll_blocks: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: Optional[int] = None
    itm_rerank_num: int = 50
    ret_bidirection_evaluation: bool = False
    audio_encoder_type: str = "shared"
    audio_melbins: int = 64
    audio_target_length: int = 1024
    compute_dtype: str = "bfloat16"
    shard_condition_sequence: bool = False
    param_dtype: str = "float32"
    use_flash_attention: bool = True
    eva_override: Optional[EvaVitConfig] = None
    bert_override: Optional[BertConfig] = None
    vision_override: Optional[object] = None
    audio_override: Optional[object] = None

    @property
    def is_eva(self) -> bool:
        """The vision tower is an EVA ViT (`models/eva_vit.py`); otherwise
        a non-EVA tower of `vision_tower_config`."""
        return (self.vision_override is None
                and (self.eva_override is not None
                     or self.vision_encoder_type.startswith("evaclip")))

    @property
    def vision_family(self) -> str:
        """The vision tower's module: "eva", "clip", "swin" or
        "videoswin" — by `vision_override`'s class when one is given, else
        by the type's prefix, as JAX's `_init_vision_tower` dispatches."""
        if self.is_eva:
            return "eva"
        from mico_tpu_torch.models.clip_vit import ClipVitConfig
        from mico_tpu_torch.models.swin import SwinConfig, VideoSwinConfig

        ov = self.vision_override
        for cls, family in ((ClipVitConfig, "clip"), (SwinConfig, "swin"),
                            (VideoSwinConfig, "videoswin")):
            if isinstance(ov, cls):
                return family
        if ov is not None:
            raise NotImplementedError(
                f"vision_override {type(ov).__name__}: {_NO_MICO_TOWER}")
        t = self.vision_encoder_type
        for prefix in ("clip", "videoswin", "swin"):
            if t.startswith(prefix):
                return prefix
        raise NotImplementedError(f"vision tower {t!r}: {_NO_MICO_TOWER}")

    @property
    def vision_dim(self) -> int:
        """The tower's output width: an EVA or CLIP tower's `width`, a Swin
        or VideoSwin tower's `num_features` (`mico_tpu/config.py:280-290`)."""
        if not self.is_eva:
            tower = self.vision_tower_config
            return getattr(tower, "num_features", None) or tower.width
        return self.eva_config.width

    @property
    def multimodal_dim(self) -> int:
        if self.bert_override is not None:
            return self.bert_override.hidden_size
        return 768

    @property
    def audio_dim(self) -> int:
        """The vision width for the shared route; a separate tower's
        `encoder_embed_dim` (BEATs) or `hidden_size` (AST) from
        `audio_override`, else its registry width."""
        if self.audio_encoder_type != "shared":
            if self.audio_override is not None:
                ov = self.audio_override
                return getattr(ov, "encoder_embed_dim", None) or ov.hidden_size
            return AUDIO_ENCODER_DIMS[self.audio_encoder_type]
        return self.vision_dim

    @property
    def eva_config(self) -> EvaVitConfig:
        if not self.is_eva:
            raise NotImplementedError(
                f"vision tower {self.vision_encoder_type!r} is not an EVA "
                "tower: its config is `vision_tower_config`")
        if self.eva_override is not None:
            return self.eva_override
        return eva_config_for_encoder_type(
            self.vision_encoder_type, self.vision_resolution
        )

    @property
    def vision_tower_config(self):
        """The config of the vision tower (`mico_tpu/config.py:322-347`):
        an `EvaVitConfig`, `vision_override` (a `ClipVitConfig`,
        `SwinConfig` or `VideoSwinConfig`), or the registry entry of the
        type: JAX's name map for `clip*`, Swin-B for `swin*`, VideoSwin-B
        for `videoswin*`. Other types and overrides raise."""
        family = self.vision_family
        if family == "eva":
            return self.eva_config
        if self.vision_override is not None:
            return self.vision_override
        t = self.vision_encoder_type
        if family == "clip":
            from mico_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS

            if t not in CLIP_TOWER_NAMES:
                raise NotImplementedError(
                    f"vision tower {t!r}: {_NO_MICO_TOWER}")
            return CLIP_VIT_CONFIGS[CLIP_TOWER_NAMES[t]]
        from mico_tpu_torch.models.swin import SWIN_CONFIGS, VIDEOSWIN_CONFIGS

        if family == "videoswin":
            return VIDEOSWIN_CONFIGS["videoswin_base"]
        return SWIN_CONFIGS["swin_base_patch4_window7_224_22k"]

    @property
    def audio_tower_config(self):
        """The separate audio tower's config (None for "shared"):
        `audio_override`, else BEATs' AS2M defaults for "beats" and an AST
        at this config's mel bins and target length otherwise."""
        if self.audio_encoder_type == "shared":
            return None
        if self.audio_override is not None:
            return self.audio_override
        from mico_tpu_torch.models.audio import AstConfig, BeatsConfig

        if self.audio_encoder_type == "beats":
            return BeatsConfig()
        return AstConfig(audio_melbins=self.audio_melbins,
                         audio_target_length=self.audio_target_length)

    @property
    def bert_config(self) -> BertConfig:
        if self.bert_override is not None:
            return self.bert_override
        return BertConfig()

    def dtypes(self) -> Tuple[torch.dtype, torch.dtype]:
        return (
            getattr(torch, self.param_dtype),
            getattr(torch, self.compute_dtype),
        )


def mico_config_from_dict(d: dict) -> MiCoConfig:
    """MiCoConfig from a (possibly larger) reference-style model_cfg dict,
    ignoring keys it does not model; `eva_override`/`bert_override` given as
    dicts are lifted into their dataclasses."""
    names = {f.name for f in dataclasses.fields(MiCoConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if isinstance(kw.get("eva_override"), dict):
        kw["eva_override"] = EvaVitConfig(**kw["eva_override"])
    if isinstance(kw.get("bert_override"), dict):
        kw["bert_override"] = BertConfig(**kw["bert_override"])
    return MiCoConfig(**kw)
