"""MiCo omni-modal model assembly (counterpart of `mico_tpu/models/mico.py`).

One shared EVA ViT encodes every knowledge modality — video frames, images
(1-frame videos), audio fbank slices tiled to 3 channels, depth maps — and a
BERT with cross-attention is the language interface for contrastive
retrieval and ITM. `MiCo` is an `nn.Module` holding the parameters under the
JAX package's names (see `mico_tpu_torch.convert.params_from_jax`), with the
reference method surface of `MiCoModel` (mico.py:481-581).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.models import bert as bert_mod
from mico_tpu_torch.models import eva_vit as vit_mod
from mico_tpu_torch.models._params import Init, ParamGroup
from mico_tpu_torch.ops.interpolate import interp_nearest_1d
from mico_tpu_torch.ops.layers import gelu, layer_norm, linear

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


class MiCo(nn.Module):
    """MiCo with freshly drawn weights (`init_mico`, mico.py:36-86):
    trunc-normal 0.02 for the ViT, normal 0.02 for BERT and the heads, zero
    biases, unit LN weights, all from one `torch.Generator` seeded with
    `seed`. Weights are drawn on the CPU in fp32, so one seed gives one
    model on any device, then moved to `device` in `dtype` (default
    `cfg.param_dtype`)."""

    def __init__(self, cfg: MiCoConfig = MiCoConfig(), *, device="cuda",
                 seed: int = 0, dtype: Optional[torch.dtype] = None,
                 init_weights: bool = True):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        init = Init(gen, meta=not init_weights)
        vd, md, cd = cfg.vision_dim, cfg.multimodal_dim, cfg.contra_dim

        def trans_head(in_dim):
            return ParamGroup(kernel=init.normal((in_dim, md)),
                              bias=init.zeros((md,)),
                              ln_w=init.ones((md,)), ln_b=init.zeros((md,)))

        def param(t):
            return nn.Parameter(t, requires_grad=False)

        self.vision_encoder = vit_mod.EvaVisionTransformer(cfg.eva_config, init)
        self.bert = bert_mod.Bert(cfg.bert_config, init)
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
        if init_weights:
            self.to(device=dev, dtype=dtype or cfg.dtypes()[0])

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.cfg.dtypes()[1]

    @property
    def attn_impl(self) -> str:
        return "flash" if self.cfg.use_flash_attention else "plain"

    def fold_inference_params(self) -> "MiCo":
        """In place: the vision tower's LN affines and LayerScale folded
        into the adjacent matmuls (mico.fold_inference_params); a pure
        reparametrization for inference, after which the ViT blocks take
        kernel K1 with `affine=False`."""
        self.vision_encoder.fold_inference_params()
        return self

    # -- encoders ------------------------------------------------------------

    @torch.no_grad()
    def forward_vision_encoder(self, pixels: torch.Tensor) -> torch.Tensor:
        """(b, n, 3, h, w) → (b, n, seq, vision_dim): frames folded into the
        batch for one ViT pass (mico.py:139-196)."""
        b, n = pixels.shape[:2]
        flat = pixels.reshape(b * n, *pixels.shape[2:])
        tokens = vit_mod.eva_vit_forward(
            self.vision_encoder, flat, return_all_features=True,
            compute_dtype=self.compute_dtype, attn_impl=self.attn_impl,
        )
        return tokens.reshape(b, n, *tokens.shape[1:])

    def forward_audio_encoder(self, spectrograms: torch.Tensor) -> torch.Tensor:
        """(b, n, T, M) fbank slices → (b, n, seq, C) through the shared ViT,
        tiled to 3 channels (mico.py:199-210)."""
        x = spectrograms[:, :, None].expand(-1, -1, 3, -1, -1)
        return self.forward_vision_encoder(x)

    def forward_depth_encoder(self, depth_pixels: torch.Tensor) -> torch.Tensor:
        return self.forward_vision_encoder(depth_pixels)

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
        when given (no encoder mask, as mico.py:252-266); returns the
        sequence output."""
        return bert_mod.bert_forward(
            self.bert, input_ids, attention_mask,
            encoder_hidden_states=condition_feat,
            position_ids=position_ids,
            compute_dtype=self.compute_dtype,
            attn_impl=self.attn_impl,
            encoder_row_index=condition_row_index,
        )

    # -- pooling & heads -----------------------------------------------------

    def pool_vision_for_contra(self, feature: torch.Tensor) -> torch.Tensor:
        return pool_frames_for_contra(feature)

    def pool_audio_for_contra(self, feature: torch.Tensor) -> torch.Tensor:
        return pool_frames_for_contra(feature)

    def pool_depth_for_contra(self, feature: torch.Tensor) -> torch.Tensor:
        return pool_frames_for_contra(feature)

    @staticmethod
    def pool_text_for_contra(feature: torch.Tensor) -> torch.Tensor:
        return feature[:, 0]

    @torch.no_grad()
    def contra_head(self, name: str, feature: torch.Tensor) -> torch.Tensor:
        hp = getattr(self, f"contra_head_{name}")
        return linear(feature, hp.get("kernel"), hp.get("bias"))

    @torch.no_grad()
    def itm_head(self, cls_token: torch.Tensor) -> torch.Tensor:
        """Linear → GELU → LN(1e-12) → Linear(2) (mico.py:311-317)."""
        hp = self._modules["itm_head"]   # the attribute name is this method's
        x = gelu(linear(cls_token, hp.get("fc1_w"), hp.get("fc1_b")))
        x = layer_norm(x, hp.get("ln_w"), hp.get("ln_b"), 1e-12)
        return linear(x, hp.get("fc2_w"), hp.get("fc2_b"))

    @torch.no_grad()
    def _condition_input(self, output: torch.Tensor, modality: str
                         ) -> torch.Tensor:
        """(b, n, x, c) encoder tokens → (b, n·x, multimodal_dim) condition
        tokens: hidden_trans (linear + LN), the adaptive frame embedding and
        the modality type embedding (mico.py:329-350)."""
        cfg = self.cfg
        b, n = output.shape[:2]
        if cfg.pool_video:
            output = torch.cat(
                [output[:, :, :1], output[:, :, 1:].mean(dim=2, keepdim=True)],
                dim=2,
            )
        tp = getattr(self, f"hidden_trans_{modality}")
        output = linear(output, tp.get("kernel"), tp.get("bias"))
        output = layer_norm(output, tp.get("ln_w"), tp.get("ln_b"), 1e-12)
        if cfg.frame_embedding_type == "adaptive":
            fe = frame_embedding(getattr(self, f"{modality}_frame_embedding"), n)
            output = output + fe.to(output.dtype)[:, :, None, :]
        output = output.reshape(b, -1, cfg.multimodal_dim)
        type_emb = getattr(self, f"{modality}_type_embeddings")
        return output + type_emb.to(output.dtype)

    def get_multimodal_forward_input_vision(self, vision_output):
        return self._condition_input(vision_output, "vision")

    def get_multimodal_forward_input_audio(self, audio_output):
        return self._condition_input(audio_output, "audio")

    def get_multimodal_forward_input_depth(self, depth_output):
        return self._condition_input(depth_output, "depth")


def pool_frames_for_contra(feature: torch.Tensor) -> torch.Tensor:
    """(b, n, x, c): the CLS token of each frame, then the mean over frames
    (the EVA rule of mico.py:274-281)."""
    return feature[:, :, 0].mean(dim=1)


def frame_embedding(emb: torch.Tensor, n: int) -> torch.Tensor:
    """Adaptive frame embedding (1, N, C) → (1, n, C): nearest resize over
    the frame axis when n differs from N (mico.py:320-326)."""
    if emb.shape[1] == n:
        return emb
    return interp_nearest_1d(emb.transpose(1, 2), n).transpose(1, 2)
