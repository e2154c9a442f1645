"""A `timm` backbone as a CLIP visual tower (counterpart of
`mico_tpu/models/timm_adapter.py`): the trunk with its global pool and no
classifier, then an optional linear projection to `embed_dim`. `timm` is
imported only when a backbone is made, and its absence raises ImportError.
The projection is drawn by `numpy.random.default_rng(seed)` exactly as the
JAX package draws it, so both packages hold the same matrix for one seed.
"""

from __future__ import annotations

import numpy as np
import torch

from mico_tpu_torch.models.mico import resolve_device


class TimmBackbone:
    def __init__(self, model_name: str, embed_dim: int, pool: str = "avg",
                 proj: str = "linear", pretrained: bool = False,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        try:
            import timm
        except ImportError as e:
            raise ImportError(
                "timm is not installed in this environment; use the native "
                "towers (eva_vit / clip_vit / swin / modified_resnet) or "
                "install timm on a connected machine"
            ) from e
        self.trunk = timm.create_model(
            model_name, pretrained=pretrained, num_classes=0,
            global_pool=pool,
        )
        self.trunk.eval().to(self.device)
        feat_dim = self.trunk.num_features
        rng = np.random.default_rng(seed)
        if proj == "linear":
            w = rng.standard_normal(
                (feat_dim, embed_dim)).astype(np.float32) * feat_dim ** -0.5
            self.proj = torch.from_numpy(w).to(self.device)
        elif proj is None or proj == "none":
            self.proj = None
        else:
            raise NotImplementedError(proj)

    def __call__(self, pixels) -> torch.Tensor:
        """(B, 3, H, W) pixels (array or tensor) → (B, embed_dim) fp32 on
        the backbone's device (the trunk's features without a projection)."""
        with torch.inference_mode():
            feats = self.trunk(torch.as_tensor(pixels, device=self.device))
            if self.proj is not None:
                feats = feats @ self.proj
        return feats
