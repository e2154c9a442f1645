"""The HuggingFace text-encoder surface (counterpart of
`mico_tpu/text/hf_adapter.py`): the pooler registry (masked mean, masked
max, first token), `pool_and_project` with an optional bias-free
projection, each HF model type's default pooler, and `HFTokenizer`, which
wraps `transformers.AutoTokenizer` (imported only when one is made) with
CLIP's fixed-length contract. Poolers take hidden (B, L, D) and the
attention mask (B, L) as tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Union

import numpy as np
import torch

POOLERS: Dict[str, Callable] = {}


def register_pooler(name: str):
    def deco(fn):
        POOLERS[name] = fn
        return fn
    return deco


@register_pooler("mean_pooler")
def mean_pooler(hidden: torch.Tensor, attention_mask: torch.Tensor):
    """Masked mean over the tokens."""
    m = attention_mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1)


@register_pooler("max_pooler")
def max_pooler(hidden: torch.Tensor, attention_mask: torch.Tensor):
    """Masked max over the tokens; masked ones count as the dtype's
    least value."""
    neg = torch.finfo(hidden.dtype).min
    m = attention_mask[..., None].bool()
    return torch.where(m, hidden, neg).amax(dim=1)


@register_pooler("cls_pooler")
def cls_pooler(hidden: torch.Tensor, attention_mask: torch.Tensor = None):
    """The first token."""
    return hidden[:, 0]


def pool_and_project(hidden: torch.Tensor, attention_mask: torch.Tensor,
                     pooler: str = "cls_pooler",
                     proj_kernel: torch.Tensor = None) -> torch.Tensor:
    """A pooler of POOLERS, then x @ proj_kernel when one is given."""
    x = POOLERS[pooler](hidden, attention_mask)
    if proj_kernel is not None:
        x = x @ proj_kernel.to(x.dtype)
    return x


class HFTokenizer:
    """`transformers.AutoTokenizer` with CLIP's contract: whitespace
    collapsed, padded and truncated to `context_length`, int32 numpy ids."""

    def __init__(self, tokenizer_name: str):
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(tokenizer_name)

    def __call__(self, texts: Union[str, List[str]],
                 context_length: int = 77) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        texts = [" ".join(t.split()) for t in texts]
        enc = self.tokenizer(texts, max_length=context_length,
                             padding="max_length", truncation=True,
                             return_tensors="np")
        return enc["input_ids"].astype(np.int32)


# each HF model type's default pooler
ARCH_POOLERS: Dict[str, str] = {
    "roberta": "mean_pooler",
    "xlm-roberta": "mean_pooler",
    "mt5": "mean_pooler",
    "bert": "cls_pooler",
}


def default_pooler_for(model_type: str) -> str:
    return ARCH_POOLERS.get(model_type, "cls_pooler")
