"""BERT-style token masking (counterpart of `mico_tpu/train/masker.py`).

Each non-pad token past position 0 is masked with probability p: 80% →
[MASK], 10% → a random id in [range_start, range_end), 10% kept; labels are
the original ids at masked positions and -100 elsewhere. A row that would
have no masked position but has a valid one gets its valid position with
the smallest draw masked (the shape-static stand-in for the reference's
retry loop). Draws come from a device generator forked from the caller's
CPU generator; `drawn` hands in recorded (masked ids, labels) instead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mico_tpu_torch.config import BERT_MASK_ID
from mico_tpu_torch.ops.layers import fork_generator


def mask_tokens(
    tokens: torch.Tensor,
    mask_prob: float,
    generator: Optional[torch.Generator],
    mask_token: int = BERT_MASK_ID,
    range_start: int = 106,
    range_end: int = 30522,
    pad_id: int = 0,
    drawn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (b, L) → (masked tokens, labels)."""
    if drawn is not None:
        return tuple(x.to(tokens.device, torch.long) for x in drawn)
    if generator is None:
        raise ValueError("mask_tokens draws its masks from a generator")
    b, l = tokens.shape
    dev = tokens.device
    gen = fork_generator(generator, dev)
    valid = (tokens != pad_id) & (torch.arange(l, device=dev)[None, :] > 0)
    u = torch.rand((b, l), generator=gen, device=dev)
    mask = valid & (u < mask_prob)
    has_any = mask.any(dim=1)
    first = torch.where(valid, u, float("inf")).argmin(dim=1)
    force = torch.nn.functional.one_hot(first, l).bool()
    empty = ~has_any & valid.any(dim=1)
    mask = torch.where(empty[:, None], force & valid, mask)
    kind = torch.rand((b, l), generator=gen, device=dev)
    rand_tok = torch.randint(range_start, range_end, (b, l), generator=gen,
                             device=dev, dtype=tokens.dtype)
    replaced = torch.where(kind < 0.8, torch.full_like(tokens, mask_token),
                           torch.where(kind < 0.9, rand_tok, tokens))
    out = torch.where(mask, replaced, tokens)
    labels = torch.where(mask, tokens, -100)
    return out.long(), labels.long()
