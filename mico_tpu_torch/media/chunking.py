"""Temporal chunk sampling shared by video frames and audio slices
(counterpart of `mico_tpu/media/chunking.py`).

Reference `split` (model/videoprocessor.py:11-15, model/audioprocessor.py:8-12):
partition [0..n) into `sample_num` contiguous chunks (padding with the last
element when n < sample_num), then pick one element per chunk — random when
training, the middle one (`chunk[(len+1)//2 - 1]`) at eval.
"""

from __future__ import annotations

import random
from typing import List, Optional


def split_chunks(items: List, sample_num: int) -> List[List]:
    items = list(items)
    if len(items) < sample_num:
        items = items + [items[-1]] * (sample_num - len(items))
    k, m = divmod(len(items), sample_num)
    return [
        items[i * k + min(i, m) : (i + 1) * k + min(i + 1, m)]
        for i in range(sample_num)
    ]


def sample_chunk_indices(
    n: int,
    sample_num: int,
    training: bool,
    rng: Optional[random.Random] = None,
) -> List[int]:
    chunks = split_chunks(list(range(n)), sample_num)
    if training:
        r = rng or random
        return [r.choice(c) for c in chunks]
    return [c[(len(c) + 1) // 2 - 1] for c in chunks]
