"""Video decode on the host (counterpart of `mico_tpu/media/video_io.py`).

A video given as a directory of frame images (the processors'
`data_format="frame"`) is read through `image_io`. Container decoding (mp4,
...) needs the native libav decoder, which is not ported yet: these two
entry points raise `IOError` naming the ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from mico_tpu_torch.media.audio_io import NATIVE_DECODERS


def video_format(path: str) -> str:
    """The processors' `data_format` for a path: "frame" for a directory
    (of frame images), "raw" for a container file."""
    return "frame" if os.path.isdir(path) else "raw"


def video_num_frames(path: str) -> int:
    raise IOError(f"cannot read video container {path}: {NATIVE_DECODERS}; "
                  "a directory of frames takes data_format='frame'")


def read_frames_chw(path: str, indices: Sequence[int]) -> np.ndarray:
    """→ (n, 3, H, W) float32 RGB in [0,1], in the order of `indices`."""
    raise IOError(f"cannot read video container {path}: {NATIVE_DECODERS}; "
                  "a directory of frames takes data_format='frame'")
