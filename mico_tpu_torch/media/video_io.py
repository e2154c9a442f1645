"""Video decode on the host (counterpart of `mico_tpu/media/video_io.py`).

Replaces decord.VideoReader + get_batch (reference
model/videoprocessor.py:80-89, data/data/vision_mapper.py:139-149) with the
JAX module's `cv2.VideoCapture` route (`video_num_frames`,
`_read_frames_cv2`): only the sampled frames are decoded, seeking only
across a gap, and they come back as float32 RGB CHW in [0, 1] in the order
of the indices. A file cv2 cannot open raises `IOError`. The JAX module's
primary route, its native libav decoder, is not ported: it needs libav's
headers, which neither machine has (ROADMAP.md, queue 1: libav codecs). A
video given as a directory of frame images (the processors'
`data_format="frame"`) is read through `image_io`.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np


def video_format(path: str) -> str:
    """The processors' `data_format` for a path: "frame" for a directory
    (of frame images), "raw" for a container file."""
    return "frame" if os.path.isdir(path) else "raw"


def _open(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        cap.release()
        raise IOError(f"cannot open video: {path}")
    return cap


def video_num_frames(path: str) -> int:
    """The container's frame count, as cv2 reports it."""
    import cv2

    cap = _open(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def read_frames_chw(path: str, indices: Sequence[int]) -> np.ndarray:
    """→ (n, 3, H, W) float32 RGB in [0,1], in the order of `indices`: each
    distinct frame decoded once, in ascending order, with a seek only
    where the next wanted frame is not the next one in the stream."""
    import cv2

    cap = _open(path)
    try:
        order = list(indices)
        want: Dict[int, np.ndarray] = {}
        pos = 0
        for idx in sorted(set(order)):
            if idx != pos:
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                pos = idx
            ok, frame = cap.read()
            pos += 1
            if not ok:
                raise IOError(f"failed to read frame {idx} of {path}")
            want[idx] = np.ascontiguousarray(
                frame[:, :, ::-1].transpose(2, 0, 1).astype(np.float32)
                / 255.0)
        return np.stack([want[i] for i in order])
    finally:
        cap.release()
