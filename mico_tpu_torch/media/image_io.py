"""Image decode on the host (counterpart of `mico_tpu/media/image_io.py`).

Replaces PIL.Image.open + convert('RGB') + ToTensor (reference
model/imageprocessor.py:49-51). Readers are tried in the JAX module's
order, each imported only when it is needed: OpenCV, then PIL, then the
port's own reader of binary 8-bit PPM (P6) and PGM (P5) files, which needs
only numpy (a machine may have neither OpenCV nor PIL). Returns float32 RGB
in [0, 1], shape (3, H, W).
"""

from __future__ import annotations

import numpy as np


def _read_cv2(path: str):
    """(RGB uint8 (H, W, 3) or None, why not)."""
    try:
        import cv2
    except ImportError:
        return None, "cv2 is not installed"
    bgr = cv2.imread(path, cv2.IMREAD_COLOR)  # handles gray/CMYK → 3ch
    if bgr is None:
        return None, "cv2 cannot decode it"
    return bgr[:, :, ::-1], None


def _read_pil(path: str):
    try:
        from PIL import Image
    except ImportError:
        return None, "PIL is not installed"
    try:
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB")), None
    except (OSError, ValueError) as e:
        return None, f"PIL cannot decode it ({e})"


def _pnm_header(data: bytes):
    """(width, height, maxval, offset of the pixels) of a binary PNM."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            end = data.find(b"\n", pos)
            pos = len(data) if end < 0 else end + 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise IOError("malformed PPM/PGM header")
        fields.append(int(data[start:pos]))
    return (*fields, pos + 1)       # one whitespace byte ends the header


def read_pnm(path: str) -> np.ndarray:
    """Binary 8-bit PPM (P6) or PGM (P5) → RGB uint8 (H, W, 3); a PGM's
    gray is copied to the three channels, as OpenCV's IMREAD_COLOR does."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P5", b"P6"):
        raise IOError("not a binary PPM (P6) or PGM (P5) file")
    w, h, maxval, offset = _pnm_header(data)
    if maxval != 255:
        raise IOError(f"PPM/PGM maxval {maxval}: only 8-bit (255) is read")
    ch = 3 if magic == b"P6" else 1
    if len(data) - offset < w * h * ch:
        raise IOError(f"PPM/PGM truncated: {len(data) - offset} pixel bytes "
                      f"for {w}x{h}x{ch}")
    px = np.frombuffer(data, np.uint8, count=w * h * ch, offset=offset)
    img = px.reshape(h, w, ch)
    return np.repeat(img, 3, axis=2) if ch == 1 else img


def load_image_chw(path: str) -> np.ndarray:
    """(3, H, W) float32 RGB in [0, 1]; IOError naming each reader's
    reason when none of them can decode the file."""
    reasons = []
    for reader in (_read_cv2, _read_pil):
        rgb, why = reader(path)
        if rgb is not None:
            break
        reasons.append(why)
    else:
        try:
            rgb = read_pnm(path)
        except (IOError, ValueError) as e:
            raise IOError(f"cannot decode image {path}: "
                          + "; ".join(reasons + [f"the PPM/PGM reader: {e}"])
                          ) from None
    return np.ascontiguousarray(
        rgb.transpose(2, 0, 1).astype(np.float32) / 255.0)
