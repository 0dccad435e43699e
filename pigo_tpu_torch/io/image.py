"""Image decode + grayscale conversion.

Mirrors the reference image helpers (core/image.go:13-90, core/grayscale.go:8-23):
JPEG/PNG decode to RGBA and the integer Rec.601 luma formula

    gray = uint8((0.299*R + 0.587*G + 0.114*B) / 256)

where R/G/B are the 16-bit channel values (8-bit * 257 for opaque pixels) —
replicated bit-exactly on top of the decoded RGB planes.

Pillow is imported inside the decoder, so the package imports (and the
grayscale conversion runs) on a machine without it.
"""

from __future__ import annotations

import io
import os

import numpy as np


def decode_image(data: bytes | io.IOBase) -> np.ndarray:
    """Decode JPEG/PNG bytes (or a file-like) to an RGBA uint8 array [H, W, 4].

    Equivalent of DecodeImage -> ImgToNRGBA (core/image.go:24-90).
    """
    from PIL import Image

    if isinstance(data, (bytes, bytearray, memoryview)):
        data = io.BytesIO(bytes(data))
    img = Image.open(data)
    img = img.convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def get_image(path: str | os.PathLike) -> np.ndarray:
    """Load an image file to RGBA uint8 [H, W, 4] (core/image.go:13-21)."""
    with open(path, "rb") as fh:
        return decode_image(fh.read())


def rgb_to_grayscale(img: np.ndarray) -> np.ndarray:
    """Exact reference grayscale (core/grayscale.go:8-23) -> flat uint8 [H*W].

    The reference reads 16-bit premultiplied channels (v8 * 257 when opaque)
    and truncates (0.299*R + 0.587*G + 0.114*B) / 256 to uint8.
    """
    img = np.asarray(img)
    if img.ndim == 2:  # already grayscale
        return np.ascontiguousarray(img, dtype=np.uint8).ravel()
    if img.shape[-1] < 3:
        # (H, W, 1) grayscale / (H, W, 2) gray+alpha: expanding to NRGBA
        # (r=g=b) and applying the luma formula returns the gray value
        # itself (premultiplied by alpha when present)
        v = img[..., 0].astype(np.int64) * 257
        if img.shape[-1] == 2 and not np.all(img[..., 1] == 255):
            v = v * img[..., 1].astype(np.int64) // 255
        return (v.astype(np.float64) / 256.0).astype(np.uint8).ravel()
    rgb = img[..., :3].astype(np.int64)
    if img.shape[-1] == 4 and not np.all(img[..., 3] == 255):
        # Go NRGBA.RGBA() premultiply: v16 = (v8*257) * a / 255 (integer div).
        a = img[..., 3:4].astype(np.int64)
        chan16 = (rgb * 257 * a // 255).astype(np.float64)
    else:
        chan16 = (rgb * 257).astype(np.float64)
    lum = (
        0.299 * chan16[..., 0] + 0.587 * chan16[..., 1] + 0.114 * chan16[..., 2]
    ) / 256.0
    return lum.astype(np.uint8).ravel()
