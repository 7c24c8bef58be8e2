"""WebP: decode frame 0 as Pillow and as OpenCV read it; encode as Pillow's
``save`` writes it.

The decoder is native (``csrc/sl_webp.cpp`` through ``native_image``):
the RIFF container with ``VP8X``, ``ALPH``, ``ANIM`` and ``ANMF``, the
VP8 lossy bitstream with libwebp's output stage (fancy 4:2:0 upsampling,
14-bit fixed-point YUV -> RGB), the VP8L lossless bitstream, and the
alpha plane (raw or VP8L levels, unfiltered; libwebp's default alpha
dithering of 0 leaves pre-processed levels as they are).

- ``decode_webp`` gives Pillow 12's ``Image.open(p).convert("RGBA")``:
  Pillow opens every WebP through libwebp's demuxer and WebPAnimDecoder,
  which composes frame 0 onto a canvas that is transparent black outside
  the frame's rectangle; a file whose features carry no alpha opens as
  RGB, so its alpha becomes 255.
- ``decode_webp_cv2`` gives ``cv2.imread(p, IMREAD_ANYCOLOR |
  IMREAD_ANYDEPTH)``: (H, W, 3) BGR, alpha dropped; a still image is
  WebPDecode of the whole file, an animation frame 0 as above; None where
  OpenCV reads nothing (a file under 32 bytes, a truncated or corrupt one),
  and ``ValueError`` where it raises (a canvas over its size limits).

The canvas is checked against Pillow's (or OpenCV's) size limit before a
pixel is decoded.

- ``encode_webp`` gives Pillow 12's ``Image.fromarray(a).save(p)`` to a
  ``.webp`` path: libwebp's lossy encoder at quality 80, method 4 (the
  native ``csrc/sl_webp_enc.cpp``). The file is Pillow's, byte for byte,
  but for the ALPH chunk's compressed payload: its header byte is
  libwebp's, its VP8L stream the port's own (the decoded alpha is exact).
"""

from __future__ import annotations

import numpy as np

from . import native_image
from .image_limits import check_size

MAGIC = b"RIFF"  # then the size and b"WEBP"


def encode_webp(pixels: np.ndarray) -> bytes:
    """The WebP file Pillow writes for ``pixels`` as the JAX ``ImageSaver``
    hands them over: (H, W) uint8 (mode L, saved as grey RGB), (H, W, 3)
    uint8 (RGB), (H, W, 4) uint8 (RGBA; an opaque alpha is dropped) or
    (H, W) uint16 (mode I;16, saved as RGB of the values clipped at 255).
    A side over 16383 raises ``ValueError`` with Pillow's message."""
    a = np.asarray(pixels)
    if a.ndim == 2 and a.dtype in (np.uint8, np.uint16):
        a = np.repeat(np.minimum(a, 255).astype(np.uint8)[..., None], 3, axis=2)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"cannot write mode {a.dtype} {a.shape} as WebP")
    return native_image.webp_encode(a)


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``; raises
    ``ValueError`` for a file that is not valid and ``OSError`` for one
    that ends early, where Pillow raises."""
    info = native_image.webp_info(data, name)
    check_size(info["width"], info["height"], name, "WebP")
    rgba = native_image.webp_decode(data, info["width"], info["height"], name)
    if not info["alpha"]:
        rgba[..., 3] = 255
    return rgba


def decode_webp_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """(H, W, 3) BGR uint8 as ``cv2.imread`` reads it; None where OpenCV
    reads no image. A canvas over OpenCV's size limits raises
    ``ValueError``, as ``imread`` raises after reading the header."""
    try:
        width, height = native_image.webp_header_cv2(data, name)
    except (ValueError, OSError):
        return None
    check_size(width, height, name, "WebP", cv2=True)
    try:
        info = native_image.webp_info(data, name, cv2=True)
        rgba = native_image.webp_decode(data, info["width"], info["height"], name, cv2=True)
    except (ValueError, OSError):
        return None
    return np.ascontiguousarray(rgba[..., 2::-1])
