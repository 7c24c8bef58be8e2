"""JPEG: decode as Pillow and OpenCV read it, encode as Pillow writes it.

The entropy coding and the sample arithmetic run in the native codec core
(``native_image``, libjpeg-turbo 3.1's paths: the ISLOW IDCT as its SIMD
version computes it, fancy upsampling, fixed-point colour conversion); the
layout here.

- ``decode_jpeg``: Pillow 12's ``Image.open(p).convert("RGBA")``. Every
  8-bit JPEG libjpeg decodes: Huffman or arithmetic coding (with its DAC
  conditioning), baseline, extended or progressive DCT, lossless (SOF3:
  predictors 1-7, a point transform), 1, 3 or 4 components (grey, YCbCr,
  RGB, CMYK, YCCK as the JFIF and Adobe markers or the component ids
  select), any integral sampling (4:4:4, 4:2:2, 4:2:0, 4:4:0, ...; a
  lossless image's replicated), restart intervals, sizes that are not a
  multiple of the MCU, and progressive files whose scans leave the low
  coefficients unrefined, block-smoothed as libjpeg smooths them. A CMYK
  file is opened inverted ("CMYK;I", Adobe's polarity) and converted by
  Pillow's ``cmyk2rgb``. EXIF orientation is not applied, as Pillow does
  not apply it on open.
- ``decode_jpeg_cv2``: ``cv2.imread(p, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)``:
  grey (H, W) or BGR (CMYK through OpenCV's CMYK-to-BGR), turned by the
  EXIF orientation as OpenCV turns it.
- ``encode_jpeg``: the bytes of Pillow's ``save`` for modes L and RGB:
  baseline JFIF, standard tables scaled to ``quality`` (75 by default),
  4:2:0 for RGB unless ``subsampling`` says otherwise (Pillow's 0, 1, 2
  or "4:4:4", "4:2:2", "4:2:0", "4:1:1"; grey takes them too, as factors
  of its one component). RGBA and 16-bit data raise
  ``OSError`` as Pillow does.

What the libraries refuse is refused as they refuse it: a frame of other
than 8 bits or of 2 (or more than 4) components, or headers that end
before a scan, raise ``OSError`` "cannot identify image file" (Pillow's
open); hierarchical and lossless arithmetic frames, lossless YCbCr or
YCCK (libjpeg converts no colour in lossless mode) and an interleaved MCU
of more than 10 blocks raise "broken data stream when reading image file"
(where libjpeg stops), as does an
arithmetic scan whose data reaches past the 64 KiB Pillow hands libjpeg
at a time; ``decode_jpeg_cv2`` gives None for each (OpenCV reads the last
kind). A file that ends before its EOI marker raises ``OSError`` as Pillow
does ("image file is truncated"); ``decode_jpeg_cv2`` decodes it as
``cv2.imread`` does: the missing data leaves the rest of its segment flat
(arithmetic data reads as zeros), as libjpeg leaves it.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image

MAGIC = b"\xff\xd8\xff"
_SUBSAMPLING = {-1: (2, 2), 0: (1, 1), 1: (2, 1), 2: (2, 2),
                "4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:1:1": (2, 2)}


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    px = native_image.jpeg_decode(data, name)
    if px.ndim == 3 and px.shape[2] == 4:  # CMYK, opened inverted ("CMYK;I")
        return native_image.cmyk_convert(px, opencv=False)
    out = np.empty(px.shape[:2] + (4,), np.uint8)
    out[..., :3] = px[..., None] if px.ndim == 2 else px
    out[..., 3] = 255
    return out


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation (1-8) of a JPEG's APP1 segment, 1 without one."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xDA, 0xD9):
            break
        (length,) = struct.unpack_from(">H", data, pos + 2)
        body = data[pos + 4: pos + 2 + length]
        pos += 2 + length
        if marker != 0xE1 or body[:6] != b"Exif\x00\x00":
            continue
        tiff = body[6:]
        e = "<" if tiff[:2] == b"II" else ">"
        try:
            (ifd,) = struct.unpack_from(e + "I", tiff, 4)
            (n,) = struct.unpack_from(e + "H", tiff, ifd)
            for i in range(n):
                tag, typ, _, value = struct.unpack_from(e + "HHIH", tiff, ifd + 2 + 12 * i)
                if tag == 0x0112 and typ == 3:
                    return value if 1 <= value <= 8 else 1
        except struct.error:
            return 1
    return 1


def orient(a: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``ApplyExifOrientation`` of an (H, W[, C]) array."""
    ops = {2: lambda x: x[:, ::-1], 3: lambda x: x[::-1, ::-1], 4: lambda x: x[::-1],
           5: lambda x: x.swapaxes(0, 1), 6: lambda x: x.swapaxes(0, 1)[:, ::-1],
           7: lambda x: x.swapaxes(0, 1)[::-1, ::-1], 8: lambda x: x.swapaxes(0, 1)[::-1]}
    return np.ascontiguousarray(ops[orientation](a)) if orientation in ops else a


def decode_jpeg_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W) grey or (H, W, 3) BGR uint8 as ``cv2.imread``, which reads a
    truncated file as libjpeg decodes it."""
    px = native_image.jpeg_decode(data, name, cv2=True)
    if px is None:
        return None
    if px.ndim == 3 and px.shape[2] == 4:
        px = native_image.cmyk_convert(px, opencv=True)
    elif px.ndim == 3:
        px = px[..., ::-1]
    return orient(np.ascontiguousarray(px), exif_orientation(data))


def encode_jpeg(pixels: np.ndarray, quality: int = 75, subsampling=-1) -> bytes:
    """Pillow's ``save`` bytes of uint8 (H, W) L or (H, W, 3) RGB."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        mode = ("I;16" if a.dtype == np.uint16 else
                "RGBA" if a.ndim == 3 and a.shape[2] == 4 else f"{a.dtype} {a.shape}")
        raise OSError(f"cannot write mode {mode} as JPEG")
    if subsampling not in _SUBSAMPLING:
        raise ValueError(f"JPEG subsampling {subsampling!r} is not one of Pillow's")
    if not isinstance(quality, int) or not 0 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality!r} must be an int in 0..100")
    if a.ndim == 2 and subsampling == -1:  # libjpeg's default for grey: 1x1
        subsampling = 0
    return native_image.jpeg_encode(a, quality, *_SUBSAMPLING[subsampling])
