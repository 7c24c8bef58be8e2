"""DDS (DirectDraw Surface): encode as Pillow's ``save`` writes it, decode
as Pillow reads it (``DdsImagePlugin``).

- ``encode_dds`` gives the bytes of Pillow 12's ``save`` of an L, RGB or
  RGBA image: the 128-byte header (the pitch flag and the row pitch; L as
  luminance with the masks 0xFF000000 Pillow writes, colour as ``DDPF_RGB``
  with the masks of B, G, R, A bytes), then the samples uncompressed, RGB
  as B, G, R and RGBA as B, G, R, A. Pillow refuses I;16 ("cannot write
  mode I;16 as DDS").
- ``decode_dds`` gives ``Image.open(p).convert("RGBA")`` of the top mip
  level: ``DDPF_RGB`` with any masks and bit count (each field scaled to 8
  bits as ``int(v / max * 255)``, which truncates, as ``DdsRgbDecoder``
  does), luminance of 8 bits and with alpha of 16, 8-bit palette indices
  with the 1024-byte RGBA palette, the FourCCs DXT1, DXT3, DXT5, BC4U,
  ATI1, BC5U, ATI2 and BC5S, and DX10 with the DXGI formats of BC1-BC7
  (the sRGB variants read as the others) and R8G8B8A8. The blocks are
  decoded natively (``sl_bcn_decode``) and odd sizes cropped from whole
  blocks. Other pixel formats raise ``NotImplementedError`` as in Pillow.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size

MAGIC = b"DDS "
DDSD_CAPS, DDSD_HEIGHT, DDSD_WIDTH, DDSD_PITCH, DDSD_PIXELFORMAT = 0x1, 0x2, 0x4, 0x8, 0x1000
DDSCAPS_TEXTURE = 0x1000
DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTEINDEXED8, DDPF_RGB, DDPF_LUMINANCE = (
    0x1, 0x4, 0x20, 0x40, 0x20000)


def fourcc(code: bytes) -> int:
    return struct.unpack("<I", code)[0]


# FourCC -> (BCn format, BC5S/BC6HS, Pillow's mode)
FOURCCS = {fourcc(b"DXT1"): (1, False, "RGBA"), fourcc(b"DXT3"): (2, False, "RGBA"),
           fourcc(b"DXT5"): (3, False, "RGBA"), fourcc(b"BC4U"): (4, False, "L"),
           fourcc(b"ATI1"): (4, False, "L"), fourcc(b"BC5S"): (5, True, "RGB"),
           fourcc(b"BC5U"): (5, False, "RGB"), fourcc(b"ATI2"): (5, False, "RGB")}
DX10 = fourcc(b"DX10")
# DXGI format -> the same (R8G8B8A8: format 0, uncompressed)
DXGI = {70: (1, False, "RGBA"), 71: (1, False, "RGBA"), 73: (2, False, "RGBA"),
        74: (2, False, "RGBA"), 76: (3, False, "RGBA"), 77: (3, False, "RGBA"),
        79: (4, False, "L"), 80: (4, False, "L"), 82: (5, False, "RGB"), 83: (5, False, "RGB"),
        84: (5, True, "RGB"), 95: (6, False, "RGB"), 96: (6, True, "RGB"),
        97: (7, False, "RGBA"), 98: (7, False, "RGBA"), 99: (7, False, "RGBA"),
        27: (0, False, "RGBA"), 28: (0, False, "RGBA"), 29: (0, False, "RGBA")}


def encode_dds(pixels: np.ndarray) -> bytes:
    """The DDS file Pillow writes for (H, W), (H, W, 3) or (H, W, 4) uint8
    pixels."""
    a = np.asarray(pixels)
    if not (a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4)))):
        raise OSError(f"cannot write mode {'I;16' if a.dtype == np.uint16 else a.shape} as DDS")
    h, w = a.shape[:2]
    bands = 1 if a.ndim == 2 else a.shape[2]
    if bands == 1:
        pf, masks, body = DDPF_LUMINANCE, (0xFF000000,) * 3 + (0,), a
    else:
        pf, masks = DDPF_RGB, (0xFF0000, 0xFF00, 0xFF, 0xFF000000 if bands == 4 else 0)
        body = a[..., [2, 1, 0, 3][:bands]]
        if bands == 4:
            pf |= DDPF_ALPHAPIXELS
    flags = DDSD_CAPS | DDSD_HEIGHT | DDSD_WIDTH | DDSD_PIXELFORMAT | DDSD_PITCH
    head = (MAGIC + struct.pack("<7I", 124, flags, h, w, (w * bands * 8 + 7) // 8, 0, 0)
            + bytes(44) + struct.pack("<4I", 32, pf, 0, bands * 8) + struct.pack("<4I", *masks)
            + struct.pack("<5I", DDSCAPS_TEXTURE, 0, 0, 0, 0))
    return head + np.ascontiguousarray(body).tobytes()


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """``DdsRgbDecoder``: each pixel a little-endian value of bitcount // 8
    bytes (zero past the data's end), each mask's field scaled to 8 bits."""
    nbytes = bitcount // 8
    raw = np.zeros(w * h * nbytes, np.uint8)
    got = np.frombuffer(data, np.uint8)[pos: pos + raw.size]
    raw[: got.size] = got
    value = np.zeros(w * h, np.uint64)
    for i in range(min(nbytes, 4)):
        value |= raw[i::nbytes].astype(np.uint64) << np.uint64(8 * i)
    out = np.zeros((h, w, len(masks)), np.uint8)
    for c, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        field = (value & np.uint64(mask)) >> np.uint64(shift)
        out[..., c] = ((field.astype(np.float64) / total) * 255).astype(np.int64).reshape(h, w)
    return out


def decode_dds(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not data.startswith(MAGIC):
        raise ValueError(f"{name}: not a DDS file")
    (header_size,) = struct.unpack_from("<I", data, 4) if len(data) >= 8 else (0,)
    if header_size != 124:
        raise OSError(f"{name}: unsupported DDS header size {header_size}")
    if len(data) < 128:
        raise OSError(f"{name}: incomplete DDS header")
    _, height, width = struct.unpack_from("<3I", data, 8)
    pfflags, code, bitcount = struct.unpack_from("<3I", data, 80)
    check_size(width, height, name, "DDS")
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    pos = 128
    if pfflags & DDPF_RGB:
        n = 4 if pfflags & DDPF_ALPHAPIXELS else 3
        pix = _masked(data, pos, width, height, bitcount, struct.unpack_from(f"<{n}I", data, 92))
        out[..., :n] = pix
        return out
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            mode = "LA"
        else:
            raise OSError(f"{name}: unsupported DDS luminance bit count {bitcount}")
        fmt = 0
    elif pfflags & DDPF_PALETTEINDEXED8:
        mode, fmt = "P", 0
        palette = np.frombuffer(data, np.uint8, 1024, pos).reshape(256, 4)
        pos += 1024
    elif pfflags & DDPF_FOURCC:
        if code == DX10:
            (dxgi,) = struct.unpack_from("<I", data, 128)
            pos += 20
            if dxgi not in DXGI:
                raise NotImplementedError(f"{name}: unimplemented DXGI format {dxgi}")
            fmt, sign, mode = DXGI[dxgi]
        elif code in FOURCCS:
            fmt, sign, mode = FOURCCS[code]
        else:
            raise NotImplementedError(f"{name}: unimplemented DDS pixel format "
                                      f"{struct.pack('<I', code)!r}")
    else:
        raise NotImplementedError(f"{name}: unknown DDS pixel format flags {pfflags}")
    if fmt:
        pix = native_image.bcn_decode(data[pos:], fmt, sign, width, height, name)
        if fmt == 4:
            out[..., :3] = pix[..., None]
        else:
            out[..., :3] = pix[..., :3]
            if mode == "RGBA":
                out[..., 3] = pix[..., 3]
        return out
    bands = len(mode)
    n = width * height * bands
    if len(data) < pos + n:
        raise OSError(f"{name}: image file is truncated")
    pix = np.frombuffer(data, np.uint8, n, pos).reshape(height, width, bands)
    if mode == "P":
        return palette[pix[..., 0]].copy()
    out[..., :3] = pix[..., :1] if bands <= 2 else pix[..., :3]
    if bands in (2, 4):
        out[..., 3] = pix[..., -1]
    return out
