"""JPEG 2000: written as Pillow 12.1.0's ``save`` writes it (OpenJPEG 2.5.4
at Pillow's defaults), read as Pillow's ``convert("RGBA")`` and OpenCV's
``imread(ANYCOLOR | ANYDEPTH)`` read such files.

- ``encode_jpeg2000(pixels, kind)``: 8-bit L, RGB, RGBA or 16-bit grey
  (``I;16``), the modes the JAX ``ImageSaver`` hands Pillow. The
  codestream is the native encoder's (``csrc/sl_j2k.cpp``: one tile, the
  reversible 5/3 wavelet at min(5, floor(log2(min(W, H)))) levels, no
  colour transform, LRCP, one layer, 64x64 code-blocks). ``kind="j2k"``
  gives the bare codestream; ``kind="jp2"`` wraps it as Pillow does: the
  signature and ``ftyp`` boxes, ``jp2h`` (``ihdr``, ``colr``: greyscale
  or sRGB, and for RGBA a ``cdef`` naming channel 3 the opacity), then
  ``jp2c``. Pillow picks the codestream only for a file name ending in
  ``.j2k`` (``EXTENSIONS``).
- ``decode_jpeg2000(data, name)``: (H, W, 4) uint8. Pillow's mode comes
  from the codestream's SIZ or the JP2 header's ``ihdr``: one component
  is L, or I;16 above 8 bits (clipped at 255 on the way to RGBA); two are
  LA, three RGB, four RGBA; 16-bit colour keeps its high byte. The image
  is the SIZ's less its offset (Xsiz - XOsiz by Ysiz - YOsiz); a signed
  sample reads as Pillow unpacks it, offset by half its range.
- ``decode_samples(data, name)``: the samples as stored (the round trip
  of ``encode_jpeg2000``); signed ones as int8 or int16 (a size up where
  unsigned components sit beside them).
- ``decode_jpeg2000_cv2(data, name)``: OpenCV's reading: one component
  stays grey, colour becomes BGR with any alpha dropped, 16-bit samples
  stay uint16; two components of a bare codestream give None (OpenCV's
  sRGB conversion refuses them), of a greyscale JP2 the grey channel
  three times; signed samples or an image offset give None.

The decoder reads every codestream Pillow's ``save`` writes, at any of
its options: either wavelet (the irreversible 9/7 in OpenJPEG 2.5.4's
single-precision arithmetic, so bitwise), with or without the colour
transform (RCT or ICT), quality layers, precincts, the five progression
orders and POC, tiles and image offsets, several tile-parts, PLT and TLM
markers, signed samples, any number of levels and any code-block size.
Others (a code-block style other than 0, SOP/EPH markers, COC, QCC, RGN,
PPM, PPT, derived quantisation, precisions other than 8 and 16,
sub-sampled components, a POC that leaves out a component's highest
resolution, a palette, CMYK or sYCC colour) raise ``NotImplementedError``
by name (ROADMAP.md, the reading queue).
"""

from __future__ import annotations

import struct

import numpy as np

from . import native_image
from .image_limits import check_size

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# the extensions Pillow writes as JPEG 2000; only .j2k gets the bare codestream
EXTENSIONS = (".jp2", ".j2k", ".j2c", ".jpc", ".jpf", ".jpx")
_GREY, _SRGB = 17, 16


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _samples(pixels: np.ndarray) -> np.ndarray:
    a = np.asarray(pixels)
    ok = (a.dtype == np.uint16 and a.ndim == 2) or (
        a.dtype == np.uint8 and (a.ndim == 2 or (a.ndim == 3 and a.shape[2] in (3, 4))))
    if not ok or 0 in a.shape:
        raise ValueError(f"expected uint8 L, RGB or RGBA or uint16 grey pixels, not {a.dtype} "
                         f"{a.shape}")
    return a


def encode_jpeg2000(pixels: np.ndarray, kind: str = "jp2") -> bytes:
    """The file Pillow's ``save`` writes: ``kind`` "j2k" (a ``.j2k`` name)
    or "jp2" (every other JPEG 2000 extension)."""
    if kind not in ("j2k", "jp2"):
        raise ValueError(f"kind must be 'j2k' or 'jp2', not {kind!r}")
    a = _samples(pixels)
    codestream = native_image.j2k_encode(a)
    if kind == "j2k":
        return codestream
    h, w = a.shape[:2]
    nc = 1 if a.ndim == 2 else a.shape[2]
    bpc = 8 * a.itemsize - 1
    header = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    header += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, _GREY if nc == 1 else _SRGB))
    if nc == 4:
        entries = [(i, 0, i + 1) for i in range(3)] + [(3, 1, 0)]
        header += _box(b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", *e) for e in entries))
    return (JP2_MAGIC + _box(b"ftyp", b"jp2 " + struct.pack(">I", 0) + b"jp2 ")
            + _box(b"jp2h", header) + _box(b"jp2c", codestream))


def _boxes(data: bytes, start: int, end: int, name: str):
    """(type, body start, body end) of each box in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        length, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if length == 1:
            if pos + 16 > end:
                break
            length = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif length == 0:
            length = end - pos
        if length < head or pos + length > end:
            raise ValueError(f"{name}: a JP2 box runs past its container")
        yield kind, pos + head, pos + length
        pos += length


def _parse(data: bytes, name: str):
    """(codestream, ihdr's (components, bpc) or None, colr's enumerated
    colour space or None)."""
    if data.startswith(J2K_MAGIC):
        return data, None, None
    if not data.startswith(JP2_MAGIC):
        raise ValueError(f"{name}: not a JPEG 2000 file")
    ihdr = colour = codestream = None
    for kind, b0, b1 in _boxes(data, len(JP2_MAGIC), len(data), name):
        if kind == b"jp2h":
            for sub, s0, s1 in _boxes(data, b0, b1, name):
                if sub == b"ihdr" and s1 - s0 >= 11:
                    ihdr = struct.unpack_from(">HB", data, s0 + 8)
                elif sub == b"colr" and s1 - s0 >= 3:
                    meth = data[s0]
                    if meth != 1:
                        raise NotImplementedError(f"{name}: a JP2 colour space given by an ICC "
                                                  "profile is not supported")
                    colour = struct.unpack_from(">I", data, s0 + 3)[0]
                elif sub == b"pclr":
                    raise NotImplementedError(f"{name}: a JP2 palette is not supported")
        elif kind == b"jp2c":
            codestream = data[b0:b1]
            break
    if ihdr is None:
        raise ValueError(f"{name}: malformed JP2 header")
    if codestream is None:
        # OpenJPEG finds no codestream: Pillow's load fails as a broken
        # stream, OpenCV reads nothing (``NoCodestream``)
        raise NoCodestream("broken data stream when reading image file")
    if colour is not None and colour not in (_GREY, _SRGB):
        raise NotImplementedError(f"{name}: the JP2 colour space {colour} is not supported "
                                  "(only greyscale and sRGB)")
    return codestream, ihdr, colour


def _read(data: bytes, name: str, cv2: bool):
    codestream, ihdr, colour = _parse(data, name)
    info = native_image.j2k_info(codestream, name)
    if ihdr is not None and ihdr[0] != info["components"]:
        raise ValueError(f"{name}: the JP2 header's {ihdr[0]} components disagree with the "
                         f"codestream's {info['components']}")
    check_size(info["width"], info["height"], name, "JPEG 2000", cv2)
    return native_image.j2k_decode(codestream, info, name), info, ihdr, colour


class NoCodestream(OSError):
    """A JP2 file whose boxes hold no codestream (what ``cv2.imwrite`` leaves
    where its encoder fails): Pillow's ``OSError``, None for OpenCV."""


def decode_samples(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The samples as the file stores them: (H, W) for one component, else
    (H, W, C); uint8 up to 8 bits, else uint16. ``encode_jpeg2000``'s
    coding is lossless, so this gives back the array it was given."""
    s, info, _, _ = _read(data, name, cv2=False)
    signed = (info["signed"] >> np.arange(info["components"])) & 1
    if signed.any():  # the native decoder gives a signed sample plus half its range
        types = (np.int8, np.int16, np.int32)[info["precision"] > 8:]
        s = (s.astype(np.int32) - signed * (1 << (info["precision"] - 1))).astype(
            types[not signed.all()])  # wide enough for unsigned components beside them
    elif info["precision"] <= 8:
        s = s.astype(np.uint8)
    return s[..., 0] if info["components"] == 1 else s


def decode_jpeg2000(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``Image.open(p).convert("RGBA")``."""
    s, info, ihdr, _ = _read(data, name, cv2=False)
    nc = info["components"]
    # Pillow's tests: the SIZ's precision, or the ihdr's bits per component - 1
    wide = info["precision"] > 8 if ihdr is None else (ihdr[1] & 0x7F) > 8
    h, w = s.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if nc == 1 and wide:  # "I;16"
        out[..., :3] = np.minimum(s, 255).astype(np.uint8)
        out[..., 3] = 255
        return out
    # Pillow 12.1.0 rounds wider colour and grey + alpha samples to 8 bits,
    # and the sum wraps: ((s + 128) >> 8) & 255 at 16 bits
    shift = info["precision"] - 8
    if shift > 0:
        s = ((s.astype(np.int64) + (1 << (shift - 1))) >> shift) & 255
    s8 = s.astype(np.uint8)
    if nc <= 2:
        out[..., :3] = s8[..., :1]
        out[..., 3] = s8[..., 1] if nc == 2 else 255
    else:
        out[..., :3] = s8[..., :3]
        out[..., 3] = s8[..., 3] if nc == 4 else 255
    return out


def decode_jpeg2000_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """What ``cv2.imread(path, IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` gives:
    grey (H, W), colour (H, W, 3) BGR; uint8, or uint16 above 8 bits."""
    try:
        s, info, _, colour = _read(data, name, cv2=True)
    except NoCodestream:
        return None
    if info["signed"] or info["x0"] or info["y0"]:  # OpenCV refuses both
        return None
    if info["precision"] <= 8:
        s = s.astype(np.uint8)
    nc = info["components"]
    if nc == 1:
        return s[..., 0]
    if colour == _GREY:
        return np.ascontiguousarray(np.repeat(s[..., :1], 3, axis=2))
    if nc == 2:
        return None
    return np.ascontiguousarray(s[..., 2::-1])
