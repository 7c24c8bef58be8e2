"""IM (IFUNC Image Memory, ``.im``): encode as Pillow's ``save`` writes it,
decode as Pillow reads it (``ImImagePlugin``).

- ``encode_im`` gives the bytes of Pillow 12's ``save`` of an L, RGB, RGBA
  or I;16 image to ``path``: the text header (``Image type``, ``Name:``
  the path's base name with its extension, the name cut to leave the line
  at most 92 characters as Pillow cuts it, ``Image size (x*y)``, ``File
  size (no of images): 1``, each line ending in CR LF) padded with NULs to
  511 bytes, 0x1A, then the samples with the rows bottom-up, each row's
  channels one after the other (``RGB;L``, ``RGBA;L``), I;16
  little-endian.
- ``parse_header`` is Pillow's test of whether a file is IM at all (IM has
  no magic: Pillow tries it after PCX, DCX and DDS, and takes a file whose
  first 100 bytes hold a newline and whose header lines up to a NUL or
  0x1A all parse as ``key: value`` with at least one of its keys).
- ``decode_im`` gives ``Image.open(p).convert("RGBA")`` of frame 0 for the
  kinds Pillow's ``SAVE`` table writes (``0 1``, ``Greyscale``, ``LA``,
  ``L 32S``, ``L 16``, ``L 16L``, ``L 16B``, ``L 32F``, ``RGB``, ``RGBA``,
  ``RGBX``, ``CMYK``, ``YCC``) and P and PA, which it writes as
  ``Greyscale`` and ``LA`` with a ``Lut`` (a planar 768-byte palette after
  the header; a grey one leaves the image L or LA). Pillow's other kinds
  raise ``NotImplementedError`` by name.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .image_limits import check_size
from .netpbm import _f2l

TAGS = ("Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut",
        "Name", "Scale (x,y)", "Image size (x*y)", "Image type")
# the kinds the port reads: Pillow's mode and raw mode (ImImagePlugin.OPEN)
KINDS = {"0 1 image": ("1", "1"), "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
         "LA image": ("LA", "LA;L"), "L 32S image": ("I", "I;32S"),
         "L 16 image": ("I;16", "I;16"), "L 16L image": ("I;16", "I;16L"),
         "L 16B image": ("I;16", "I;16B"), "L 32F image": ("F", "F;32F"),
         "RGB image": ("RGB", "RGB;L"), "RGBA image": ("RGBA", "RGBA;L"),
         "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
         "YCC image": ("YCbCr", "YCbCr;L")}
# ImImagePlugin.OPEN's other kinds: Pillow reads them, the port does not
OTHER_KINDS = ({"L 1 image", "RLB image", "RYB image", "B1 image", "B2 image", "B4 image",
                "X 24 image", "RGB3 image", "RYB3 image", "PA image"}
               | {f"L {i} image" for i in ("8", "8S", "16S", "32", "32F")}
               | {f"L*{i} image" for i in ("8", "8S", "16", "16S", "16L", "16B", "32", "32F",
                                          "32S")}
               | {f"L*{j} image" for j in range(2, 33)}) - set(KINDS)
SAVE = {"L": "Greyscale", "RGB": "RGB", "RGBA": "RGBA", "I;16": "L 16"}
_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# Pillow's YCbCr -> RGB tables (ConvertYCbCr.h, 6 fraction bits)
_I = np.arange(256) - 128
R_CR, G_CB, G_CR, B_CB = (np.trunc(c * _I * 64 + 0.5).astype(np.int64)
                          for c in (1.402, -0.34414, -0.71414, 1.772))


def encode_im(pixels: np.ndarray, path: str) -> bytes:
    """The IM file Pillow writes for (H, W), (H, W, 3) or (H, W, 4) uint8 or
    (H, W) uint16 pixels saved to ``path``."""
    a = np.asarray(pixels)
    if a.dtype == np.uint16 and a.ndim == 2:
        mode, body = "I;16", a[::-1].astype("<u2").tobytes()
    elif a.dtype == np.uint8 and a.ndim == 2:
        mode, body = "L", a[::-1].tobytes()
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] in (3, 4):
        mode = "RGB" if a.shape[2] == 3 else "RGBA"
        body = np.ascontiguousarray(a[::-1].transpose(0, 2, 1)).tobytes()
    else:
        raise ValueError(f"Cannot save {a.dtype} {a.shape} images as IM")
    h, w = a.shape[:2]
    name, ext = os.path.splitext(os.path.basename(path))
    name = "".join([name[: 92 - len(ext)], ext])
    head = (f"Image type: {SAVE[mode]} image\r\nName: {name}\r\n"
            f"Image size (x*y): {w}*{h}\r\nFile size (no of images): 1\r\n").encode("ascii")
    return head + b"\0" * (511 - len(head)) + b"\x1a" + body


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def parse_header(data: bytes) -> tuple[dict, int] | None:
    """Pillow's ``ImImageFile._open`` up to the end of the header: the
    fields and the position after the 0x1A, or None where Pillow finds no
    IM file (it then tries the next format). A size or count that is not a
    number raises ``ValueError`` as in Pillow. Without an ``Image type``
    the image is L."""
    if b"\n" not in data[:100]:
        return None
    info = {"Image type": "Greyscale image", "Image size (x*y)": (512, 512),
            "File size (no of images)": 1}
    pos, n, s = 0, 0, b""
    while True:
        s = data[pos: pos + 1]
        pos += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            return None
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _SPLIT.match(s)
        if not m:
            return None
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            v = tuple(map(_number, v.replace("*", ",").split(",")))  # ValueError as Pillow's
            v = v[0] if len(v) == 1 else v
        info[k] = v
        n += k in TAGS
    if not n:
        return None
    while s and not s.startswith(b"\x1a"):
        s = data[pos: pos + 1]
        pos += 1
    if not s:
        return None
    return info, pos


def _planes(raw: np.ndarray, h: int, w: int, bands: int) -> np.ndarray:
    """Rows of ``bands`` lines each (the ``;L`` raw modes) -> (h, w, bands)."""
    return raw.reshape(h, bands, w).transpose(0, 2, 1)


def _ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    y = ycc[..., 0].astype(np.int64)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (R_CR[cr] >> 6), y + ((G_CB[cb] + G_CR[cr]) >> 6), y + (B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    nk = 255 - cmyk[..., 3:].astype(np.int64)
    t = cmyk[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def decode_im(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")`` of frame 0."""
    parsed = parse_header(data)
    if parsed is None:
        raise ValueError(f"{name}: not an IM file")
    info, pos = parsed
    kind = info["Image type"]
    if kind in OTHER_KINDS:
        raise NotImplementedError(f"{name}: IM images of type {kind!r} are not supported")
    if kind not in KINDS:
        raise ValueError(f"{name}: unknown IM image type {kind!r}")
    mode, raw = KINDS[kind]
    size = info["Image size (x*y)"]
    if not (isinstance(size, tuple) and len(size) == 2 and all(isinstance(v, int) for v in size)):
        raise ValueError(f"{name}: bad IM image size {size!r}")
    w, h = size
    check_size(w, h, name, "IM")
    palette = None
    if "Lut" in info:
        lut = np.frombuffer(data[pos: pos + 768], np.uint8)
        if len(lut) < 768:
            raise OSError(f"{name}: image file is truncated")
        pos += 768
        lut = lut.reshape(3, 256)
        grey = bool((lut[0] == lut[1]).all() and (lut[1] == lut[2]).all())
        if mode in ("L", "LA") and not grey:
            mode, raw = ("P", "P") if mode == "L" else ("PA", "PA;L")
            palette = lut.T
    # bits a pixel; RGB holds three or four (RGBX) samples
    bits = {"1": 1, "L": 8, "P": 8, "LA": 16, "PA": 16, "I;16": 16, "YCbCr": 24,
            "RGB": 8 * len(raw[:-2])}.get(mode, 32)
    n = (w * bits + 7) // 8 * h
    if len(data) < pos + n:
        raise OSError(f"{name}: image file is truncated")
    body = np.frombuffer(data, np.uint8, n, pos)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if mode == "1":
        v = np.unpackbits(body.reshape(h, -1), axis=1)[:, :w] * 255
    elif mode in ("L", "P"):
        v = body.reshape(h, w)
    elif mode in ("LA", "PA"):
        v = _planes(body, h, w, 2)
        out[..., 3] = v[..., 1]
        v = v[..., 0]
    elif mode == "I;16":
        v = np.minimum(body.view(">u2" if raw == "I;16B" else "<u2").reshape(h, w), 255)
    elif mode == "I":
        v = np.clip(body.view("<i4").reshape(h, w), 0, 255)
    elif mode == "F":
        v = _f2l(body.view("<f4").reshape(h, w))
    else:
        v = _planes(body, h, w, 4 if raw in ("RGBA;L", "RGBX;L", "CMYK;L") else 3)
        if mode == "RGBA":
            out[..., 3] = v[..., 3]
        v = {"CMYK": _cmyk_to_rgb, "YCbCr": _ycbcr_to_rgb}.get(mode, lambda x: x[..., :3])(v)
    v = palette[v] if palette is not None else v
    out[..., :3] = v if v.ndim == 3 else v.astype(np.uint8)[..., None]
    return out[::-1]
