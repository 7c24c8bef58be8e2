"""What Pillow 12's ``Image.open`` and ``ImageFile.load`` do around a
format's own code, shared by the readers of its rarer formats.

- ``NotThisFormat``: a header that Pillow's plugin rejects with
  ``SyntaxError`` (or with the ``IndexError``, ``TypeError``, ``KeyError``,
  ``EOFError`` or ``struct.error`` that ``ImageFile`` turns into one):
  ``Image.open`` then tries the next format of its list.
- ``raw_rows``: Pillow's ``raw`` decoder over a file's bytes (lines of
  ``width x bits`` bits, an optional stride, bottom-up with ``ystep`` -1),
  and ``truncated``: the ``OSError`` ``ImageFile.load`` raises where the
  data ends first, counting the bytes the decoder left unprocessed. With
  ``mapped`` (a file opened by its path, in a mode Pillow maps: L, P,
  I;16, I;16B) the rows are what ``Image.core.map_buffer`` points at, as
  ``ImageFile.load`` takes that path first: a stride of 0 or less is the
  mode's packed one, rows may overlap, and a file too short for them
  raises its ``ValueError``.
- ``codec_error``: the ``OSError`` of a C decoder's error code;
  ``NoRGBA``: the ``TypeError`` of a reading whose RGB conversion works.
- ``to_rgba``: ``convert("RGBA")`` of the modes these formats open as
  (1, L, P, RGB, RGBA, I, I;16, I;16B, F).
"""

from __future__ import annotations

import numpy as np

from .netpbm import _f2l

# Image.core.getcodecstatus
CODEC_STATUS = {-1: "buffer overrun", -2: "broken data stream",
                -3: "unrecognized data stream contents", -8: "codec configuration error",
                -9: "out of memory"}


class NotThisFormat(Exception):
    """Pillow's plugin does not take the file: the next format is tried."""


class NoRGBA(TypeError):
    """Pillow's ``convert("RGBA")`` fails where its ``convert("RGB")`` reads
    the image (an RGB XPM with a ``None`` colour): ``rgb`` holds that
    reading, (H, W, 3) uint8."""

    def __init__(self, message: str, rgb: np.ndarray):
        super().__init__(message)
        self.rgb = rgb


def truncated(left: int) -> OSError:
    """``ImageFile.load``'s error where the file ends before the image."""
    return OSError(f"image file is truncated ({left} bytes not processed)")


def codec_error(code: int) -> OSError:
    """``ImageFile._get_oserror`` of a decoder's error code."""
    return OSError(f"{CODEC_STATUS.get(code, f'decoder error {code}')} when reading image file")


def raw_rows(data: bytes, offset: int, width: int, height: int, bits: int, stride: int = 0,
             ystep: int = 1, mapped: bool = False) -> np.ndarray:
    """(height, line bytes) uint8: Pillow's ``raw`` decoder of ``height``
    lines of ``width * bits`` bits at ``offset``, ``stride`` bytes apart
    (0: packed), the first line at the bottom with ``ystep`` -1. Raises as
    ``ImageFile.load`` does where the data ends first; ``mapped``: see the
    module."""
    line = (width * bits + 7) // 8
    if mapped and offset + height * stride <= len(data):
        step = stride if stride > 0 else line
        if offset + height * step > len(data):
            raise ValueError("buffer is not large enough")
        buf = np.frombuffer(data, np.uint8, len(data) - offset, offset)
        rows = np.array(np.lib.stride_tricks.as_strided(buf, (height, line), (step, 1)))
        return rows[::-1] if ystep < 0 else rows
    skip = stride - line if stride else 0
    if skip < 0:
        raise codec_error(-8)
    avail = max(0, len(data) - offset)
    need = height * line + (height - 1) * skip
    if avail < need:
        if avail < line:
            raise truncated(avail)
        rem = (avail - line) % (skip + line)
        raise truncated(rem - skip if rem >= skip else rem)
    buf = np.frombuffer(data, np.uint8, avail, offset)
    rows = np.lib.stride_tricks.as_strided(buf, (height, line), (line + skip, 1))
    rows = np.array(rows)
    return rows[::-1] if ystep < 0 else rows


def file_read(data: bytes, pos: int, n: int, from_file: bool) -> bytes:
    """``fp.read(n)`` at ``pos``: a negative length reads the rest, except
    that a file's ``read`` refuses one under -1."""
    if n < -1 and from_file:
        raise ValueError("read length must be non-negative or -1")
    return data[pos:] if n < 0 else data[pos: pos + n]


def unpack_bits(rows: np.ndarray, width: int) -> np.ndarray:
    """(h, w) 0/1 of packed 1-bit rows, most significant bit first."""
    return np.unpackbits(rows, axis=1)[:, :width]


def unpack_nibbles(rows: np.ndarray, width: int) -> np.ndarray:
    """(h, w) 0..15 of packed 4-bit rows, high nibble first."""
    return np.stack([rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)[:, :width]


def to_rgba(mode: str, v: np.ndarray, palette: np.ndarray | None = None) -> np.ndarray:
    """``convert("RGBA")`` of an image of ``mode`` held as ``v`` ((h, w) for
    one band, (h, w, c) for RGB and RGBA; "1" as 0/1); ``palette`` is P's
    (n, 3) uint8, entries past its end black."""
    h, w = v.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)
        pal[: len(palette)] = palette[:256]
        out[..., :3] = pal[v]
        return out
    if mode in ("RGB", "RGBA"):
        out[..., :len(mode)] = v[..., :len(mode)]
        return out
    if mode == "1":
        g = (v * 255).astype(np.uint8)
    elif mode == "L":
        g = v
    elif mode in ("I", "I;16", "I;16B"):
        g = np.clip(v, 0, 255).astype(np.uint8)
    elif mode == "F":
        g = _f2l(v)
    else:
        raise ValueError(f"no conversion from mode {mode}")
    out[..., :3] = g[..., None]
    return out
