"""FITS (``.fits .fit``), read as Pillow reads it (``FitsImagePlugin``).

80-byte header cards up to ``END``, the header unit padded to 2880 bytes;
``BITPIX`` 8, 16, 32, -32 and -64 open as L, I;16, I and F. Pillow reads the
samples with its native raw modes, so 16- and 32-bit integers and floats
are taken little-endian although FITS stores them big-endian, and a
64-bit float image reads the first four bytes of each sample pair as
floats; rows go bottom-up. The offset is where Pillow's header loop stops:
80 bytes before the end of the first read past the header (a file that
ends inside that read moves it back). A gzip-compressed image
(``XTENSION= 'BINTABLE'`` with ``ZIMAGE = T`` and ``ZCMPTYPE=
'GZIP_1  '``) is decompressed whole (``FitsGzipDecoder``): each sample
the last min(BITPIX / 8, 4) bytes of 4, rows reversed. The conversions to
RGBA are Pillow's: I;16 and I clipped to 255, F as ``_f2l``.
"""

from __future__ import annotations

import gzip
import math

import numpy as np

from .image_limits import check_size
from .pillow_open import NotThisFormat, raw_rows, to_rgba

MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}
# Pillow's raw modes on this little-endian host: (bytes, dtype)
SAMPLES = {"L": (1, np.uint8), "I;16": (2, "<u2"), "I": (4, "<i4"), "F": (4, "<f4")}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"SIMPLE")


def _size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse(headers: dict):
    """``_parse_headers``: (decoder, offset, mode, size, bits) or None."""
    prefix, decoder, offset = b"", "raw", 0
    if (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
            and headers[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        w, h = _size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _size(headers, prefix)
    if not size:
        return None
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, MODES.get(bits, ""), size, bits


def _header(data: bytes):
    """Pillow's ``_open``: (decoder, offset, mode, size, bits)."""
    headers, in_progress, parsed, pos = {}, False, None, 0
    while True:
        card = data[pos: pos + 80]
        pos += len(card)
        if not card:
            raise OSError("Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not parsed:
                try:
                    parsed = _parse(headers)
                except KeyError as e:
                    raise NotThisFormat(str(e)) from e
            in_progress = False
            continue
        if parsed:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not accept(keyword) or value != b"T"):
            raise NotThisFormat("Not a FITS file")
        headers[keyword] = value
    if not parsed:
        raise ValueError("No image data")
    decoder, offset, mode, size, bits = parsed
    return decoder, offset + min(pos, len(data)) - 80, mode, size, bits


def decode_fits(data: bytes, name: str = "<bytes>", from_file: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    if not accept(data):
        raise NotThisFormat("Not a FITS file")
    decoder, offset, mode, (w, h), bits = _header(data)
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat("not identified by this driver")
    check_size(w, h, name, "FITS")
    nbytes, dtype = SAMPLES[mode]
    if decoder == "raw":
        rows = raw_rows(data, offset, w, h, 8 * nbytes, ystep=-1,
                        mapped=from_file and mode in ("L", "I;16"))
    else:
        flat = _gzip_rows(gzip.decompress(data[max(0, offset):]), w, h, min(bits // 8, 4))
        if len(flat) < w * h * nbytes:
            raise ValueError("not enough image data")
        rows = flat[: w * h * nbytes].reshape(h, w * nbytes)
    v = rows.view(dtype).reshape(h, w) if nbytes > 1 else rows.reshape(h, w)
    return to_rgba(mode, v.astype(np.float32) if mode == "F" else v)


def _gzip_rows(value: bytes, w: int, h: int, keep: int) -> np.ndarray:
    """``FitsGzipDecoder``'s bytes: of each 4-byte sample its last ``keep``
    bytes (none where ``keep`` is not positive), the rows reversed; a short
    ``value`` cuts the samples short as Python's slices do."""
    if keep <= 0:
        return np.zeros(0, np.uint8)
    if len(value) >= 4 * w * h:
        samples = np.frombuffer(value, np.uint8, 4 * w * h).reshape(h, w, 4)
        return np.ascontiguousarray(samples[::-1, :, 4 - keep:]).reshape(-1)
    rows, offset = [], 0
    for _ in range(h):
        row = bytearray()
        for _ in range(w):
            row += value[offset + (4 - keep): offset + 4]
            offset += 4
        rows.append(row)
    return np.frombuffer(b"".join(rows[::-1]), np.uint8)
