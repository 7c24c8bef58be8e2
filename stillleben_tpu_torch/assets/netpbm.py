"""Netpbm (PBM, PGM, PPM, plain and raw; PFM; PAM): decode as Pillow and
as OpenCV read them; encode as Pillow's ``save`` writes them.

- ``decode_netpbm`` gives Pillow 12's ``Image.open(p).convert("RGBA")``
  (``PpmImagePlugin``): ``P1``-``P6`` at any maxval and ``Pf``. Bitmaps
  are black where a bit is 1; samples over maxval 255 are rescaled to 16
  bits and held as mode I (grey), which ``convert`` clips at 255; other
  maxvals are rescaled to 8 bits with Python's rounding (raw samples over
  the maxval clip, plain ones raise); ``Pf`` is mode F (rows bottom-up,
  byte order by the scale's sign, the scale not applied), which converts
  by truncating into 0..255. Pillow's header reader: tokens of at most
  10 bytes, a ``#`` comment runs to the end of its line and may sit inside
  a token. It raises where Pillow raises: ``ValueError`` for a header or
  sample it refuses and for a file that is not one it identifies (``P7``
  and ``PF`` among them), ``OSError`` for raw data that ends early.
  Pillow's own test formats (``P0CMYK``, ``PyP``, ``PyRGBA``,
  ``PyCMYK``) raise ``NotImplementedError``.
- ``decode_netpbm_cv2`` gives ``cv2.imread(p, IMREAD_ANYCOLOR |
  IMREAD_ANYDEPTH)`` (``grfmt_pxm``, ``grfmt_pam``, ``grfmt_pfm``):
  ``P1``-``P6`` with grey one channel and colour BGR, uint16 above maxval
  255 with the samples as stored (no rescale), plain samples over maxval
  clipped and, at 8 bits, scaled by ``v * 255 // maxval``; PAM (``P7``)
  of depth 1 or 3 at maxval 2..65535 as stored (OpenCV copies those rows
  without swapping R and B); PFM ``Pf``/``PF``: float32, rows bottom-up,
  divided by the scale's magnitude, ``PF`` in BGR. None where OpenCV reads
  no image (an unknown signature, a header it refuses, data that ends
  early); ``NotImplementedError`` for the PAM layouts OpenCV converts
  through uninitialised memory (depth 2 or 4, maxval 1).
- ``encode_netpbm`` gives ``PpmImagePlugin._save``'s bytes for the modes
  the JAX ``ImageSaver`` hands Pillow, whatever the extension (``.ppm
  .pgm .pbm .pnm .pfm``): L as ``P5`` maxval 255, I;16 as ``P5`` maxval
  65535 (big-endian), RGB as ``P6``, RGBA as ``P6`` with the alpha dropped.

Every header is checked against Pillow's (or OpenCV's) size limit before
a sample is decoded.
"""

from __future__ import annotations

import numpy as np

from .image_limits import check_size

WHITESPACE = b" \t\n\x0b\x0c\r"
PIL_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
             b"Pf": "F"}
PIL_TEST_MODES = (b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK")  # Pillow's own extensions
SAFEBLOCK = 1024 * 1024  # ImageFile.SAFEBLOCK: the plain decoders read in blocks of this


def encode_netpbm(pixels: np.ndarray) -> bytes:
    """The Netpbm file Pillow writes for ``pixels`` as the JAX
    ``ImageSaver`` hands them over: (H, W) uint8, (H, W) uint16, (H, W, 3)
    or (H, W, 4) uint8."""
    a = np.asarray(pixels)
    h, w = a.shape[:2]
    if a.ndim == 2 and a.dtype == np.uint8:
        head, body = b"P5", b"255\n" + a.tobytes()
    elif a.ndim == 2 and a.dtype == np.uint16:
        head, body = b"P5", b"65535\n" + a.astype(">u2").tobytes()
    elif a.ndim == 3 and a.dtype == np.uint8 and a.shape[2] in (3, 4):
        head, body = b"P6", b"255\n" + np.ascontiguousarray(a[..., :3]).tobytes()
    else:
        raise ValueError(f"cannot write mode {a.dtype} {a.shape} as PPM")
    return head + b"\n%d %d\n" % (w, h) + body


# ---------------------------------------------------------------------------
# Pillow's reading
# ---------------------------------------------------------------------------


def _pil_token(data: bytes, pos: int, name: str) -> tuple[bytes, int]:
    """``PpmImageFile._read_token``."""
    token = b""
    while len(token) <= 10:
        c = data[pos: pos + 1]
        if not c:
            break
        pos += 1
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while True:
                c = data[pos: pos + 1]
                pos += len(c)
                if c in b"\r\n":  # the empty byte string at the end of the file too
                    break
            continue
        token += c
    if not token:
        raise ValueError(f"{name}: Reached EOF while reading header")
    if len(token) > 10:
        raise ValueError(f"{name}: Token too long in file header: {token!r}")
    return token, pos


def _pil_header(data: bytes, name: str) -> tuple[bytes, str, int, int, float, int]:
    """(magic, mode, width, height, maxval or scale, data offset)."""
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos: pos + 1]
        if not c:
            break
        pos += 1
        if c in WHITESPACE:
            break
        magic += c
    if magic in PIL_TEST_MODES:
        raise NotImplementedError(f"{name}: Pillow's test format {magic.decode()} is not supported")
    if magic not in PIL_MODES:
        raise ValueError(f"{name}: cannot identify the image (not a PPM file)")
    mode = PIL_MODES[magic]
    w, pos = _pil_token(data, pos, name)
    h, pos = _pil_token(data, pos, name)
    width, height = int(w), int(h)
    level = 1
    if mode == "F":
        tok, pos = _pil_token(data, pos, name)
        level = float(tok)
        if level == 0.0 or not np.isfinite(level):
            raise ValueError(f"{name}: scale must be finite and non-zero")
    elif mode != "1":
        tok, pos = _pil_token(data, pos, name)
        level = int(tok)
        if not 0 < level < 65536:
            raise ValueError(f"{name}: maxval must be greater than 0 and less than 65536")
    if width <= 0 or height <= 0:
        raise ValueError(f"{name}: cannot identify the image (a {width}x{height} PPM)")
    return magic, mode, width, height, level, pos


def _raw(data: bytes, pos: int, size: int, name: str) -> bytes:
    if len(data) - pos < size:
        raise OSError(f"{name}: image file is truncated ({len(data) - pos} bytes not processed)")
    return data[pos: pos + size]


def _blocks(data: bytes, pos: int):
    while pos < len(data):
        yield data[pos: pos + SAFEBLOCK]
        pos += SAFEBLOCK


def _comment_end(block: bytes, start: int = 0) -> int:
    a, b = block.find(b"\n", start), block.find(b"\r", start)
    return min(a, b) if a * b > 0 else max(a, b)


class _Comments:
    """``PpmPlainDecoder._ignore_comments``: a comment may span blocks."""

    def __init__(self, blocks):
        self.blocks, self.spans = blocks, False

    def strip(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = _comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = next(self.blocks, b"")
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = _comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block


def _not_enough(got: int, want: int, name: str) -> None:
    if got < want:
        raise ValueError(f"{name}: not enough image data")


def _plain_bits(data: bytes, pos: int, n: int, name: str) -> np.ndarray:
    """``_decode_bitonal``: 1 -> 0, 0 -> 255."""
    blocks = _blocks(data, pos)
    comments, out = _Comments(blocks), bytearray()
    while len(out) != n:
        block = next(blocks, b"")
        if not block:
            break
        tokens = b"".join(comments.strip(block).split())
        bad = tokens.translate(None, b"01")
        if bad:
            raise ValueError(f"{name}: Invalid token for this mode: {bad[:1]!r}")
        out = (out + tokens)[:n]
    _not_enough(len(out), n, name)
    return np.where(np.frombuffer(bytes(out), np.uint8) == ord("1"), 0, 255).astype(np.uint8)


def _plain_samples(data: bytes, pos: int, n: int, maxval: int, out_max: int,
                   name: str) -> np.ndarray:
    """``_decode_blocks``: ``n`` samples, each ``round(v / maxval * out_max)``."""
    blocks = _blocks(data, pos)
    comments, vals, half = _Comments(blocks), [], b""
    while len(vals) != n:
        block = next(blocks, b"")
        if not block:
            if not half:
                break
            block = b" "
        block = comments.strip(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError(f"{name}: Token too long found in data: {half[:11]!r}")
        for token in tokens:
            if len(token) > 10:
                raise ValueError(f"{name}: Token too long found in data: {token[:11]!r}")
            value = int(token)
            if value < 0:
                raise ValueError(f"{name}: Channel value is negative: {value}")
            if value > maxval:
                raise ValueError(f"{name}: Channel value too large for this mode: {value}")
            vals.append(round(value / maxval * out_max))
            if len(vals) == n:
                break
    _not_enough(len(vals), n, name)
    return np.array(vals, np.int64)


def _scaled(data: bytes, pos: int, n: int, maxval: int, out_max: int, name: str) -> np.ndarray:
    """``PpmDecoder``: raw samples of 1 or 2 bytes (big-endian), each
    ``min(out_max, round(v / maxval * out_max))``."""
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    size = np.dtype(dtype).itemsize
    got = min(n, (len(data) - pos) // size)
    _not_enough(got, n, name)
    v = np.frombuffer(data, dtype, count=n, offset=pos).astype(np.float64)
    return np.minimum(out_max, np.round(v / maxval * out_max)).astype(np.int64)


def _f2l(f: np.ndarray) -> np.ndarray:
    """Pillow's F -> L: 0 at or under 0 (and NaN), 255 at or over 255, else
    truncated."""
    with np.errstate(invalid="ignore"):
        v = np.where(f >= 255.0, 255.0, np.where(f > 0.0, f, 0.0))
    return v.astype(np.uint8)


def decode_netpbm(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    magic, mode, width, height, level, pos = _pil_header(data, name)
    check_size(width, height, name, "PPM")
    bands = 3 if mode == "RGB" else 1
    n = width * height * bands
    if magic == b"P1":
        v = _plain_bits(data, pos, width * height, name)
    elif magic == b"P4":
        stride = (width + 7) // 8
        raw = np.frombuffer(_raw(data, pos, stride * height, name), np.uint8)
        bits = np.unpackbits(raw.reshape(height, stride), axis=1)[:, :width]
        v = np.where(bits == 1, 0, 255).astype(np.uint8)
    elif mode == "F":
        order = "<f4" if level < 0 else ">f4"
        f = np.frombuffer(_raw(data, pos, 4 * n, name), order).reshape(height, width)
        v = _f2l(f[::-1].astype(np.float32))
    else:
        maxval = int(level)
        out_max = 65535 if (mode == "L" and maxval > 255) else 255
        if magic in (b"P2", b"P3"):
            v = _plain_samples(data, pos, n, maxval, out_max, name)
        elif maxval == 255:
            v = np.frombuffer(_raw(data, pos, n, name), np.uint8)
        elif maxval == 65535 and mode == "L":
            v = np.frombuffer(_raw(data, pos, 2 * n, name), ">u2")
        else:
            v = _scaled(data, pos, n, maxval, out_max, name)
        v = np.minimum(v, 255).astype(np.uint8)  # mode I clips on the way to RGBA
    out = np.empty((height, width, 4), np.uint8)
    out[..., :3] = np.asarray(v).reshape(height, width, bands)
    out[..., 3] = 255
    return out


# ---------------------------------------------------------------------------
# OpenCV's reading
# ---------------------------------------------------------------------------


class _Unread(Exception):
    """What makes ``imread`` give None: a header its decoder refuses, or
    the end of the data where it wants more."""


class _Stream:
    """OpenCV's ``RLByteStream``: a read past the end throws."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise _Unread("unexpected end of input stream")
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise _Unread("unexpected end of input stream")
        self.pos += n
        return self.data[self.pos - n: self.pos]


_SPACE = frozenset(b" \t\n\x0b\x0c\r")
_DIGIT = frozenset(b"0123456789")


def _cv_number(s: _Stream, maxdigits: int = 0) -> int:
    """``grfmt_pxm.cpp::ReadNumber``: skips blanks and ``#`` comments,
    reads digits and the byte after them (unless ``maxdigits`` stops it)."""
    code = s.byte()
    while code not in _DIGIT:
        if code == ord("#"):
            while code not in (10, 13):
                code = s.byte()
            code = s.byte()
        elif code in _SPACE:
            while code in _SPACE:
                code = s.byte()
        else:
            raise _Unread(f"PXM: unexpected code 0x{code:x} in ReadNumber()")
    val = digits = 0
    while True:
        val = val * 10 + code - 48
        if val > 0x7FFFFFFF:
            raise _Unread("PXM: ReadNumber(): result is too large")
        digits += 1
        if maxdigits and digits >= maxdigits:
            break
        code = s.byte()
        if code not in _DIGIT:
            break
    return val


def _pxm_cv2(data: bytes, name: str) -> np.ndarray:
    s = _Stream(data, 1)
    kind = s.byte() - 48
    bitmap, colour, binary = kind in (1, 4), kind in (3, 6), kind >= 4
    width, height = _cv_number(s), _cv_number(s)
    maxval = 1 if bitmap else _cv_number(s)
    if maxval > 65535 or not (width > 0 and height > 0 and maxval > 0):
        raise _Unread("PXM: bad header")
    check_size(width, height, name, "PNM", cv2=True)
    nch = 3 if colour else 1
    n = width * height * nch
    if bitmap:
        if binary:
            stride = (width + 7) // 8
            raw = np.frombuffer(s.take(stride * height), np.uint8).reshape(height, stride)
            bits = np.unpackbits(raw, axis=1)[:, :width]
        else:
            bits = np.array([_cv_number(s, 1) != 0 for _ in range(width * height)], np.uint8)
        return np.where(bits.reshape(height, width) != 0, 0, 255).astype(np.uint8)
    wide = maxval > 255
    if binary:
        v = np.frombuffer(s.take(n * (2 if wide else 1)), ">u2" if wide else np.uint8)
    else:
        v = np.minimum(np.array([_cv_number(s) for _ in range(n)], np.int64), maxval)
        if not wide:
            v = v * 255 // maxval
    out = v.astype(np.uint16 if wide else np.uint8).reshape((height, width, nch))
    return np.ascontiguousarray(out[..., ::-1]) if colour else out[..., 0]


_PAM_FIELDS = (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL", b"TUPLTYPE")
_PAM_TUPLTYPES = (b"", b"BLACKANDWHITE", b"GRAYSCALE", b"GRAYSCALE_ALPHA", b"RGB", b"RGB_ALPHA")


def _pam_line(s: _Stream) -> tuple[bytes | None, bytes]:
    """``ReadPAMHeaderLine``: (field or None for a blank or comment line,
    value)."""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    if code == ord("#"):
        while code not in (10, 13):
            code = s.byte()
        return None, b""
    if code in (10, 13):
        return None, b""
    ident = bytearray()
    while len(ident) < 8 and code not in _SPACE:
        ident.append(code)
        code = s.byte()
    if code not in _SPACE or bytes(ident) not in _PAM_FIELDS:
        raise _Unread("PAM: bad header line")
    if code in (10, 13):
        return bytes(ident), b""
    code = s.byte()
    while code in _SPACE:
        code = s.byte()
    value = bytearray()
    while len(value) < 255 and code not in (10, 13):
        value.append(code)
        code = s.byte()
    if code not in (10, 13):
        raise _Unread("PAM: header value too long")
    return bytes(ident), bytes(value).rstrip(b" \t\n\x0b\x0c\r")


def _pam_int(value: bytes) -> int:
    """``grfmt_pam.cpp::ParseInt`` (an empty value is 0)."""
    pos, neg = 0, value[:1] == b"-"
    if neg:
        pos = 1
        if value[1:2] not in [bytes([d]) for d in _DIGIT]:
            raise _Unread("PAM: bad number")
    number = 0
    while pos < len(value) and value[pos] in _DIGIT:
        number = number * 10 + value[pos] - 48
        if number >= 0x7FFFFFFF:
            raise _Unread("PAM: number too large")
        pos += 1
    if pos < len(value):
        raise _Unread("PAM: bad number")
    return -number if neg else number


def _pam_cv2(data: bytes, name: str) -> np.ndarray:
    s = _Stream(data, 2)
    if s.byte() not in (10, 13):
        raise _Unread("PAM: bad header")
    fields: dict[bytes, int] = {}
    tupltype = b""
    while True:
        field, value = _pam_line(s)
        if field is None:
            continue
        if field == b"ENDHDR":
            break
        if field == b"TUPLTYPE":
            if value not in _PAM_TUPLTYPES:
                raise _Unread(f"PAM: unknown TUPLTYPE {value!r}")
            tupltype = value
            continue
        if field in fields:
            raise _Unread(f"PAM: {field.decode()} given twice")
        fields[field] = _pam_int(value)
        if field == b"MAXVAL" and fields[field] > 65535:
            raise _Unread("PAM: maxval over 65535")
    if len(fields) < 4:
        raise _Unread("PAM: header without WIDTH, HEIGHT, DEPTH and MAXVAL")
    width, height, depth, maxval = (fields[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    if not tupltype and not (depth in (1, 3) and maxval < 256):
        raise _Unread("PAM: can't determine the tuple type")
    if not 1 <= depth <= 4:
        raise _Unread("PAM: unsupported number of channels")
    check_size(width, height, name, "PAM", cv2=True)
    if depth not in (1, 3) or maxval == 1:
        raise NotImplementedError(
            f"{name}: PAM of depth {depth} at maxval {maxval} is not supported (OpenCV converts "
            "it through uninitialised memory)")
    wide = maxval > 255
    n = width * height * depth
    v = np.frombuffer(s.take(n * (2 if wide else 1)), ">u2" if wide else np.uint8)
    out = v.astype(np.uint16 if wide else np.uint8).reshape(height, width, depth)
    return out[..., 0] if depth == 1 else out


def _pfm_number(s: _Stream) -> bytes:
    """``grfmt_pfm.cpp::read_number``: the bytes up to one blank."""
    out = bytearray()
    while len(out) < 2048:
        c = s.byte()
        if c >= 128:
            raise _Unread("PFM: byte out of range in the header")
        if c in _SPACE:
            break
        out.append(c)
    return bytes(out)


def _c_prefix(tok: bytes, chars: bytes) -> bytes:
    end = 0
    while end < len(tok) and tok[end] in chars:
        end += 1
    return tok[:end]


def _pfm_cv2(data: bytes, name: str) -> np.ndarray:
    s = _Stream(data, 1)
    nch = 3 if s.byte() == ord("F") else 1
    if s.byte() != 10:
        raise _Unread("PFM: expected a line break")
    dims = []
    for _ in range(2):
        tok = _pfm_number(s)
        digits = _c_prefix(tok.lstrip(b" \t\n\x0b\x0c\r"), b"+-0123456789")
        try:
            dims.append(int(digits))
        except ValueError:
            dims.append(0)
    width, height = dims
    try:
        scale = float(_pfm_number(s))
    except ValueError:
        raise _Unread("PFM: bad scale")
    check_size(width, height, name, "PFM", cv2=True)
    order = "<f4" if scale < 0 else ">f4"
    rows = np.frombuffer(s.take(4 * width * height * nch), order)
    if not abs(scale) > 0.0:
        raise _Unread("PFM: the scale is 0")
    img = rows.reshape(height, width, nch)[::-1].astype(np.float32)
    img = img * np.float32(1.0 / abs(scale))
    return np.ascontiguousarray(img[..., ::-1]) if nch == 3 else np.ascontiguousarray(img[..., 0])


def decode_netpbm_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """The array ``cv2.imread(IMREAD_ANYCOLOR | IMREAD_ANYDEPTH)`` gives, or
    None where it gives none (see the module's docstring)."""
    if len(data) < 3 or data[:1] != b"P" or data[2] not in _SPACE:
        return None
    kind = data[1:2]
    try:
        if kind in (b"1", b"2", b"3", b"4", b"5", b"6"):
            return _pxm_cv2(data, name)
        if kind == b"7":
            return _pam_cv2(data, name)
        if kind in (b"f", b"F"):
            return _pfm_cv2(data, name)
    except _Unread:
        return None
    return None
