"""AVIF read as Pillow 12.1.0's ``convert("RGBA")`` (libavif 1.3.0 over
dav1d 1.5.1, libyuv's conversion) and OpenCV 5.0.0's ``imread(ANYCOLOR |
ANYDEPTH)`` (libavif 1.4.2 over aom) read it, and written for the modes the
JAX ``ImageSaver`` hands Pillow's ``save`` at its defaults (quality 75).

The container is parsed here: the HEIF boxes libavif reads for a still image
(``ftyp``; ``meta`` with ``hdlr`` ``pict``, ``pitm``, ``iloc`` versions 0-2
with construction methods 0 and 1 (``idat``), ``iinf``/``infe``,
``iprp``/``ipco``/``ipma`` with ``ispe``, ``pixi``, ``av1C``, ``colr``,
``auxC``, and ``iref`` ``auxl`` and ``prem``). The colour item's and the
alpha item's AV1 bitstreams go to the native decoder (``csrc/sl_av1.cpp``):
an AV1 intra decoder for what Pillow's writer and OpenCV's (aom) write at
any of their settings: 8-, 10- and 12-bit samples, 4:2:0, 4:2:2, 4:4:4 or
monochrome colour, a monochrome alpha item, every intra tool, quantizer
matrices, lossless blocks, the deblocking filter, CDEF and loop
restoration (``csrc/sl_av1_post.h``), and film grain on the output. Then
libavif's conversion to RGB, which differs between the two readers:

- Pillow asks libavif for 8-bit RGB (RGBA with an alpha item). 8-bit colour
  goes through libyuv's fixed-point arithmetic with its bilinear chroma
  upsampling for BT.601 (matrix coefficients 2, 5 and 6) and BT.709 (1),
  full or limited range, and libavif copies the identity matrix (0) of a
  full-range 4:4:4 item. 10- and 12-bit colour without alpha is shifted to
  8 bits first; with alpha it takes libyuv's 10-bit rows (10-bit), its
  12-bit rows with the nearest chroma sample (12-bit 4:2:0) or the 8-bit
  path (12-bit 4:2:2 and 4:4:4), its alpha shifted or rounded to 8 bits
  accordingly. A monochrome item is libavif's own single-precision grey
  without alpha and libyuv's ``I400`` with it (``_pillow_rgba``); the
  identity matrix at 10 and 12 bits (OpenCV's lossless files) libavif's own
  rounding of each channel.
- OpenCV keeps 8-bit colour on libyuv's path, converts 10- and 12-bit colour
  through libavif's single-precision path to uint16 at the item's depth
  (the identity matrix as a copy), and copies a monochrome item's luma
  plane as it is (with an alpha item its reader fails: None).

A limited-range 8-bit alpha item is widened as libavif widens it (Pillow's
rounds, OpenCV's truncates); premultiplied colour is divided by its alpha as
libyuv's ``ARGBUnattenuate`` divides it (both readers straighten it).

- ``decode_avif(data, name)``: (H, W, 4) uint8; the alpha item's samples
  (narrowed to 8 bits), else 255. The pixels stay as stored: ``irot``/
  ``imir`` become an EXIF orientation in Pillow, not a turn.
- ``decode_avif_cv2(data, name)``: (H, W, 3) BGR, uint8 or uint16 at 10 and
  12 bits (values up to 1023 and 4095), the alpha dropped; (H, W) for a
  monochrome item; None for a monochrome item with alpha.
- ``encode_avif(arr)``: the file of an L, RGB, RGBA or I;16 array.
  ``encode_avif_reconstructed(arr)`` gives the reconstruction beside it:
  what any reader of the file decodes, through libyuv's conversion.

Writing follows Pillow's ``_save``: L and I;16 (clamped at 255) become RGB;
libavif's RGB to YUV 4:2:0 (BT.601 full range, its single-precision
arithmetic); an RGBA array whose alpha is all 255 writes no alpha item. The
AV1 items are the native encoder's (``csrc/sl_av1_enc.cpp``) at the
quantizer libavif picks for quality 75 (``BASE_Q_IDX``, both items), and the
HEIF boxes are libavif's, box for box: only ``iloc``'s extents and the
``mdat`` differ from Pillow's file of the same array. The AV1 bitstream is
the port's own (its block decisions; aom's depend on the host's CPU count,
ROADMAP C-24); its sequence header and ``av1C`` are aom's, byte for byte.

What neither reading of this port decodes raises ``NotImplementedError`` by
name (ROADMAP.md, the reading queue): grid items, a sequence with no
primary still item, an essential property libavif would refuse, matrix
coefficients other than 0, 1, 2, 5 and 6, the identity matrix on a
subsampled, limited-range or monochrome item, an alpha item
of another depth than its colour, a limited-range or premultiplied alpha of
10 or 12 bits, and in the bitstream 4:4:0 colour, superres, and inter or
intra-only frames.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import native_image
from .image_limits import check_size

# Pillow's ``_accept``: "ftyp" at byte 4 and one of these major brands
BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", b"urn:mpeg:hevc:2015:auxid:1")
# the properties libavif reads; an essential one not in this list is refused
KNOWN_PROPERTIES = (b"ispe", b"pixi", b"av1C", b"colr", b"auxC", b"pasp", b"clap", b"irot",
                    b"imir", b"a1op", b"lsel", b"a1lx", b"clli", b"cclv", b"amve")


def is_avif(data: bytes) -> bool:
    return data[4:8] == b"ftyp" and data[8:12] in BRANDS


class AvifItems(NamedTuple):
    color: bytes  # the colour item's AV1 OBUs
    alpha: bytes | None  # the alpha item's, or None
    width: int  # from ispe
    height: int
    has_colr: bool  # an nclx colr property; else the AV1 sequence header's values count
    matrix: int  # nclx matrix coefficients (2 = unspecified)
    full_range: bool
    premultiplied: bool  # the colour item refers to its alpha by "prem"


def _boxes(data: bytes, pos: int, end: int, name: str):
    while pos + 8 <= end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError(f"{name}: truncated box header")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise ValueError(f"{name}: box {kind!r} overruns its parent")
        yield kind, pos + head, pos + size
        pos += size


def _uint(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "big") if n else 0


def _parse_iloc(data: bytes, s: int, e: int) -> dict:
    version = data[s]
    pos = s + 4
    sizes = struct.unpack(">H", data[pos:pos + 2])[0]
    off_size, len_size, base_size = sizes >> 12, (sizes >> 8) & 15, (sizes >> 4) & 15
    index_size = sizes & 15 if version in (1, 2) else 0
    pos += 2
    id_size = 4 if version == 2 else 2
    count = _uint(data, pos, id_size)
    pos += id_size
    items = {}
    for _ in range(count):
        item_id = _uint(data, pos, id_size)
        pos += id_size
        method = 0
        if version in (1, 2):
            method = _uint(data, pos, 2) & 15
            pos += 2
        pos += 2  # data_reference_index
        base = _uint(data, pos, base_size)
        pos += base_size
        n_ext = _uint(data, pos, 2)
        pos += 2
        extents = []
        for _ in range(n_ext):
            pos += index_size
            off = _uint(data, pos, off_size)
            pos += off_size
            length = _uint(data, pos, len_size)
            pos += len_size
            extents.append((base + off, length))
        items[item_id] = (method, extents)
    if pos > e:
        raise ValueError("iloc overruns its box")
    return items


def parse_avif(data: bytes, name: str = "<bytes>") -> AvifItems:
    """The primary item's and its alpha's AV1 bitstreams and CICP values."""
    top = dict((k, (s, e)) for k, s, e in _boxes(data, 0, len(data), name))
    if b"meta" not in top:
        if data[8:12] in (b"avis", b"msf1"):
            raise NotImplementedError(f"{name}: an AVIF image sequence with no primary still "
                                      "item is not supported")
        raise ValueError(f"{name}: AVIF file has no meta box")
    ms, me = top[b"meta"]
    meta = {}
    for k, s, e in _boxes(data, ms + 4, me, name):
        meta.setdefault(k, (s, e))
    if b"hdlr" not in meta or data[meta[b"hdlr"][0] + 8:meta[b"hdlr"][0] + 12] != b"pict":
        raise ValueError(f"{name}: AVIF meta box has no pict handler")
    if b"pitm" not in meta:
        if data[8:12] in (b"avis", b"msf1"):
            raise NotImplementedError(f"{name}: an AVIF image sequence with no primary still "
                                      "item is not supported")
        raise ValueError(f"{name}: AVIF file has no primary item")
    s, _ = meta[b"pitm"]
    primary = _uint(data, s + 4, 4 if data[s] else 2)

    types = {}
    if b"iinf" in meta:
        s, e = meta[b"iinf"]
        n = 4 if data[s] else 2
        for k, bs, be in _boxes(data, s + 4 + n, e, name):
            if k != b"infe" or data[bs] < 2:
                continue
            idn = 4 if data[bs] == 3 else 2
            item_id = _uint(data, bs + 4, idn)
            types[item_id] = data[bs + 4 + idn + 2:bs + 4 + idn + 6]
    locs = _parse_iloc(data, *meta[b"iloc"]) if b"iloc" in meta else {}

    props = []
    assoc: dict[int, list[tuple[int, bool]]] = {}
    if b"iprp" in meta:
        ps, pe = meta[b"iprp"]
        for k, s, e in _boxes(data, ps, pe, name):
            if k == b"ipco":
                props = [(pk, bs, be) for pk, bs, be in _boxes(data, s, e, name)]
            elif k == b"ipma":
                version, flags = data[s], _uint(data, s + 1, 3)
                pos = s + 4
                count = _uint(data, pos, 4)
                pos += 4
                for _ in range(count):
                    idn = 2 if version < 1 else 4
                    item_id = _uint(data, pos, idn)
                    pos += idn
                    na = data[pos]
                    pos += 1
                    lst = assoc.setdefault(item_id, [])
                    for _ in range(na):
                        if flags & 1:
                            v = _uint(data, pos, 2)
                            pos += 2
                            lst.append((v & 0x7FFF, bool(v >> 15)))
                        else:
                            v = data[pos]
                            pos += 1
                            lst.append((v & 0x7F, bool(v >> 7)))

    refs: list[tuple[bytes, int, list[int]]] = []
    if b"iref" in meta:
        s, e = meta[b"iref"]
        idn = 4 if data[s] else 2
        for k, bs, be in _boxes(data, s + 4, e, name):
            src = _uint(data, bs, idn)
            n = _uint(data, bs + idn, 2)
            refs.append((k, src, [_uint(data, bs + idn + 2 + i * idn, idn) for i in range(n)]))

    def item_props(item_id):
        out = {}
        for index, essential in assoc.get(item_id, ()):
            if index == 0:
                continue
            if index > len(props):
                raise ValueError(f"{name}: AVIF property index {index} out of range")
            kind, s, e = props[index - 1]
            if kind not in KNOWN_PROPERTIES:
                if essential:
                    raise NotImplementedError(f"{name}: AVIF essential property "
                                              f"{kind.decode('latin-1')!r} is not supported")
                continue
            out.setdefault(kind, (s, e))
        return out

    def payload(item_id):
        if item_id not in locs:
            raise ValueError(f"{name}: AVIF item {item_id} has no location")
        method, extents = locs[item_id]
        if method == 0:  # offsets in the file
            base = 0
        elif method == 1:  # offsets in the idat box
            if b"idat" not in meta:
                raise ValueError(f"{name}: AVIF item {item_id} lies in a missing idat box")
            base = meta[b"idat"][0]
        else:
            raise NotImplementedError(f"{name}: AVIF item construction method {method} is not "
                                      "supported")
        out = bytearray()
        for off, length in extents:
            start = base + off
            if length == 0:
                length = len(data) - start
            if start + length > len(data):
                raise OSError("image file is truncated")
            out += data[start:start + length]
        return bytes(out)

    kind = types.get(primary)
    if kind == b"grid":
        raise NotImplementedError(f"{name}: AVIF grid images are not supported")
    if kind != b"av01":
        raise ValueError(f"{name}: AVIF primary item is not an AV1 image")
    cprops = item_props(primary)
    if b"ispe" not in cprops:
        raise ValueError(f"{name}: AVIF primary item has no ispe")
    s, _ = cprops[b"ispe"]
    width, height = struct.unpack(">II", data[s + 4:s + 12])
    has_colr, matrix, full_range = False, 2, False
    if b"colr" in cprops:
        s, e = cprops[b"colr"]
        if data[s:s + 4] == b"nclx":
            has_colr = True
            matrix = struct.unpack(">H", data[s + 8:s + 10])[0]
            full_range = bool(data[s + 10] >> 7)

    alpha_id = None
    for k, src, dsts in refs:
        if k == b"auxl" and primary in dsts and types.get(src) in (b"av01", b"grid"):
            aux = item_props(src).get(b"auxC")
            if aux is None:
                continue
            urn = data[aux[0] + 4:aux[1]].split(b"\0")[0]
            if urn in ALPHA_URNS:
                if types[src] == b"grid":
                    raise NotImplementedError(f"{name}: AVIF grid images are not supported")
                alpha_id = src
                break
    # the colour item refers to its alpha by "prem" when the colour is
    # premultiplied by it
    prem = alpha_id is not None and any(k == b"prem" and src == primary and alpha_id in dsts
                                        for k, src, dsts in refs)
    return AvifItems(payload(primary), payload(alpha_id) if alpha_id is not None else None,
                     width, height, has_colr, matrix, full_range, prem)


# nclx matrix coefficients libavif converts (through libyuv, or as a copy
# for the identity): identity (0), BT.709 (1), and the BT.601 ones,
# unspecified (2), BT.470BG (5), BT.601 (6)
MATRICES = (0, 1, 2, 5, 6)


def _limited_to_full(a: np.ndarray, cv2: bool) -> np.ndarray:
    """A limited-range alpha item widened to full range, clamped to 0..255:
    (v - 16) * 255 / 219 rounded to nearest by Pillow's libavif 1.3.0, and
    truncated toward zero (C's integer division) by OpenCV's libavif 1.4.2."""
    v = (a.astype(np.int32) - 16) * 255 / 219
    return np.clip(np.fix(v) if cv2 else np.floor(v + 0.5), 0, 255).astype(np.uint8)


# libyuv's fixed_invtbl8: 1 / alpha in 8.8 fixed point
_INV_ALPHA = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] + [0x100], np.int64)


def _unpremultiply(rgba: np.ndarray) -> None:
    """libyuv's ARGBUnattenuate, in place, as libavif calls it to turn
    premultiplied colour into straight: each channel c of alpha a becomes
    min(255, (c * 257 * inv(a)) >> 16) (``_INV_ALPHA``)."""
    inv = _INV_ALPHA[rgba[..., 3:4]]
    rgba[..., :3] = np.minimum((rgba[..., :3].astype(np.int64) * 257 * inv) >> 16, 255)


def _alpha8(a: np.ndarray, depth: int, by_float: bool) -> np.ndarray:
    """An alpha item of more than 8 bits narrowed to 8 as Pillow's libavif
    narrows it: libyuv's shift (``a >> (depth - 8)``) or libavif's own
    single-precision rounding of ``a / max * 255``."""
    if by_float:
        f = a.astype(np.float32) / np.float32((1 << depth) - 1) * np.float32(255) + np.float32(0.5)
        return f.astype(np.uint8)
    return np.minimum(a >> (depth - 8), 255).astype(np.uint8)


def _identity(planes: tuple, depth: int, sub: tuple[int, int], full: bool, name: str,
              dtype) -> np.ndarray:
    """(H, W, 4) RGBA of a 10- or 12-bit identity-matrix item (R, G, B from
    V, Y, U) as libavif's own path converts it: OpenCV's at the item's depth
    (uint16, a copy), Pillow's to 8 bits (uint8: each ``v / max * 255``
    rounded in single precision); alpha at its maximum. A subsampled or
    limited-range one is refused."""
    if sub != (0, 0) or not full:
        kind = ("4:4:4", "4:4:0", "4:2:2", "4:2:0")[sub[0] * 2 + sub[1]]
        rng = "" if full else "limited-range "
        raise NotImplementedError(f"{name}: AVIF {rng}identity matrix on {kind} colour is not "
                                  "supported")
    top = (1 << depth) - 1
    rgb = np.stack([planes[2], planes[0], planes[1]], -1)
    if dtype == np.uint8:
        rgb = (np.float32(0.5) + rgb.astype(np.float32) / np.float32(top) * np.float32(255))
    out = np.empty(rgb.shape[:2] + (4,), dtype)
    out[..., :3] = rgb
    out[..., 3] = top if dtype == np.uint16 else 255
    return out


def _pillow_rgba(planes: tuple, depth: int, sub: tuple[int, int], matrix: int, full: bool,
                 alpha: np.ndarray | None, name: str) -> tuple[np.ndarray, bool]:
    """The (H, W, 4) uint8 colour as Pillow's libavif 1.3.0 converts it
    (alpha 255), and whether an alpha item of more than 8 bits narrows by
    libavif's rounding (else by libyuv's shift). Which conversion runs
    depends on the depth, the subsampling and whether Pillow asks for RGBA
    (an alpha item) or RGB; each was settled against the library's
    ``avifImageYUVToRGB`` on random planes: 8-bit colour through libyuv's
    8-bit rows; 10- and 12-bit colour without alpha shifted to 8 bits first
    (libavif's ``Convert16To8Plane``), with alpha through libyuv's 10-bit
    rows (10-bit), its 12-bit rows with the nearest chroma (12-bit 4:2:0)
    or shifted to 8 bits (12-bit 4:2:2, 4:4:4); a monochrome item through
    libavif's own single-precision path without alpha, and through libyuv's
    ``I400`` (shifted to 8 bits) with it."""
    mono = len(planes) == 1
    if matrix == 0 and depth > 8:  # libavif's own identity path, full-range 4:4:4
        return _identity(planes, depth, sub, full, name, np.uint8), True
    down = tuple((p >> (depth - 8)).astype(np.uint8) for p in planes) if depth > 8 else planes
    if mono and alpha is None:
        return native_image.yuv16_to_rgba(planes, depth, sub, matrix, full,
                                          native_image.YUV16_FLOAT8, name), False
    if mono:  # libyuv's I400: the rows of 4:4:4 with neutral chroma
        flat = np.full_like(down[0], 128)
        return native_image.yuv_to_rgba(down[0], flat, flat, (0, 0), matrix, full, name), True
    if depth == 8 or alpha is None or (depth == 12 and sub != (1, 1)):
        return native_image.yuv_to_rgba(*down, sub, matrix, full, name), False
    kind = native_image.YUV16_LIBYUV if depth == 10 else native_image.YUV16_LIBYUV_NEAREST
    return native_image.yuv16_to_rgba(planes, depth, sub, matrix, full, kind, name), depth == 12


def _decode(data: bytes, name: str, cv2: bool) -> np.ndarray | None:
    items = parse_avif(data, name)
    info = native_image.av1_info(items.color, name)
    if (info["width"], info["height"]) != (items.width, items.height):
        raise ValueError(f"{name}: AVIF frame of {info['width']}x{info['height']} in an item of "
                         f"{items.width}x{items.height}")
    matrix, full = (items.matrix, items.full_range) if items.has_colr else (info["matrix"],
                                                                          bool(info["full_range"]))
    if matrix not in MATRICES:
        raise NotImplementedError(f"{name}: AVIF matrix coefficients {matrix} are not supported")
    depth, mono = info["bit_depth"], bool(info["monochrome"])
    if matrix == 0 and mono:
        raise NotImplementedError(f"{name}: AVIF identity matrix on monochrome colour is not "
                                  "supported")
    check_size(items.width, items.height, name, "AVIF", cv2)
    sub = (info["subsampling_x"], info["subsampling_y"])
    planes = native_image.av1_decode(items.color, info, name)
    a = None
    if items.alpha is not None:
        ainfo = native_image.av1_info(items.alpha, name)
        if (ainfo["width"], ainfo["height"]) != (items.width, items.height):
            raise ValueError(f"{name}: AVIF alpha of {ainfo['width']}x{ainfo['height']} for an "
                             f"image of {items.width}x{items.height}")
        if ainfo["bit_depth"] != depth:
            raise NotImplementedError(f"{name}: AVIF {ainfo['bit_depth']}-bit alpha of "
                                      f"{depth}-bit colour is not supported")
        if depth > 8 and (not ainfo["full_range"] or items.premultiplied):
            kind = "premultiplied" if items.premultiplied else "limited-range"
            raise NotImplementedError(f"{name}: AVIF {kind} {depth}-bit alpha is not supported")
        a = native_image.av1_decode(items.alpha, ainfo, name)[0]
        if depth == 8 and not ainfo["full_range"]:
            a = _limited_to_full(a, cv2)
    if cv2:
        if mono:
            # OpenCV copies the luma plane as it is; with an alpha item its
            # reader fails and reads nothing
            return None if a is not None else planes[0]
        if depth > 8:  # libavif's own path at the image's depth
            out = (_identity(planes, depth, sub, full, name, np.uint16) if matrix == 0 else
                   native_image.yuv16_to_rgba(planes, depth, sub, matrix, full,
                                              native_image.YUV16_FLOAT, name))
            return np.ascontiguousarray(out[..., 2::-1])
        out = native_image.yuv_to_rgba(*planes, sub, matrix, full, name)
        if a is not None and items.premultiplied:
            out[..., 3] = a
            _unpremultiply(out)
        return np.ascontiguousarray(out[..., 2::-1])
    out, by_float = _pillow_rgba(planes, depth, sub, matrix, full, a, name)
    if a is not None:
        out[..., 3] = a if depth == 8 else _alpha8(a, depth, by_float)
        if items.premultiplied:
            _unpremultiply(out)
    return out


def decode_avif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 as Pillow's ``convert("RGBA")``."""
    return _decode(data, name, False)


def decode_avif_cv2(data: bytes, name: str = "<bytes>") -> np.ndarray | None:
    """As OpenCV's ``imread(ANYCOLOR | ANYDEPTH)``: (H, W, 3) BGR, the
    alpha dropped, uint8 at 8 bits and uint16 at 10 and 12 (values up to
    1023 and 4095); a monochrome item as its (H, W) luma plane, None with
    an alpha item."""
    return _decode(data, name, True)


# libavif's quantizer for quality 75, ((100 - 75) * 63 + 50) // 100 = 16,
# in aom's quantizer_to_qindex: the base_q_idx of Pillow's colour and alpha
# items at its default quality
BASE_Q_IDX = 64
ALPHA_URN = ALPHA_URNS[0]


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _full_box(kind: bytes, payload: bytes, version: int = 0, flags: int = 0) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def _av1c(obus: bytes, monochrome: bool) -> bytes:
    """The av1C property of an item from its sequence header (the OBU after
    the temporal delimiter): profile 0, the level, 8-bit 4:2:0 or
    monochrome, no config OBUs."""
    level = ((obus[4] & 7) << 2) | (obus[5] >> 6)
    return _box(b"av1C", bytes((0x81, level, (int(monochrome) << 4) | 0x0C, 0)))


# the ftyp of libavif's still image: the AVIF baseline profile (MA1B), as
# libavif writes it for the main AV1 profile at every size
FTYP_BRANDS = b"avif" + b"\0\0\0\0" + b"avifmif1miafMA1B"


def avif_container(color: bytes, alpha: bytes | None, width: int, height: int) -> bytes:
    """libavif 1.3.0's file of a still image: the colour item (1) and its
    alpha item (2), each an AV1 item's OBUs; the alpha's data first in the
    mdat."""
    ftyp = _box(b"ftyp", FTYP_BRANDS)
    hdlr = _full_box(b"hdlr", b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full_box(b"pitm", struct.pack(">H", 1))
    infe = [_full_box(b"infe", struct.pack(">HH", 1, 0) + b"av01Color\0", version=2)]
    props = [_full_box(b"ispe", struct.pack(">II", width, height)),
             _full_box(b"pixi", bytes((3, 8, 8, 8))), _av1c(color, False),
             _box(b"colr", b"nclx" + struct.pack(">HHHB", 1, 13, 6, 0x80))]
    assoc = [(1, (1, 2, 0x83, 4))]
    iref = b""
    if alpha is not None:
        infe.append(_full_box(b"infe", struct.pack(">HH", 2, 0) + b"av01Alpha\0", version=2))
        iref = _full_box(b"iref", _box(b"auxl", struct.pack(">HHH", 2, 1, 1)))
        props += [_full_box(b"pixi", bytes((1, 8))), _av1c(alpha, True),
                  _full_box(b"auxC", ALPHA_URN + b"\0")]
        assoc.append((2, (1, 5, 0x86, 7)))
    iinf = _full_box(b"iinf", struct.pack(">H", len(infe)) + b"".join(infe))
    ipma = _full_box(b"ipma", struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", item, len(a)) + bytes(a) for item, a in assoc))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)

    def meta(offsets):
        locs = [(1, offsets[0], len(color))]
        if alpha is not None:
            locs.append((2, offsets[1], len(alpha)))
        iloc = _full_box(b"iloc", bytes((0x44, 0)) + struct.pack(">H", len(locs)) + b"".join(
            struct.pack(">HHHII", item, 0, 1, off, n) for item, off, n in locs))
        return _full_box(b"meta", hdlr + pitm + iloc + iinf + iref + iprp)

    start = len(ftyp) + len(meta((0, 0))) + 8
    offsets = (start + (len(alpha) if alpha is not None else 0), start)
    data = (alpha or b"") + color
    return ftyp + meta(offsets) + _box(b"mdat", data)


def _saver_rgb(arr: np.ndarray) -> np.ndarray:
    """The RGB or RGBA array Pillow's ``_save`` encodes for the JAX saver's
    image of ``arr``: L and I;16 (clamped at 255) become RGB."""
    if arr.dtype == np.uint16:
        arr = np.minimum(arr, 255).astype(np.uint8)
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=2)
    return np.ascontiguousarray(arr)


def encode_avif_reconstructed(arr: np.ndarray, name: str = "<array>") -> tuple[bytes, np.ndarray]:
    """``encode_avif``'s file and the (H, W, 4) uint8 RGBA any reader
    decodes from it (the encoder's reconstruction through libyuv's
    conversion; alpha 255 without an alpha item)."""
    rgb = _saver_rgb(np.asarray(arr))
    h, w = rgb.shape[:2]
    planes = native_image.rgb_to_yuv420(rgb)
    color, recon = native_image.av1_encode(planes, BASE_Q_IDX, name)
    out = native_image.yuv_to_rgba(*recon, (1, 1), 2, True, name)
    alpha = None
    if rgb.shape[2] == 4 and not (rgb[..., 3] == 255).all():
        alpha, (a,) = native_image.av1_encode((rgb[..., 3],), BASE_Q_IDX, name)
        out[..., 3] = a
    return avif_container(color, alpha, w, h), out


def encode_avif(arr: np.ndarray, name: str = "<array>") -> bytes:
    """The AVIF file of an L, RGB, RGBA or I;16 array, as the port writes
    Pillow's ``save`` at its defaults (see the module docstring)."""
    return encode_avif_reconstructed(arr, name)[0]
