"""ctypes binding of the port's native image codec core (``csrc/sl_image.cpp``),
of its WebP decoder (``csrc/sl_webp.cpp``) and of its WebP encoder
(``csrc/sl_webp_enc.cpp``; the two WebP sources share ``sl_vp8_tables.h``).

The serial bit loops of the image formats: JPEG's entropy coding and
sample arithmetic (decode and encode), the LZW decoders of GIF and TIFF,
the run-length decoders of BMP, TGA and TIFF (PackBits), and the whole of
WebP's decode (VP8, VP8L, ALPH, the container and frame 0) and encode
(libwebp's lossy encoder as Pillow's ``save`` drives it). Each source is
built at first use by ``native_build.build_library`` (``g++ -O3 -shared
-fPIC -std=c++17`` into the gitignored ``_build/``, named by a hash of the
source and its headers); a compile or load that fails raises with the
compiler's message. There is no decoder or encoder in Python beside it.

Each wrapper raises ``NotImplementedError`` for a variant the core does
not decode, ``ValueError`` for a file that is not valid and ``OSError``
for one that ends before its image does (Pillow's "image file is
truncated").
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .image_limits import check_size
from .native_build import BUILD_DIR, PKG_DIR, build_library

SOURCE = os.path.join(PKG_DIR, "csrc", "sl_image.cpp")
HEADER = os.path.join(PKG_DIR, "csrc", "sl_image.h")
WEBP_SOURCE = os.path.join(PKG_DIR, "csrc", "sl_webp.cpp")
WEBP_TABLES = os.path.join(PKG_DIR, "csrc", "sl_vp8_tables.h")
WEBP_HEADER = (os.path.join(PKG_DIR, "csrc", "sl_webp.h"), WEBP_TABLES)
WEBP_ENC_SOURCE = os.path.join(PKG_DIR, "csrc", "sl_webp_enc.cpp")
WEBP_ENC_HEADER = (os.path.join(PKG_DIR, "csrc", "sl_webp_enc.h"), WEBP_TABLES)

_OK, _UNSUPPORTED, _CORRUPT, _NO_ROOM, _TRUNCATED = 0, 1, 2, 3, 4
_ERRLEN = 512

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_webp_lib: ctypes.CDLL | None = None
_webp_enc_lib: ctypes.CDLL | None = None


def build() -> str:
    """Compile the source if this version is not built yet; returns the
    library's path. Raises ``RuntimeError`` with the compiler's output."""
    return build_library("sl_image", SOURCE, HEADER, BUILD_DIR, "the native image codec")


def build_webp() -> str:
    """``build`` of the WebP decoder."""
    return build_library("sl_webp", WEBP_SOURCE, WEBP_HEADER, BUILD_DIR, "the native WebP decoder")


def build_webp_enc() -> str:
    """``build`` of the WebP encoder."""
    return build_library("sl_webp_enc", WEBP_ENC_SOURCE, WEBP_ENC_HEADER, BUILD_DIR,
                         "the native WebP encoder")


def load_webp_enc_library() -> ctypes.CDLL:
    """Build (if needed) and load the WebP encoder, once per process."""
    global _webp_enc_lib
    with _lock:
        if _webp_enc_lib is None:
            lib = ctypes.CDLL(build_webp_enc())
            lib.sl_webp_encode.restype = ctypes.c_int
            lib.sl_webp_encode.argtypes = (
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_int)
            lib.sl_webp_enc_free.restype = None
            lib.sl_webp_enc_free.argtypes = (ctypes.POINTER(ctypes.c_uint8),)
            lib.sl_webp_enc_planes.restype = ctypes.c_int
            lib.sl_webp_enc_planes.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int) + (ctypes.c_void_p,) * 5
            _webp_enc_lib = lib
        return _webp_enc_lib


def load_webp_library() -> ctypes.CDLL:
    """Build (if needed) and load the WebP decoder, once per process."""
    global _webp_lib
    with _lock:
        if _webp_lib is None:
            lib = ctypes.CDLL(build_webp())
            for fn in ("sl_webp_info", "sl_webp_decode"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                             ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int)
            lib.sl_webp_header_cv2.restype = ctypes.c_int
            lib.sl_webp_header_cv2.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                               ctypes.c_char_p, ctypes.c_int)
            _webp_lib = lib
        return _webp_lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn in ("sl_jpeg_info", "sl_jpeg_decode", "sl_jpeg_encode", "sl_gif_lzw",
                       "sl_tiff_lzw", "sl_bmp_rle", "sl_tga_rle", "sl_packbits"):
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc: int, err, name: str) -> None:
    if rc == _OK:
        return
    msg = f"{name}: {err.value.decode(errors='replace')}"
    if rc == _UNSUPPORTED:
        raise NotImplementedError(msg)
    if rc == _TRUNCATED:
        raise OSError(msg)
    raise ValueError(msg)


def jpeg_info(data: bytes, name: str = "<bytes>") -> dict:
    """The frame of a JPEG: width, height, components and colour space
    (0 grey, 1 YCbCr, 2 RGB)."""
    lib = load_library()
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.sl_jpeg_info(data, ctypes.c_size_t(len(data)), _ptr(info), err, _ERRLEN), err, name)
    keys = ("width", "height", "components", "colour_space")
    return dict(zip(keys, (int(v) for v in info)))


def jpeg_decode(data: bytes, name: str = "<bytes>", cv2: bool = False) -> np.ndarray:
    """(H, W) grey or (H, W, 3) RGB uint8. A file that ends before its EOI
    raises as Pillow does, unless ``cv2``: then what libjpeg makes of it (the
    missing entropy data left as it is, a flat block per missing MCU), as
    OpenCV reads it. The size limits are Pillow's, or with ``cv2`` OpenCV's."""
    info = jpeg_info(data, name)
    h, w, c = info["height"], info["width"], info["components"]
    check_size(w, h, name, "JPEG", cv2)
    out = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = load_library().sl_jpeg_decode(data, ctypes.c_size_t(len(data)), _ptr(out), err, _ERRLEN)
    if not (cv2 and rc == _TRUNCATED):
        _check(rc, err, name)
    return out[..., 0] if c == 1 else out


def jpeg_encode(pixels: np.ndarray, quality: int, h0: int, v0: int) -> bytes:
    """Baseline JFIF bytes of (H, W) grey or (H, W, 3) RGB uint8."""
    pix = np.ascontiguousarray(pixels, np.uint8)
    h, w = pix.shape[:2]
    c = 1 if pix.ndim == 2 else pix.shape[2]
    cap = 4096 + ((h + 15) // 16 * 16) * ((w + 15) // 16 * 16) * c * 8
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_library().sl_jpeg_encode(_ptr(pix), w, h, c, quality, h0, v0, _ptr(out),
                                         ctypes.c_size_t(cap), ctypes.byref(n), err, _ERRLEN),
           err, "JPEG encode")
    return out[: n.value].tobytes()


def gif_lzw(data: bytes, min_code_size: int, npix: int, name: str = "<bytes>") -> np.ndarray:
    """Up to ``npix`` palette indices (fewer when the data ends early)."""
    out = np.zeros(npix, np.uint8)
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_library().sl_gif_lzw(data, ctypes.c_size_t(len(data)), min_code_size, _ptr(out),
                                     ctypes.c_size_t(npix), ctypes.byref(n), err, _ERRLEN),
           err, name)
    return out[: n.value]


def tiff_lzw(data: bytes, size: int, name: str = "<bytes>") -> bytes:
    """One LZW strip or tile, up to ``size`` bytes."""
    out = np.zeros(size, np.uint8)
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_library().sl_tiff_lzw(data, ctypes.c_size_t(len(data)), _ptr(out),
                                      ctypes.c_size_t(size), ctypes.byref(n), err, _ERRLEN),
           err, name)
    return out[: n.value].tobytes()


def bmp_rle(data: bytes, pos: int, width: int, height: int, rle4: bool,
            name: str = "<bytes>") -> np.ndarray:
    """(height, width) palette indices, rows in file order, of the RLE8 or
    RLE4 stream at ``pos`` as Pillow's ``BmpRleDecoder`` reads it."""
    out = np.empty((height, width), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_library().sl_bmp_rle(data, ctypes.c_size_t(len(data)), ctypes.c_size_t(pos),
                                     ctypes.c_uint32(width), ctypes.c_uint32(height), int(rle4),
                                     _ptr(out), err, _ERRLEN), err, name)
    return out


def tga_rle(data: bytes, pos: int, npix: int, bpp: int, width: int,
            name: str = "<bytes>") -> bytes:
    """``npix`` pixels of ``bpp`` bytes from the run-length packets at ``pos``."""
    out = np.empty(npix * bpp, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_library().sl_tga_rle(data, ctypes.c_size_t(len(data)), ctypes.c_size_t(pos),
                                     ctypes.c_size_t(npix), bpp, ctypes.c_size_t(width),
                                     _ptr(out), err, _ERRLEN), err, name)
    return out.tobytes()


def packbits(data: bytes, size: int, name: str = "<bytes>") -> bytes:
    """One PackBits strip or tile, up to ``size`` bytes."""
    out = np.zeros(size, np.uint8)
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_library().sl_packbits(data, ctypes.c_size_t(len(data)), _ptr(out),
                                      ctypes.c_size_t(size), ctypes.byref(n), err, _ERRLEN),
           err, name)
    return out[: n.value].tobytes()


def webp_info(data: bytes, name: str = "<bytes>", cv2: bool = False) -> dict:
    """The container of a WebP file as Pillow's reading (or, with ``cv2``,
    OpenCV's) parses it: the canvas, Pillow's alpha (mode RGBA), frame 0's
    rectangle, whether it is lossless, and the number of frames."""
    info = np.zeros(9, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_webp_library().sl_webp_info(data, ctypes.c_size_t(len(data)), int(cv2),
                                            _ptr(info), err, _ERRLEN), err, name)
    keys = ("width", "height", "alpha", "x", "y", "frame_width", "frame_height", "lossless",
            "frames")
    return dict(zip(keys, (int(v) for v in info)))


def webp_header_cv2(data: bytes, name: str = "<bytes>") -> tuple[int, int]:
    """(width, height) as OpenCV's ``imread`` reads them before it checks
    its size limits: the features of the first 32 bytes (an animation
    must also pass the demuxer)."""
    size = np.zeros(2, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_webp_library().sl_webp_header_cv2(data, ctypes.c_size_t(len(data)), _ptr(size),
                                                  err, _ERRLEN), err, name)
    return int(size[0]), int(size[1])


def webp_decode(data: bytes, width: int, height: int, name: str = "<bytes>",
                cv2: bool = False) -> np.ndarray:
    """Frame 0 on its ``width`` x ``height`` canvas, (H, W, 4) RGBA uint8,
    transparent black outside the frame. The caller has checked the
    canvas's size (``webp_info``, ``check_size``)."""
    out = np.zeros((height, width, 4), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_webp_library().sl_webp_decode(data, ctypes.c_size_t(len(data)), int(cv2),
                                              _ptr(out), err, _ERRLEN), err, name)
    return out


def _rgb_or_rgba(pixels: np.ndarray) -> np.ndarray:
    pix = np.ascontiguousarray(pixels, np.uint8)
    if pix.ndim != 3 or pix.shape[2] not in (3, 4) or 0 in pix.shape:
        raise ValueError(f"expected (H, W, 3) or (H, W, 4) pixels, not {pix.shape}")
    return pix


def webp_encode(pixels: np.ndarray) -> bytes:
    """A WebP file of (H, W, 3) RGB or (H, W, 4) RGBA uint8, as libwebp's
    lossy encoder writes it at quality 80, method 4. A side over 16383
    raises ``ValueError`` with libwebp's error."""
    pix = _rgb_or_rgba(pixels)
    h, w, c = pix.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = load_webp_enc_library()
    rc = lib.sl_webp_encode(pix.ctypes.data, w, h, c, ctypes.byref(out), ctypes.byref(n), err,
                            _ERRLEN)
    if rc != _OK:
        raise ValueError(err.value.decode("utf-8", "replace"))
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.sl_webp_enc_free(out)


def webp_encode_planes(pixels: np.ndarray, cleanup: bool) -> dict:
    """The encoder's YUV 4:2:0 (and alpha) planes of (H, W, 3|4) uint8:
    libwebp's RGB(A) import, then with ``cleanup`` its clean-up of the fully
    transparent area. Keys y, u, v, and a (None without transparency)."""
    pix = _rgb_or_rgba(pixels)
    h, w, c = pix.shape
    uh, uw = (h + 1) // 2, (w + 1) // 2
    y = np.empty((h, w), np.uint8)
    u = np.empty((uh, uw), np.uint8)
    v = np.empty((uh, uw), np.uint8)
    a = np.empty((h, w), np.uint8)
    has_alpha = ctypes.c_int(0)
    load_webp_enc_library().sl_webp_enc_planes(pix.ctypes.data, w, h, c, int(cleanup),
                                               y.ctypes.data, u.ctypes.data, v.ctypes.data,
                                               a.ctypes.data, ctypes.byref(has_alpha))
    return {"y": y, "u": u, "v": v, "a": a if has_alpha.value else None}
