"""ctypes binding of the port's native image codec core (``csrc/sl_image.cpp``),
of its WebP decoder (``csrc/sl_webp.cpp``), of its WebP encoder
(``csrc/sl_webp_enc.cpp`` with libwebp's lossless encoder for the alpha
plane, ``csrc/sl_vp8l_enc.cpp``; the decoder and the encoder share
``sl_vp8_tables.h``),
of its GIF encoder (``csrc/sl_gif_enc.cpp``), of its core for the plain
formats (``csrc/sl_plain_formats.cpp``: QOI, PCX, SGI, DDS), of its
JPEG 2000 codec (``csrc/sl_j2k.cpp``) and of its AVIF core
(``csrc/sl_av1.cpp``: an AV1 intra decoder, its CDEF and loop restoration
in ``sl_av1_post.h``, and libyuv's RGB conversion; ``csrc/sl_av1_enc.cpp``:
an AV1 still-image encoder and libavif's RGB to YUV; the reconstruction
both share in ``sl_av1_recon.h``, the specification's tables in
``sl_av1_tables.h``).

The serial bit loops of the image formats: JPEG's entropy coding and
sample arithmetic (decode and encode), the LZW decoders of GIF and TIFF,
the run-length decoders of BMP, TGA and TIFF (PackBits), and the whole of
WebP's decode (VP8, VP8L, ALPH, the container and frame 0) and encode
(libwebp's lossy encoder as Pillow's ``save`` drives it), and what
Pillow's GIF ``save`` does below its Python layer (the median-cut and
fast-octree quantisers and GIF's LZW), and the loops of the plain formats
(QOI's encoder and decoder, PCX's run-length coding both ways, SGI's
run-length rows, the BC1-BC7 blocks of DDS), and JPEG 2000's codestream
both ways (OpenJPEG's reversible coder at Pillow's defaults), and AVIF's
AV1 both ways. Each source is
built at first use by ``native_build.build_library`` (``g++ -O3 -shared
-fPIC -std=c++17`` into the gitignored ``_build/``, named by a hash of the
source and its headers); a compile or load that fails raises with the
compiler's message. There is no decoder or encoder in Python beside it.

Each wrapper raises ``NotImplementedError`` for a variant the core does
not decode, ``ValueError`` for a file that is not valid and ``OSError``
for one that ends before its image does (Pillow's "image file is
truncated") or that the libraries refuse (a JPEG that Pillow's open does
not identify, or that libjpeg stops decoding: Pillow's messages).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .image_limits import check_size
from .native_build import BUILD_DIR, CXX_FLAGS, PKG_DIR, build_library

SOURCE = os.path.join(PKG_DIR, "csrc", "sl_image.cpp")
HEADER = os.path.join(PKG_DIR, "csrc", "sl_image.h")
WEBP_SOURCE = os.path.join(PKG_DIR, "csrc", "sl_webp.cpp")
WEBP_TABLES = os.path.join(PKG_DIR, "csrc", "sl_vp8_tables.h")
WEBP_HEADER = (os.path.join(PKG_DIR, "csrc", "sl_webp.h"), WEBP_TABLES)
WEBP_ENC_SOURCE = (os.path.join(PKG_DIR, "csrc", "sl_webp_enc.cpp"),
                   os.path.join(PKG_DIR, "csrc", "sl_vp8l_enc.cpp"))
WEBP_ENC_HEADER = (os.path.join(PKG_DIR, "csrc", "sl_webp_enc.h"),
                   os.path.join(PKG_DIR, "csrc", "sl_vp8l_enc.h"), WEBP_TABLES)
GIF_ENC_SOURCE = os.path.join(PKG_DIR, "csrc", "sl_gif_enc.cpp")
GIF_ENC_HEADER = os.path.join(PKG_DIR, "csrc", "sl_gif_enc.h")
PLAIN_SOURCE = (os.path.join(PKG_DIR, "csrc", "sl_plain_formats.cpp"),
                os.path.join(PKG_DIR, "csrc", "sl_pillow_formats.cpp"),
                os.path.join(PKG_DIR, "csrc", "sl_fax.cpp"),
                os.path.join(PKG_DIR, "csrc", "sl_zstd.cpp"))
PLAIN_HEADER = (os.path.join(PKG_DIR, "csrc", "sl_plain_formats.h"),
                os.path.join(PKG_DIR, "csrc", "sl_pillow_formats.h"),
                os.path.join(PKG_DIR, "csrc", "sl_fax.h"),
                os.path.join(PKG_DIR, "csrc", "sl_zstd.h"))
J2K_SOURCE = os.path.join(PKG_DIR, "csrc", "sl_j2k.cpp")
J2K_HEADER = os.path.join(PKG_DIR, "csrc", "sl_j2k.h")
AVIF_SOURCE = (os.path.join(PKG_DIR, "csrc", "sl_av1.cpp"),
               os.path.join(PKG_DIR, "csrc", "sl_av1_enc.cpp"))
AVIF_HEADER = (os.path.join(PKG_DIR, "csrc", "sl_av1.h"),
               os.path.join(PKG_DIR, "csrc", "sl_av1_enc.h"),
               os.path.join(PKG_DIR, "csrc", "sl_av1_recon.h"),
               os.path.join(PKG_DIR, "csrc", "sl_av1_post.h"),
               os.path.join(PKG_DIR, "csrc", "sl_av1_tables.h"),
               os.path.join(PKG_DIR, "csrc", "sl_av1_tables_hbd.h"))
# -O2: -O3 makes the JPEG 2000 core no faster and takes twice as long to
# compile, and the compile is paid at first use (the AV1 core's too: 11.6 s
# at -O3 against 6.9 s); -ffp-contract=off: the 9/7 wavelet and the ICT are
# OpenJPEG's single-precision arithmetic, and the AV1 core's RGB to YUV
# conversion libavif's, which a fused multiply-add would round differently
J2K_FLAGS = ("-O2",) + CXX_FLAGS[1:] + ("-ffp-contract=off",)
AVIF_FLAGS = J2K_FLAGS

(_OK, _UNSUPPORTED, _CORRUPT, _NO_ROOM, _TRUNCATED, _UNIDENTIFIED, _BROKEN, _TRUNCATED_FAILS,
 _PILLOW_BROKEN) = range(9)
_ERRLEN = 512

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_webp_lib: ctypes.CDLL | None = None
_webp_enc_lib: ctypes.CDLL | None = None
_gif_enc_lib: ctypes.CDLL | None = None
_plain_lib: ctypes.CDLL | None = None
_j2k_lib: ctypes.CDLL | None = None
_avif_lib: ctypes.CDLL | None = None


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


def build_gif_enc() -> str:
    """``build`` of the GIF encoder."""
    return build_library("sl_gif_enc", GIF_ENC_SOURCE, GIF_ENC_HEADER, BUILD_DIR,
                         "the native GIF encoder")


def build_plain() -> str:
    """``build`` of the plain formats' core."""
    return build_library("sl_plain", PLAIN_SOURCE, PLAIN_HEADER, BUILD_DIR,
                         "the native QOI/PCX/SGI/DDS core and the loops of Pillow's "
                         "rarer readers")


def build_j2k() -> str:
    """``build`` of the JPEG 2000 codec."""
    return build_library("sl_j2k", J2K_SOURCE, J2K_HEADER, BUILD_DIR, "the native JPEG 2000 codec",
                         J2K_FLAGS)


def build_avif() -> str:
    """``build`` of the AV1 decoder and encoder and the RGB conversions of
    AVIF."""
    return build_library("sl_av1", AVIF_SOURCE, AVIF_HEADER, BUILD_DIR, "the native AVIF codec",
                         AVIF_FLAGS)


def load_avif_library() -> ctypes.CDLL:
    """Build (if needed) and load the AVIF core, once per process."""
    global _avif_lib
    with _lock:
        if _avif_lib is None:
            lib = ctypes.CDLL(build_avif())
            lib.sl_av1_info.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_char_p, ctypes.c_size_t)
            lib.sl_av1_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_size_t)
            lib.sl_av1_info.restype = lib.sl_av1_decode.restype = ctypes.c_int
            lib.sl_avif_yuv_to_rgba.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 + (
                ctypes.c_void_p,)
            lib.sl_avif_yuv_to_rgba.restype = ctypes.c_int
            lib.sl_avif_yuv16_to_rgba.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9 + (
                ctypes.c_void_p,)
            lib.sl_avif_yuv16_to_rgba.restype = ctypes.c_int
            lib.sl_av1_decode_counts.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                                 ctypes.c_char_p, ctypes.c_size_t)
            lib.sl_av1_decode_counts.restype = ctypes.c_int
            lib.sl_av1_count_names.argtypes = ()
            lib.sl_av1_count_names.restype = ctypes.c_char_p
            lib.sl_av1_wiener.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_void_p)
            lib.sl_av1_wiener.restype = ctypes.c_int
            lib.sl_av1_encode.argtypes = (
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_int)
            lib.sl_av1_encode.restype = ctypes.c_int
            lib.sl_av1_enc_free.argtypes = (ctypes.POINTER(ctypes.c_uint8),)
            lib.sl_av1_enc_free.restype = None
            lib.sl_av1_rgb_to_yuv420.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_void_p)
            lib.sl_av1_rgb_to_yuv420.restype = None
            lib.sl_av1_write_symbols.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                                 ctypes.c_int)
            lib.sl_av1_write_symbols.restype = ctypes.c_int
            lib.sl_av1_read_symbols.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_void_p)
            lib.sl_av1_read_symbols.restype = ctypes.c_int
            _avif_lib = lib
        return _avif_lib


def load_j2k_library() -> ctypes.CDLL:
    """Build (if needed) and load the JPEG 2000 codec, once per process."""
    global _j2k_lib
    with _lock:
        if _j2k_lib is None:
            lib = ctypes.CDLL(build_j2k())
            lib.sl_j2k_encode.argtypes = (
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_int)
            for fn in ("sl_j2k_info", "sl_j2k_decode"):
                getattr(lib, fn).argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_int)
            for fn in ("sl_j2k_encode", "sl_j2k_info", "sl_j2k_decode"):
                getattr(lib, fn).restype = ctypes.c_int
            lib.sl_j2k_free.restype = None
            lib.sl_j2k_free.argtypes = (ctypes.POINTER(ctypes.c_uint8),)
            _j2k_lib = lib
        return _j2k_lib


def load_plain_library() -> ctypes.CDLL:
    """Build (if needed) and load the plain formats' core, once per process."""
    global _plain_lib
    with _lock:
        if _plain_lib is None:
            lib = ctypes.CDLL(build_plain())
            out = (ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
                   ctypes.c_char_p, ctypes.c_int)
            lib.sl_qoi_encode.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int) + out
            lib.sl_pcx_encode.argtypes = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int) + out
            lib.sl_qoi_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_char_p, ctypes.c_int)
            lib.sl_pcx_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int)
            lib.sl_sgi_rle_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t) + (ctypes.c_int,) * 4 + (
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int)
            lib.sl_bcn_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t) + (ctypes.c_int,) * 4 + (
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int)
            lib.sl_sun_rle_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p,
                                              ctypes.POINTER(ctypes.c_size_t))
            lib.sl_msp_rle_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                              ctypes.c_int, ctypes.c_int) + out[:2] + (
                ctypes.POINTER(ctypes.c_int),)
            lib.sl_fli_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int))
            lib.sl_fli_decode.restype = ctypes.c_long
            lib.sl_blp_dxt_decode.argtypes = (ctypes.c_char_p,) + (ctypes.c_int,) * 4 + (
                ctypes.c_void_p,)
            lib.sl_blp_dxt_decode.restype = None
            lib.sl_fax_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t) + (ctypes.c_int,) * 4 + (
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int))
            lib.sl_fax_decode.restype = ctypes.c_int
            lib.sl_zstd_decompress.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                               ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
                                               ctypes.c_char_p, ctypes.c_int)
            lib.sl_zstd_decompress.restype = ctypes.c_int
            for fn in ("sl_qoi_encode", "sl_pcx_encode", "sl_qoi_decode", "sl_pcx_decode",
                       "sl_sgi_rle_decode", "sl_bcn_decode", "sl_sun_rle_decode",
                       "sl_msp_rle_decode"):
                getattr(lib, fn).restype = ctypes.c_int
            lib.sl_plain_free.restype = None
            lib.sl_plain_free.argtypes = (ctypes.POINTER(ctypes.c_uint8),)
            _plain_lib = lib
        return _plain_lib


def load_gif_enc_library() -> ctypes.CDLL:
    """Build (if needed) and load the GIF encoder, once per process."""
    global _gif_enc_lib
    with _lock:
        if _gif_enc_lib is None:
            lib = ctypes.CDLL(build_gif_enc())
            for fn in ("sl_quant_median", "sl_quant_octree"):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = (
                    ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int)
            lib.sl_gif_lzw_encode.restype = ctypes.c_int
            lib.sl_gif_lzw_encode.argtypes = (
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_int)
            lib.sl_gif_enc_free.restype = None
            lib.sl_gif_enc_free.argtypes = (ctypes.POINTER(ctypes.c_uint8),)
            _gif_enc_lib = lib
        return _gif_enc_lib


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
            lib.sl_vp8l_encode_plane.restype = ctypes.c_int
            lib.sl_vp8l_encode_plane.argtypes = (
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)), ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.c_int)
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
            for fn in ("sl_jpeg_info", "sl_jpeg_decode", "sl_jpeg_info_tiff",
                       "sl_jpeg_decode_tiff", "sl_jpeg_encode", "sl_gif_lzw",
                       "sl_tiff_lzw", "sl_bmp_rle", "sl_tga_rle", "sl_packbits"):
                getattr(lib, fn).restype = ctypes.c_int
            lib.sl_cmyk_convert.restype = None
            lib.sl_cmyk_convert.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                                            ctypes.c_void_p)
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
    if rc in (_TRUNCATED, _TRUNCATED_FAILS):
        raise OSError(msg)
    if rc == _UNIDENTIFIED:  # PIL.UnidentifiedImageError's message
        raise OSError(f"cannot identify image file {name!r}")
    if rc in (_BROKEN, _PILLOW_BROKEN):  # ImageFile.load's, where libjpeg stops
        raise OSError("broken data stream when reading image file")
    raise ValueError(msg)


def jpeg_info(data: bytes, name: str = "<bytes>") -> dict:
    """The frame of a JPEG: width, height, components and colour space
    (0 grey, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK)."""
    lib = load_library()
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.sl_jpeg_info(data, ctypes.c_size_t(len(data)), _ptr(info), err, _ERRLEN), err, name)
    keys = ("width", "height", "components", "colour_space")
    return dict(zip(keys, (int(v) for v in info)))


def jpeg_decode(data: bytes, name: str = "<bytes>", cv2: bool = False) -> np.ndarray | None:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) CMYK uint8, as libjpeg
    outputs it (a YCCK file converted to CMYK). A file that ends before its
    EOI raises as Pillow does, unless ``cv2``: then what libjpeg makes of it
    (the missing entropy data left as it is, a flat block per missing MCU),
    as OpenCV reads it. A file the libraries refuse raises ``OSError`` with
    Pillow's message, or with ``cv2`` gives None, as ``cv2.imread`` does.
    The size limits are Pillow's, or with ``cv2`` OpenCV's."""
    try:
        info = jpeg_info(data, name)
    except OSError:
        if cv2:
            return None
        raise
    h, w, c = info["height"], info["width"], info["components"]
    check_size(w, h, name, "JPEG", cv2)
    out = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = load_library().sl_jpeg_decode(data, ctypes.c_size_t(len(data)), _ptr(out), err, _ERRLEN)
    if cv2 and rc in (_UNIDENTIFIED, _BROKEN, _TRUNCATED_FAILS):
        return None
    if not (cv2 and rc in (_TRUNCATED, _PILLOW_BROKEN)):
        _check(rc, err, name)
    return out[..., 0] if c == 1 else out


def jpeg_decode_tiff(data: bytes, ycbcr: bool, components: int,
                     name: str = "<bytes>") -> np.ndarray:
    """(H, W, C) uint8 of one JPEG strip or tile of a TIFF (its tables in
    front) as libtiff's JPEG codec hands it on: YCbCr converted to RGB when
    ``ycbcr``, else the components as stored; ``components`` is what the
    TIFF's samples expect. Raises ``ValueError`` or ``OSError`` where the
    strip does not decode."""
    lib = load_library()
    info = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.sl_jpeg_info_tiff(data, ctypes.c_size_t(len(data)), int(ycbcr), _ptr(info), err,
                                 _ERRLEN), err, name)
    w, h, c = int(info[0]), int(info[1]), int(info[2])
    if c != components:
        raise ValueError(f"{name}: a JPEG strip of {c} components for {components} samples")
    check_size(w, h, name, "JPEG strip")
    out = np.zeros((h, w, c), np.uint8)
    _check(lib.sl_jpeg_decode_tiff(data, ctypes.c_size_t(len(data)), int(ycbcr), _ptr(out), err,
                                   _ERRLEN), err, name)
    return out


def cmyk_convert(cmyk: np.ndarray, opencv: bool) -> np.ndarray:
    """(H, W, 4) CMYK as libjpeg outputs it to Pillow's ``convert("RGBA")``
    (H, W, 4) or, with ``opencv``, to OpenCV's BGR (H, W, 3)."""
    src = np.ascontiguousarray(cmyk, np.uint8)
    out = np.empty(src.shape[:2] + (3 if opencv else 4,), np.uint8)
    load_library().sl_cmyk_convert(_ptr(src), ctypes.c_size_t(src.shape[0] * src.shape[1]),
                                   int(opencv), _ptr(out))
    return out


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


def vp8l_encode_plane(plane: np.ndarray) -> bytes:
    """The VP8L stream libwebp's alpha encoder writes for an (H, W) uint8
    plane (the ALPH chunk's payload after its header byte, before any
    fallback to the raw plane): the plane in the green byte of ARGB pixels,
    method 4, quality 32, exact, no header."""
    p = np.ascontiguousarray(plane, np.uint8)
    if p.ndim != 2 or 0 in p.shape:
        raise ValueError(f"expected an (H, W) plane, not {p.shape}")
    h, w = p.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = load_webp_enc_library()
    rc = lib.sl_vp8l_encode_plane(p.ctypes.data, w, h, ctypes.byref(out), ctypes.byref(n), err,
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


def _quantize(fn: str, pixels: np.ndarray, channels: int, what: str):
    pix = np.ascontiguousarray(pixels, np.uint8)
    if pix.ndim != 3 or pix.shape[2] != channels or 0 in pix.shape:
        raise ValueError(f"expected (H, W, {channels}) pixels, not {pix.shape}")
    palette = np.zeros((256, channels), np.uint8)
    index = np.empty(pix.shape[:2], np.uint8)
    n = ctypes.c_int(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(getattr(load_gif_enc_library(), fn)(
        pix.ctypes.data, pix.shape[0] * pix.shape[1], palette.ctypes.data, ctypes.byref(n),
        index.ctypes.data, err, _ERRLEN), err, what)
    return palette[: n.value], index


def quantize_median(pixels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's median cut to 256 colours (``Image.convert("P",
    palette=ADAPTIVE)``) of (H, W, 3) RGB uint8: the (N, 3) palette, N <=
    256, and the (H, W) uint8 indices."""
    return _quantize("sl_quant_median", pixels, 3, "median cut")


def quantize_octree(pixels: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's fast octree to 256 colours (``Image.quantize(256)`` of
    RGBA, method 2) of (H, W, 4) RGBA uint8: the (256, 4) RGBA palette and
    the (H, W) uint8 indices."""
    return _quantize("sl_quant_octree", pixels, 4, "octree")


def gif_lzw_encode(index: np.ndarray, interlace: bool) -> bytes:
    """GIF's LZW (minimum code size 8) of (H, W) uint8 indices as Pillow's
    encoder writes it: the data sub-blocks, without the code size before
    them or the terminator."""
    idx = np.ascontiguousarray(index, np.uint8)
    h, w = idx.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = load_gif_enc_library()
    _check(lib.sl_gif_lzw_encode(idx.ctypes.data, w, h, int(interlace), ctypes.byref(out),
                                 ctypes.byref(n), err, _ERRLEN), err, "GIF LZW")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.sl_gif_enc_free(out)


def _plain_out(fn: str, what: str, *args) -> bytes:
    """Call an encoder of the plain formats' core that hands back a buffer."""
    lib = load_plain_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(getattr(lib, fn)(*args, ctypes.byref(out), ctypes.byref(n), err, _ERRLEN), err, what)
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.sl_plain_free(out)


def qoi_encode(pixels: np.ndarray) -> bytes:
    """QOI's chunks and end marker of (H, W, 3) RGB or (H, W, 4) RGBA uint8
    as Pillow's encoder writes them (the file without its 14-byte header)."""
    pix = _rgb_or_rgba(pixels)
    h, w, c = pix.shape
    return _plain_out("sl_qoi_encode", "QOI encode", pix.ctypes.data, w, h, c)


def qoi_decode(data: bytes, width: int, height: int, channels: int,
               name: str = "<bytes>") -> np.ndarray:
    """(height, width, channels) uint8 from QOI chunks, as Pillow reads them."""
    out = np.empty((height, width, channels), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_plain_library().sl_qoi_decode(data, ctypes.c_size_t(len(data)), width, height,
                                              channels, _ptr(out), err, _ERRLEN), err, name)
    return out


def pcx_encode(rows: np.ndarray, planes: int) -> bytes:
    """PCX's run-length data of (H, planes x bytes_per_line) uint8 rows,
    each plane's line padded to an even stride, as Pillow writes it."""
    r = np.ascontiguousarray(rows, np.uint8)
    h, line = r.shape
    return _plain_out("sl_pcx_encode", "PCX encode", r.ctypes.data, line // planes, planes, h)


def pcx_decode(data: bytes, row_bytes: int, height: int, name: str = "<bytes>") -> np.ndarray:
    """(height, row_bytes) uint8: PCX's run-length rows before unpacking."""
    out = np.empty((height, row_bytes), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_plain_library().sl_pcx_decode(data, ctypes.c_size_t(len(data)), row_bytes,
                                              height, _ptr(out), err, _ERRLEN), err, name)
    return out


def sgi_rle_decode(data: bytes, xsize: int, ysize: int, zsize: int, bpc: int,
                   name: str = "<bytes>") -> np.ndarray:
    """(ysize, xsize, zsize x bpc) uint8, rows in file order (bottom first),
    of a run-length SGI file (``data`` is the whole file); rows after the
    point where Pillow's decoder stops are zero."""
    out = np.zeros((ysize, xsize, zsize * bpc), np.uint8)
    rows = ctypes.c_int(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_plain_library().sl_sgi_rle_decode(data, ctypes.c_size_t(len(data)), xsize, ysize,
                                                  zsize, bpc, _ptr(out), ctypes.byref(rows), err,
                                                  _ERRLEN), err, name)
    out[rows.value:] = 0
    return out


def bcn_decode(data: bytes, n: int, sign: bool, width: int, height: int,
               name: str = "<bytes>") -> np.ndarray:
    """(height, width, 4) uint8 (BC4: (height, width)) of BCn blocks, cropped
    from the whole blocks as Pillow's decoder writes them."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    out = np.empty((4 * bh, 4 * bw) if n == 4 else (4 * bh, 4 * bw, 4), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_plain_library().sl_bcn_decode(data, ctypes.c_size_t(len(data)), n, int(sign),
                                              width, height, _ptr(out), err, _ERRLEN), err, name)
    return out[:height, :width]


def sun_rle_decode(data: bytes, line_bytes: int, rows: int) -> tuple[np.ndarray, int | None]:
    """(rows, line_bytes) uint8 of Sun raster run-length data as Pillow's
    ``sun_rle`` decoder reads it, and None when every row is decoded, else
    the bytes left over (an incomplete code) where the data ends first."""
    out = np.zeros((rows, line_bytes), np.uint8)
    used = ctypes.c_size_t(0)
    done = load_plain_library().sl_sun_rle_decode(data, ctypes.c_size_t(len(data)), line_bytes,
                                                  rows, _ptr(out), ctypes.byref(used))
    return out, None if done else len(data) - used.value


def msp_rle_decode(data: bytes, rowmap: np.ndarray, blank_bytes: int) -> tuple[bytes, int, int]:
    """MSP v2's rows (``data`` from the first row on, ``rowmap`` their
    encoded lengths) as Pillow's ``MspDecoder`` concatenates them, with 0
    or the failure (1: the data ends in a row, 2: a run passes a row's
    end) and the row at fault."""
    lib = load_plain_library()
    rm = np.ascontiguousarray(rowmap, np.uint16)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    bad = ctypes.c_int(-1)
    rc = lib.sl_msp_rle_decode(data, ctypes.c_size_t(len(data)), _ptr(rm), len(rm), blank_bytes,
                               ctypes.byref(out), ctypes.byref(n), ctypes.byref(bad))
    try:
        if rc == 3:
            raise MemoryError("MSP decode: out of memory")
        return ctypes.string_at(out, n.value), rc, bad.value
    finally:
        lib.sl_plain_free(out)


def fli_decode(data: bytes, frame: np.ndarray) -> tuple[int, int]:
    """One call of Pillow's FLI decoder on ``data`` (from the frame's
    start), decoding into ``frame`` ((height, width) uint8, in place):
    (bytes consumed or -1 when done, Pillow's error code)."""
    err = ctypes.c_int(0)
    h, w = frame.shape
    n = load_plain_library().sl_fli_decode(data, ctypes.c_size_t(len(data)), w, h, _ptr(frame),
                                           ctypes.byref(err))
    return int(n), err.value


def fax_decode(data: bytes, compression: int, width: int, rows: int, t4options: int = 0,
               name: str = "<bytes>") -> bytes:
    """``rows`` packed rows (a black pixel a 1 bit, most significant bit
    first) of one CCITT strip or tile as libtiff decodes it: ``compression``
    2 (modified Huffman), 3 (Group 3, with its ``T4Options``) or 4 (Group
    4); the data is read most significant bit first. Raises ``OSError``
    where libtiff's decode fails."""
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    done = ctypes.c_int(0)
    rc = load_plain_library().sl_fax_decode(data, ctypes.c_size_t(len(data)), compression, width,
                                            rows, t4options, _ptr(out), ctypes.byref(done))
    if rc:
        what = "the data ends" if rc == 1 else "a row's runs overflow"
        raise OSError(f"{name}: CCITT: {what} at row {done.value} of {rows}")
    return out.tobytes()


def zstd_decompress(data: bytes, size: int, name: str = "<bytes>") -> bytes:
    """One ZSTD strip or tile (RFC 8878 frames), up to ``size`` bytes."""
    lib = load_plain_library()
    out = np.zeros(size, np.uint8)
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.sl_zstd_decompress(data, ctypes.c_size_t(len(data)), _ptr(out),
                                  ctypes.c_size_t(size), ctypes.byref(n), err, _ERRLEN), err, name)
    return out[: n.value].tobytes()


def blp_dxt_decode(data: bytes, kind: int, alpha: bool, blocks: int, block_rows: int) -> np.ndarray:
    """BLP's DXT1/3/5 (``kind`` 1, 3, 5) blocks as Pillow's Python decoders
    emit them: (4 x block_rows, 4 x blocks, 3 or 4) uint8."""
    bpp = 3 if kind == 1 and not alpha else 4
    if kind not in (1, 3, 5) or len(data) < blocks * block_rows * (8 if kind == 1 else 16):
        raise ValueError(f"BLP DXT{kind}: {len(data)} bytes for {blocks}x{block_rows} blocks")
    out = np.empty((4 * block_rows, 4 * blocks, bpp), np.uint8)
    load_plain_library().sl_blp_dxt_decode(data, kind, int(alpha), blocks, block_rows, _ptr(out))
    return out


def j2k_encode(samples: np.ndarray) -> bytes:
    """The JPEG 2000 codestream OpenJPEG writes at Pillow's defaults for
    (H, W) or (H, W, C) samples (C 1-4), uint8 or uint16."""
    a = np.ascontiguousarray(samples)
    if a.dtype not in (np.uint8, np.uint16) or a.ndim not in (2, 3) or 0 in a.shape:
        raise ValueError(f"expected (H, W[, C]) uint8 or uint16 samples, not {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    c = 1 if a.ndim == 2 else a.shape[2]
    lib = load_j2k_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.sl_j2k_encode(a.ctypes.data, w, h, c, 8 * a.itemsize, ctypes.byref(out),
                             ctypes.byref(n), err, _ERRLEN), err, "JPEG 2000 encode")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.sl_j2k_free(out)


def j2k_info(codestream: bytes, name: str = "<bytes>") -> dict:
    """The main header of a codestream the decoder reads (it raises
    ``NotImplementedError`` by name for one it does not)."""
    info = np.zeros(9, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_j2k_library().sl_j2k_info(codestream, ctypes.c_size_t(len(codestream)),
                                          _ptr(info), err, _ERRLEN), err, name)
    keys = ("width", "height", "components", "precision", "levels", "mct", "signed", "x0", "y0")
    return dict(zip(keys, (int(v) for v in info)))


def j2k_decode(codestream: bytes, info: dict, name: str = "<bytes>") -> np.ndarray:
    """(H, W, C) uint16 samples of a codestream, each below 2^precision.
    The caller has read ``info`` (``j2k_info``) and checked the size
    (``check_size``)."""
    out = np.zeros((info["height"], info["width"], info["components"]), np.uint16)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_j2k_library().sl_j2k_decode(codestream, ctypes.c_size_t(len(codestream)),
                                            _ptr(out), err, _ERRLEN), err, name)
    return out


def av1_info(obus: bytes, name: str = "<bytes>") -> dict:
    """The frame an AV1 item codes, from its sequence and frame headers: the
    size and colour fields, ``base_q_idx``, the tile counts, the loop
    filter's levels, the bit of ``obus`` that holds ``color_range`` (-1
    where the sequence header does not code it), the quantizer matrices'
    flag and levels, and whether film grain applies. It raises
    ``NotImplementedError`` by name for a stream the decoder does not read."""
    info = np.zeros(22, np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_avif_library().sl_av1_info(obus, len(obus), _ptr(info), err, _ERRLEN), err, name)
    keys = ("width", "height", "monochrome", "bit_depth", "subsampling_x", "subsampling_y",
            "full_range", "matrix", "base_q_idx", "tile_cols", "tile_rows", "filter_level_y0",
            "filter_level_y1", "filter_level_u", "filter_level_v", "filter_sharpness",
            "color_range_bit", "using_qmatrix", "qm_y", "qm_u", "qm_v", "apply_grain")
    return dict(zip(keys, (int(v) for v in info)))


def av1_decode(obus: bytes, info: dict, name: str = "<bytes>"):
    """The planes of an AV1 item: Y (H, W) and, unless it is monochrome, U
    and V (H and W divided by the subsampling, rounded up), uint8 at 8 bits
    and uint16 at 10 and 12, film grain applied where the frame asks for
    it. The caller has read ``info`` (``av1_info``) and checked the size."""
    h, w = info["height"], info["width"]
    sx, sy = info["subsampling_x"], info["subsampling_y"]
    dtype = np.uint8 if info["bit_depth"] == 8 else np.uint16
    y = np.empty((h, w), dtype)
    u = np.empty(((h + sy) >> sy, (w + sx) >> sx), dtype)
    v = np.empty_like(u)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(load_avif_library().sl_av1_decode(obus, len(obus), _ptr(y), _ptr(u), _ptr(v), err,
                                             _ERRLEN), err, name)
    return (y,) if info["monochrome"] else (y, u, v)


def av1_decode_counts(obus: bytes, name: str = "<bytes>") -> dict:
    """What decoding an AV1 item ran, by the names sl_av1_post.h gives the
    counts (``SL_AV1_COUNTS``): each plane's ``FrameRestorationType`` (0
    none, 1 Wiener, 2 self-guided, 3 switchable), ``lr_unit_shift`` (-1
    without loop restoration), the Wiener and self-guided units of each
    plane and a bit for each ``Sgr_Params`` set they used, the 8x8s CDEF
    filtered with a nonzero primary or secondary strength (luma; chroma),
    the 64x64s it left (every block skips its residual), the CfL, lossless
    and chroma palette blocks, a bit for each chroma transform size,
    ``subsampling_x * 2 + subsampling_y``, ``cdef_bits`` (-1 where the
    frame runs no CDEF), and a bit for each transform size a quantizer
    matrix weighed."""
    lib = load_avif_library()
    names = lib.sl_av1_count_names().decode().split(",")[:-1]
    counts = np.zeros(len(names), np.int32)
    err = ctypes.create_string_buffer(_ERRLEN)
    _check(lib.sl_av1_decode_counts(obus, len(obus), _ptr(counts), err, _ERRLEN), err, name)
    return dict(zip(names, (int(v) for v in counts)))


def av1_wiener(plane: np.ndarray, taps) -> np.ndarray:
    """AV1 loop restoration's Wiener filter (7.17.4) over a whole (H, W)
    uint8 plane whose edges repeat: ``taps`` are the vertical filter's three
    outer coefficients, then the horizontal filter's."""
    plane = np.ascontiguousarray(plane, np.uint8)
    t = np.asarray(taps, np.int8)
    out = np.empty_like(plane)
    if load_avif_library().sl_av1_wiener(_ptr(plane), plane.shape[1], plane.shape[0], _ptr(t),
                                         _ptr(out)) != _OK:
        raise ValueError(f"no Wiener filter over a plane of shape {plane.shape}")
    return out


def yuv_to_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray, subsampling: tuple[int, int],
                matrix: int, full_range: bool, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) uint8 RGB with alpha 255 from planes of any subsampling, as
    libavif converts them: libyuv's I420 and I422 with bilinear chroma
    upsampling or I444, with the constants of BT.709 (``matrix`` 1) or
    BT.601 (any other), full or limited range; the identity matrix (0) of a
    full-range 4:4:4 image as G, B, R."""
    h, w = y.shape
    out = np.empty((h, w, 4), np.uint8)
    rc = load_avif_library().sl_avif_yuv_to_rgba(_ptr(y), _ptr(u), _ptr(v), w, h, subsampling[0],
                                                 subsampling[1], matrix, int(full_range), _ptr(out))
    if rc != _OK:
        kind = ("4:4:4", "4:4:0", "4:2:2", "4:2:0")[subsampling[0] * 2 + subsampling[1]]
        rng = "" if full_range else "limited-range "
        raise NotImplementedError(f"{name}: AVIF {rng}identity matrix on {kind} colour is not "
                                  "supported")
    return out


# the kinds of sl_avif_yuv16_to_rgba: libavif's single-precision path to 8
# bits or to the image's depth, libyuv's 10- and 12-bit rows with bilinear
# or nearest chroma
YUV16_FLOAT8, YUV16_FLOAT, YUV16_LIBYUV, YUV16_LIBYUV_NEAREST = range(4)


def yuv16_to_rgba(planes: tuple, depth: int, subsampling: tuple[int, int], matrix: int,
                  full_range: bool, kind: int, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 4) RGBA from planes of ``depth`` bits (one for a monochrome
    item) as libavif converts them (``kind``: ``YUV16_*``): uint16 for
    ``YUV16_FLOAT``, else uint8; alpha at its maximum. The caller keeps the
    identity matrix (``avif._identity``) and 8-bit libyuv rows away."""
    y = np.ascontiguousarray(planes[0], np.uint16)
    mono = len(planes) == 1
    u = y if mono else np.ascontiguousarray(planes[1], np.uint16)
    v = y if mono else np.ascontiguousarray(planes[2], np.uint16)
    h, w = y.shape
    out = np.empty((h, w, 4), np.uint16 if kind == YUV16_FLOAT else np.uint8)
    rc = load_avif_library().sl_avif_yuv16_to_rgba(_ptr(y), _ptr(u), _ptr(v), w, h, depth,
                                                   subsampling[0], subsampling[1], int(mono),
                                                   matrix, int(full_range), kind, _ptr(out))
    if rc != _OK:
        raise ValueError(f"{name}: no conversion of kind {kind} for the identity matrix or "
                         f"{depth}-bit samples")
    return out


def rgb_to_yuv420(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libavif 1.3.0's RGB to YUV 4:2:0 (BT.601, full range) of an (H, W, 3
    or 4) uint8 array, as Pillow's AVIF save runs it: Y (H, W), U and V
    ((H + 1) // 2, (W + 1) // 2)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    load_avif_library().sl_av1_rgb_to_yuv420(_ptr(rgb), w, h, c, _ptr(y), _ptr(u), _ptr(v))
    return y, u, v


def av1_encode(planes: tuple, base_q_idx: int, name: str = "<array>"):
    """The AV1 item (its OBUs) of Y, U, V planes (as ``rgb_to_yuv420``
    gives them) or of one monochrome plane, and the encoder's
    reconstruction of each plane (what a decoder reads from the item)."""
    planes = tuple(np.ascontiguousarray(p, np.uint8) for p in planes)
    h, w = planes[0].shape
    recon = tuple(np.empty_like(p) for p in planes)
    mono = len(planes) == 1
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERRLEN)
    lib = load_avif_library()
    null = ctypes.c_void_p()
    rc = lib.sl_av1_encode(_ptr(planes[0]), null if mono else _ptr(planes[1]),
                           null if mono else _ptr(planes[2]), w, h, int(mono), base_q_idx,
                           _ptr(recon[0]), null if mono else _ptr(recon[1]),
                           null if mono else _ptr(recon[2]), ctypes.byref(out), ctypes.byref(n),
                           err, _ERRLEN)
    _check(rc, err, name)
    try:
        data = ctypes.string_at(out, n.value)
    finally:
        lib.sl_av1_enc_free(out)
    return data, recon


def av1_symbols_round_trip(symbols: np.ndarray, sizes: np.ndarray, offsets: np.ndarray,
                           cdfs: np.ndarray) -> tuple[bytes, np.ndarray, np.ndarray, np.ndarray]:
    """The range encoder's bytes of ``symbols`` (symbol i of ``sizes[i]``
    under the CDF at ``cdfs[offsets[i]:]``, in the decoder's layout; size 0:
    an 8-bit literal), the symbol decoder's reading of those bytes, and the
    CDFs as each side leaves them after adapting."""
    symbols, sizes, offsets = (np.ascontiguousarray(a, np.int32) for a in (symbols, sizes, offsets))
    enc_cdfs, dec_cdfs = np.array(cdfs, np.uint16), np.array(cdfs, np.uint16)
    out = np.zeros(4 * len(symbols) + 64, np.uint8)
    lib = load_avif_library()
    n = lib.sl_av1_write_symbols(_ptr(symbols), _ptr(sizes), _ptr(offsets), len(symbols),
                                 _ptr(enc_cdfs), _ptr(out), len(out))
    back = np.zeros(len(symbols), np.int32)
    rc = lib.sl_av1_read_symbols(_ptr(out), n, _ptr(sizes), _ptr(offsets), len(symbols),
                                 _ptr(dec_cdfs), _ptr(back))
    if n < 0 or rc != _OK:
        raise ValueError("range coder round trip failed")
    return out[:n].tobytes(), back, enc_cdfs, dec_cdfs
