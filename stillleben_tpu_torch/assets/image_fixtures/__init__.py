"""Image files the port's encoders cannot write, and what Pillow reads from them.

Pillow 12.1.0 wrote the files from seeded numpy images
(``tests/torch_image_fixtures.py``; the RLE8 BMP is that module's own
writer, which Pillow reads): a progressive JPEG, an interlaced GIF with a
transparent index, LZW and Deflate TIFF, an RLE8 BMP and a run-length TGA;
and WebP (``WEBP_FILES``): lossy RGB at quality 80, lossy RGBA (ALPH
compressed and filtered), lossless RGBA, lossless with 16 colours (pixel
bundling), an odd-sized lossy image, a two-frame animation whose frame 0
is smaller than its canvas (the container by the tests' ``webp_anim``),
the 640x480 frame the decode is timed on (lossy and lossless), the
textured scene's images (the blob's base colour, the checker plane, the
8-bit sky), and lossy RGBA whose ALPH chunks take libwebp's other paths
(``ALPHA_WEBP_FILES``: a palette of 2 colours, 12 levels, a raw plane, the
horizontal filter); and the encode fixtures (``ENCODE_FILES``): Pillow's ``save``
of ``encode_sources()`` in the modes the JAX ``ImageSaver`` hands Pillow
(GIF of an RGB ramp, of RGB noise with more colours than Pillow's
median-cut hash holds, of RGBA with a binary mask and of 16-bit depth; a
16-bit PGM and a P6); the plain formats' encode fixtures
(``PLAIN_ENCODE_FILES``): Pillow's ``save`` of ``plain_sources()`` as QOI,
SGI, PCX, IM and DDS in each mode the JAX ``ImageSaver`` hands Pillow
that Pillow writes; and their read fixtures (``PLAIN_READ_FILES``), which
Pillow reads but the port does not write: run-length SGI at 1 and 2 bytes
a sample and uncompressed 16-bit SGI, PCX of 1 bit, of 4 bit planes and
with a palette, a two-frame DCX, IM with a palette and of floats, DDS as
Pillow's DXT1/DXT3/DXT5/BC5 and LA writes, and of random BC4, BC5S, BC6H,
BC6HS and BC7 blocks (a 7x5 BC7 among them), with 565 and 4444 masks,
with a palette, and DX10 R8G8B8A8 (the files Pillow does not write are
``tests/torch_image_fixtures.py``'s); and the JPEG variants
(``JPEG_VARIANT_FILES``), which libjpeg-turbo 3.1 wrote (the tests' shim
over Pillow's bundled library; Pillow's ``save`` for Adobe CMYK; the
tests' own writer for a subsampled lossless file and a lossless YCbCr
one): arithmetic coding (sequential, progressive, grey, restarts, a DAC
marker), lossless (SOF3; predictors 1, 4 and 7, a point transform,
restarts), CMYK and YCCK, progressive files cut after a scan (libjpeg's
block smoothing) and inside one, the kinds both libraries refuse (12-bit,
16-bit lossless, hierarchical, lossless arithmetic, lossless YCbCr), the
640x480 frame in six of these variants (``JPEG_VARIANT_FRAMES``, the decode
timed on the card's host) and the textured scene's images as variants
(the blob's base colour arithmetic and CMYK, the checker lossless, the sky
YCCK); and the icon and Photoshop files (``ICON_FILES``): Pillow's ICO with
PNG entries and with BMP entries (RGBA, RGB, grey) and of 16-bit grey, and
the tests' own writers' ICO of 1/4/8/24/32-bit DIB entries with AND masks
(a black-and-white palette among them), entries of one size at several
depths, a palette PNG entry with ``tRNS``, cursors of one and of several
entries, ICNS of run-length planes with masks, of raw planes and of PNG
entries, an unknown ICNS entry, PSD in every mode Pillow reads (bitmap,
grey, indexed with and without a palette, RGB, RGBA, five channels, CMYK,
duotone, multichannel) raw and PackBits, the kinds Pillow refuses (16-bit,
ZIP, two channels as RGB, cut data), and the textured scene's images (the
blob's base colour as a PackBits PSD and as an ICO of BMP entries, the
checker as an ICNS, the sky as a PackBits PSD); ``icon_sources()`` are the
arrays whose saver ICO and ICNS only have digests (``ICON_ENCODE``);
and the JPEG 2000 files: Pillow's ``save`` at its defaults of
``jpeg2000_sources()`` (``JPEG2000_ENCODE_FILES``: both kinds, L, RGB,
RGBA and I;16, and the edge sizes 1x640, 33x33, 65x130, 3x5 and 1x1) and
of the shapes the decoder reads or refuses (``JPEG2000_READ_FILES``: the
colour transform, LA, 32x32 code-blocks, two levels; the 9/7 wavelet,
two layers, precincts, RPCL, tiles, and a code-block style patched into
Pillow's COD, the one refused; ICNS with a JPEG 2000 entry and with a 9/7
one); Pillow's ``save`` at its other settings
(``JPEG2000_SETTINGS_FILES``: the 9/7 wavelet in every mode with and
without the ICT, quality layers in both modes, precincts, the five
progression orders, tiles with offsets, one resolution, PLT markers,
signed samples, the cinema profiles, the edge sizes under 9/7 and under
tiles, an ICNS entry of 9/7 with layers and one of a code-block style, the
refused one; ``JPEG2000_TIMED``: the 640x480 frame three ways;
``JPEG2000_SCENE``: the blob's base colour and the checker plane);
``jpeg2000_saver_sources()`` are the arrays whose JPEG 2000, EPS, PS and
PDF files (the PDF's clock at ``PDF_CLOCK``) only have digests
(``JPEG2000_ENCODE``).
The AVIF files (``AVIF_FILES``, from ``avif_sources()``): Pillow's
``save`` (libavif 1.3.0 over aom 3.12.1) at its defaults of the saver's
modes, of edge sizes and of the 640x480 frame, and at the options that
reach each coefficient CDF set and each tool the port's AV1 decoder
implements, film grain and quantizer matrices among them. The AVIF files of
the decoder's other tools (``AVIF_TOOL_FILES``, from ``avif_tool_sources()``
and ``avif_colr_variants()``): Pillow's ``save`` at speeds 0 to 4 (loop
restoration), with CDEF, in 4:4:4 and 4:2:2, lossless, and files whose
``colr`` box alone is patched to BT.709 or the identity matrix. Their bytes depend
on the writing host's CPU count (Pillow's ``max_threads``): these were
written on a host of 8. The port's own AVIF files, as its ``ImageSaver``
writes them, have digests only (``AVIF_ENCODE``, of
``avif_write_sources()``): they are the same on every host.
``digests.py`` holds the SHA-256 of each encode
fixture's bytes (and of each RGBA WebP file's: ``ALPHA_WEBP_FILE``; of each
JPEG variant's: ``JPEG_VARIANT_FILE``) and of Pillow's
``convert("RGBA")`` of each, of OpenCV's ``imread`` of each WebP and each
JPEG variant (or how each library refuses it), and of
Pillow's JPEG ``save`` (and its decode) of ``seeded_images()``: a host
that decodes and encodes these to the same digests computes what Pillow
and OpenCV compute here.
"""

from __future__ import annotations

import os
import struct

import numpy as np

DIR = os.path.dirname(os.path.abspath(__file__))
FILES = ("progressive.jpg", "interlaced.gif", "lzw.tif", "deflate.tif", "rle8.bmp", "rle.tga")
ALPHA_WEBP_FILES = ("alpha_mask.webp", "alpha_levels.webp", "alpha_noise.webp",
                    "alpha_hfilter.webp")
WEBP_FILES = ("q80.webp", "alpha.webp", "lossless.webp", "palette16.webp", "odd.webp",
              "anim.webp", "frame.webp", "frame_lossless.webp", "blob_basecolor.webp",
              "checker.webp", "sky.webp") + ALPHA_WEBP_FILES
ENCODE_FILES = ("ramp.gif", "noise.gif", "rgba.gif", "depth16.gif", "depth16.pgm", "frame.ppm")
PLAIN_ENCODE_FILES = ("frame.qoi", "frame_rgba.qoi", "frame.sgi", "frame_rgba.rgba", "grey.bw",
                      "frame.pcx", "grey.pcx", "frame.im", "frame_rgba.im", "grey.im",
                      "depth16.im", "frame.dds", "frame_rgba.dds", "grey.dds")
PLAIN_READ_FILES = ("rle8.sgi", "rle16.sgi", "raw16.sgi", "bits1.pcx", "planes4.pcx",
                    "palette.pcx", "frames.dcx", "palette.im", "float.im", "dxt1.dds", "dxt3.dds",
                    "dxt5.dds", "bc5.dds", "la.dds", "bc4.dds", "bc5s.dds", "bc6h.dds",
                    "bc6hs.dds", "bc7.dds", "bc7_odd.dds", "rgb565.dds", "argb4444.dds",
                    "p8.dds", "rgba8.dds")
JPEG_VARIANT_FRAMES = ("frame_arith.jpg", "frame_arith_prog.jpg", "frame_lossless.jpg",
                       "frame_cmyk.jpg", "frame_ycck.jpg", "frame_smoothed.jpg")
JPEG_VARIANT_FILES = ("arith.jpg", "arith_prog.jpg", "arith_grey.jpg", "lossless.jpg",
                      "lossless_grey.jpg", "lossless_sub.jpg", "cmyk.jpg", "cmyk_prog.jpg",
                      "ycck.jpg", "ycck_arith.jpg", "smoothed.jpg", "smoothed_arith.jpg",
                      "truncated_prog.jpg", "bits12.jpg", "lossless16.jpg", "hierarchical.jpg",
                      "lossless_arith.jpg", "lossless_ycc.jpg") + JPEG_VARIANT_FRAMES + (
                      "blob_arith.jpg", "blob_cmyk.jpg", "checker_lossless.jpg", "sky_ycck.jpg")


ICON_FILES = ("pillow_rgba.ico", "pillow_bmp_rgba.ico", "pillow_bmp_rgb.ico",
              "pillow_bmp_grey.ico", "pillow_depth16.ico", "dib1.ico", "dib1_bw.ico", "dib4.ico",
              "dib8.ico", "dib24.ico", "dib32.ico", "depths.ico", "png_trns.ico", "cursor.cur",
              "cursors.cur", "cursor8.cur", "rle.icns", "rle48.icns", "raw.icns", "png.icns",
              "png_grey.icns", "unknown.icns", "checker.icns", "bitmap.psd", "bitmap_rle.psd",
              "grey_rle.psd", "indexed.psd", "indexed_rle.psd", "indexed_nopalette.psd",
              "rgb.psd", "rgb_rle.psd", "rgba.psd", "rgba_rle.psd", "rgb5_rle.psd", "cmyk.psd",
              "cmyk_rle.psd", "cmyk5_rle.psd", "duotone.psd", "multichannel_rle.psd",
              "grey16.psd", "zip.psd", "two_channels.psd", "truncated.psd",
              "truncated_rle.psd", "blob_packbits.psd", "sky_packbits.psd", "blob_bmp.ico")

JPEG2000_ENCODE_FILES = ("frame.jp2", "frame.j2k", "frame_rgba.jp2", "frame_rgba.j2k", "grey.jp2",
                         "grey.j2k", "depth16.jp2", "depth16.j2k", "row_1x640.j2k",
                         "square_33x33.jp2", "odd_65x130.j2k", "tiny_3x5.jp2", "one_1x1.j2k")
JPEG2000_READ_FILES = ("rct.jp2", "rct_rgba.j2k", "la.jp2", "la.j2k", "cblk32.j2k", "levels2.jp2",
                       "irreversible.j2k", "layers.jp2", "precincts.j2k", "rpcl.j2k", "tiles.j2k",
                       "cblk_style.j2k", "j2k_entry.icns", "j2k_97.icns")
# Pillow's files at its other settings; the 640x480 ones are phase 25's
# timings (``JPEG2000_TIMED``), the last two its scene's textures
# (``JPEG2000_SCENE``: the blob's base colour, the plane)
JPEG2000_TIMED = {"9/7 + ICT": "frame_ict.j2k", "three layers": "frame_layers.jp2",
                  "tiles + precincts + PCRL": "frame_tiles.j2k"}
JPEG2000_SCENE = ("blob_basecolor_97.jp2", "checker_tiles.j2k")
JPEG2000_SETTINGS_FILES = (
    "i97_l.j2k", "i97_rgb.jp2", "i97_la.jp2", "i97_rgba.j2k", "i97_i16.j2k", "i97_i16.jp2",
    "ict_rgb.j2k", "ict_rgba.jp2", "ict_la.j2k",
    "layers_rates.j2k", "layers_db.jp2", "layers_97.j2k", "layers_db_97.j2k",
    "prec16.j2k", "prec32.j2k", "prec64.jp2", "prec16_97.j2k", "prec32_97.j2k", "prec64_97.jp2",
    "order_lrcp.j2k", "order_rlcp.j2k", "order_rpcl.j2k", "order_pcrl.j2k", "order_cprl.j2k",
    "order_rpcl_97.jp2", "order_cprl_97.j2k",
    "tiles_col1.j2k", "tiles_row1.jp2", "tiles_odd_97.j2k", "tiles_rgba.jp2", "offset.j2k",
    "res1.j2k", "res1_97.jp2", "plt.j2k", "plt_97.jp2",
    "signed_l.j2k", "signed_rgb.jp2", "signed_i16.j2k", "signed_97.j2k",
    "cinema2k24.j2k", "cinema2k48.j2k", "cinema4k24.j2k", "cinema4k24_48x64.j2k",
    "i97_1x1.j2k", "i97_1x640.j2k", "i97_3x5.jp2", "i97_33x33.j2k", "i97_65x130.j2k",
    "tiled_1x1.j2k", "tiled_1x640.j2k", "tiled_3x5.j2k", "tiled_33x33.jp2", "tiled_65x130.j2k",
    "j2k_layers.icns", "j2k_style.icns") + tuple(JPEG2000_TIMED.values()) + JPEG2000_SCENE
# what the port names in refusing each refused JPEG 2000 fixture
JPEG2000_REFUSALS = {"cblk_style.j2k": "code-block style", "j2k_style.icns": "code-block style"}
# the clock of the PDF digests (``time.gmtime(PDF_CLOCK)`` for both dates)
PDF_CLOCK = 1700000000
# the AVIF fixtures (``avif_sources()``), read as Pillow and OpenCV read them
AVIF_FILES = ("frame.avif", "frame_rgba.avif", "grey.avif", "depth16.avif", "one_1x1.avif",
              "two_2x2.avif", "tiny_3x5.avif", "row_1x640.avif", "col_640x1.avif",
              "square_33x33.avif", "odd_65x130.avif", "flat_65x130.avif", "few_480x640.avif",
              "frame640.avif", "frame640_rgba.avif", "q94.avif", "q85.avif", "q30.avif",
              "sb128.avif", "chroma_dq.avif", "delta_q_lf.avif", "reduced_tx_set.avif",
              "tiles.avif", "tools_smooth.avif",
              "tools_smooth_q40.avif", "tools_noise.avif", "tools_few.avif", "rot.avif",
              "mirror.avif", "lossless.avif", "yuv444.avif", "yuv422.avif", "cdef.avif",
              "restoration.avif", "film_grain.avif", "qm.avif", "prem.avif", "limited.avif",
              "anim.avifs", "blob_basecolor.avif", "checker.avif")
# the AVIF fixtures of the decoder's loop restoration, CDEF, 4:4:4 and 4:2:2
# colour, lossless frames and matrices (``avif_tool_sources()``, then
# ``avif_colr_variants()``), read as Pillow and OpenCV read them; the
# 640x480 ones are phase 26's timings (``AVIF_TIMED``)
AVIF_TOOL_FILES = (
    "lr_speed0.avif", "lr_speed1.avif", "lr_speed2.avif", "lr_speed3.avif", "lr_speed4.avif",
    "lr_sb128.avif", "lr_unit64.avif", "lr_tiles.avif", "lr_rgba.avif", "lr_1x1.avif",
    "lr_3x5.avif",
    "lr_65x130.avif", "lr_130x65.avif", "lr_77x201.avif", "lr_640.avif",
    "cdef_q30.avif", "cdef_sb128.avif", "cdef_few.avif", "cdef_rgba.avif", "cdef_3x5.avif",
    "cdef_65x130.avif", "cdef_wiener.avif", "cdef_sgrproj.avif", "cdef_640.avif",
    "yuv444_s6_q30.avif", "yuv444_s4_q60_rgba.avif", "yuv444_s4_q94.avif",
    "yuv444_s6_q85_rgba.avif", "yuv444_few.avif", "yuv444_65x130.avif", "yuv444_640.avif",
    "yuv422_s6_q30.avif", "yuv422_s4_q60_rgba.avif", "yuv422_s4_q94.avif",
    "yuv422_s6_q85_rgba.avif", "yuv422_few.avif", "yuv422_65x130.avif",
    "lossless_422.avif", "lossless_444.avif", "lossless_444_rgba.avif", "lossless_444_640.avif",
    "blob_basecolor_444_s4.avif", "checker_cdef.avif",
    "bt709_full.avif", "bt709_limited.avif", "identity_444.avif", "identity_444_rgba.avif",
    "alpha_limited.avif")
# Pillow's rarer formats (``tests/torch_image_fixtures.py``'s
# ``make_pillow_format_fixtures``): Pillow's BLP, XBM and MSP files, OpenCV's
# Sun rasters, the scene's images (``PILLOW_FORMAT_SCENE``) and the files of
# ``rare_formats.pillow_format_files()``, which the card's host remakes
PILLOW_FORMAT_SAVED = ("blp1_palette.blp", "blp1_palette_rgba.blp", "blp2_palette.blp",
                       "blp2_palette_rgba.blp", "frame.xbm", "frame.msp", "cv2_grey.ras",
                       "cv2_bgr.ras")
PILLOW_FORMAT_SCENE = ("blob_basecolor_dxt5.blp", "checker_rle.ras")
PILLOW_FORMAT_WRITTEN = (
    "bits1.ras", "palette4.ras", "grey8.ras", "palette8.ras", "bgr24.ras", "rgb24_type3.ras",
    "xbgr32.ras", "rle8.ras", "rle24.ras", "dxt1.blp", "dxt1_alpha.blp", "dxt3.blp", "dxt5.blp",
    "bgra.blp", "dxt1.ftc", "rgb.ftu", "lins.msp", "palette.xpm", "rgb.xpm", "brush_v1.gbr",
    "brush_rgba.gbr", "int8.fits", "int16.fits", "int32.fits", "float32.fits", "float64.fits",
    "gzip.fits", "brun.flc", "copy.fli", "lc.fli", "ss2.flc", "float_be.spi", "float_le.spi",
    "area1.mcidas", "area2.mcidas", "area4.mcidas", "frame.pxr", "frame.imt", "thumb.xv",
    "raw.iim", "band.iim")
PILLOW_FORMAT_FILES = PILLOW_FORMAT_SAVED + PILLOW_FORMAT_SCENE + PILLOW_FORMAT_WRITTEN
# the fixtures Pillow refuses, and the exception the port raises as Pillow does
PILLOW_FORMAT_REFUSALS = {"bgra.blp": NotImplementedError}
AVIF_TIMED = {"speed 4": "lr_640.avif", "CDEF": "cdef_640.avif", "4:4:4": "yuv444_640.avif",
              "lossless 4:4:4": "lossless_444_640.avif"}
# the AVIF files of OpenCV's writer and of what the decoder reads beyond
# Pillow's 8-bit colour (``avif_cv2_sources()``, then ``avif_cv2_variants()``):
# OpenCV 5.0.0's ``imwrite`` at its defaults (quantizer matrices) of BGR,
# grey and BGRA at 8, 10 and 12 bits, at two more qualities and lossless
# (the identity matrix at 10 and 12 bits); Pillow's
# 4:0:0 colour (with and without alpha); the quantizer matrices at every
# level 0-14 (Pillow's ``qm-min`` = ``qm-max``) and the contents that weigh
# every transform size; film grain at 8, 10 and 12 bits in each
# subsampling (OpenCV's libavif 1.4.2 over aom, ``film-grain-test`` 1-16);
# files whose ``colr`` box says limited range or BT.709; the 640x480 ones
# timed on the card (``AVIF_CV2_TIMED``); and the scene's (``AVIF_CV2_SCENE``:
# the blob's base colour and the plane as OpenCV writes them, a 10-bit
# panorama for the light map and a 12-bit one)
AVIF_CV2_TIMED = {"OpenCV BGR": "cv2_frame640.avif", "OpenCV grey": "cv2_grey640.avif",
                  "10-bit": "cv2_frame640_10.avif", "12-bit": "cv2_frame640_12.avif",
                  "film grain": "film_grain640.avif"}
AVIF_CV2_SCENE = ("cv2_blob_basecolor.avif", "cv2_checker_grey.avif", "cv2_sky10.avif")
QM_LEVEL_FILES = tuple(f"qm_level{level}.avif" for level in range(15))
AVIF_CV2_FILES = (
    "cv2_bgr.avif", "cv2_grey.avif", "cv2_bgra.avif", "cv2_bgr10.avif", "cv2_grey10.avif",
    "cv2_bgra10.avif", "cv2_bgr12.avif", "cv2_grey12.avif", "cv2_bgra12.avif",
    "cv2_bgr_q30.avif", "cv2_bgr_q90.avif", "cv2_bgr10_q60.avif", "cv2_bgr10_lossless.avif",
    "cv2_bgra12_lossless.avif", "yuv400.avif",
    "yuv400_rgba.avif") + QM_LEVEL_FILES + (
    "qm_mix.avif", "qm_bands.avif", "grain8_422.avif", "grain10_420.avif", "grain10_444.avif",
    "grain10_400.avif", "grain12_420.avif", "grain12_422.avif", "cv2_grey_limited.avif",
    "cv2_grey10_limited.avif", "cv2_bgr10_limited.avif", "cv2_bgra10_bt709.avif",
    "cv2_bgr12_bt709_limited.avif", "cv2_sky12.avif") + AVIF_CV2_SCENE + tuple(
    AVIF_CV2_TIMED.values())


# the TIFF slice: Pillow's and OpenCV's files (``torch_image_fixtures.py
# --tiff``), among them ``tiff_files.tiff_fixtures()``'s (``TIFF_WRITTEN``),
# the scene's textures, the light map's float32 panorama and the 640x480
# timed files; and OpenCV's 16-bit and broken JPEG 2000 files
TIFF_WRITTEN = ("whiteiszero8.tif", "whiteiszero16.tif", "planar_rgb.tif",
                "planar_rgba_tiles.tif", "bigtiff_le.tif", "bigtiff_be.tif", "pred3_float.tif",
                "pred3_float_be.tif", "int32_be.tif")
TIFF_SCENE = ("blob_basecolor_jpeg.tif", "checker_g4.tif")
TIFF_SKY = "sky_float.tif"
TIFF_TIMED = {"JPEG": "timed_jpeg.tif", "Group 4": "timed_g4.tif", "LZMA": "timed_lzma.tif",
              "ZSTD": "timed_zstd.tif", "CMYK LZW": "timed_cmyk_lzw.tif"}
TIFF_FILES = ("jpeg_rgb.tif", "jpeg_l.tif", "jpeg_ycbcr.tif", "jpeg_cmyk.tif", "g4.tif", "g3.tif",
              "g3_2d_fill2.tif", "ccitt_rle.tif", "lzma_rgb.tif", "zstd_rgb.tif", "cmyk.tif",
              "cmyk_lzw.tif", "ycbcr.tif", "lab.tif", "mode_f.tif", "mode_i.tif",
              "bigtiff_rgb.tif", "jpeg_tiles_ycbcr.tif", "cv2_float_rgb.tif",
              "cv2_float_rgb_pred3.tif", "cv2_float_rgba.tif", "cv2_int32.tif",
              "cv2_rgb16.jp2", "cv2_rgba16.jp2", "cv2_broken.jp2") + TIFF_WRITTEN + TIFF_SCENE + (
    TIFF_SKY,) + tuple(TIFF_TIMED.values())


def path(name: str) -> str:
    return os.path.join(DIR, name)


def seeded_images(seed: int = 0) -> dict[str, np.ndarray]:
    """uint8 RGB: ``texture``, the bench's 256x256 blob base colour, and
    ``frame``, a 640x480 image (the 8-bit sky with seeded noise)."""
    from ..procedural import base_color_texture, sky_ldr

    rng = np.random.default_rng(seed)
    frame = sky_ldr(480, 640).astype(np.int16) + rng.integers(-24, 25, (480, 640, 3))
    return {"texture": base_color_texture(seed)[..., :3].copy(),
            "frame": np.clip(frame, 0, 255).astype(np.uint8)}


def encode_sources(seed: int = 15) -> dict[str, np.ndarray]:
    """The arrays behind ``ENCODE_FILES``, by file name: a 640x480 RGB ramp
    (R across, G down, B diagonal), 320x240 RGB noise, a 160x120 cut of
    ``seeded_images()``'s frame with alpha 255 on a disc and 0 elsewhere,
    160x120 uint16 depth from 0 to about 1000 (as a GIF clipped at 255 by
    Pillow), the same depth as a PGM, and a 64x48 cut of the frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:480, 0:640]
    ramp = np.stack([xx * 255 // 639, yy * 255 // 479, (xx + yy) % 256], -1).astype(np.uint8)
    frame = seeded_images()["frame"]
    y, x = np.mgrid[0:120, 0:160]
    disc = ((y - 60) ** 2 + (x - 70) ** 2 < 45 ** 2).astype(np.uint8) * 255
    depth = (y * 6 + x * 2 + rng.integers(0, 40, (120, 160))).astype(np.uint16)
    return {
        "ramp.gif": ramp,
        "noise.gif": rng.integers(0, 256, (240, 320, 3)).astype(np.uint8),
        "rgba.gif": np.concatenate([frame[:120, :160], disc[..., None]], -1),
        "depth16.gif": depth,
        "depth16.pgm": depth,
        "frame.ppm": np.ascontiguousarray(frame[:48, :64]),
    }


def plain_sources(seed: int = 16) -> dict[str, np.ndarray]:
    """The arrays behind ``PLAIN_ENCODE_FILES``, by file name (SGI and IM
    write the base name into the file): the 64x48 cut of
    ``seeded_images()``'s frame, the same with alpha 255 on a disc, 0 around
    it and a ramp in one corner, a grey ramp with runs of 5 across its
    whole range, and 64x48 uint16 depth."""
    rng = np.random.default_rng(seed)
    frame = np.ascontiguousarray(seeded_images()["frame"][:48, :64])
    y, x = np.mgrid[0:48, 0:64]
    alpha = np.where((y - 24) ** 2 + (x - 30) ** 2 < 18 ** 2, 255, 0)
    alpha = np.where((y < 8) & (x > 48), x * 12 - 500 + y, alpha).clip(0, 255).astype(np.uint8)
    rgba = np.concatenate([frame, alpha[..., None]], -1)
    grey = ((x // 5) * 23 + y * 3) % 256
    depth = (y * 900 + x * 40 + rng.integers(0, 300, (48, 64))).astype(np.uint16)
    return {"frame.qoi": frame, "frame_rgba.qoi": rgba, "frame.sgi": frame,
            "frame_rgba.rgba": rgba, "grey.bw": grey.astype(np.uint8), "frame.pcx": frame,
            "grey.pcx": grey.astype(np.uint8), "frame.im": frame, "frame_rgba.im": rgba,
            "grey.im": grey.astype(np.uint8), "depth16.im": depth, "frame.dds": frame,
            "frame_rgba.dds": rgba, "grey.dds": grey.astype(np.uint8)}


def icon_sources() -> dict[str, np.ndarray]:
    """The arrays whose ICO and ICNS the saver's digests (``ICON_ENCODE``)
    hold, by file name: ``plain_sources()``'s 64x48 frame, its RGBA, the
    grey ramp and the 16-bit depth, each as ICO; the RGBA as ICNS (with its
    1024^2 entry, so only the digests are kept)."""
    src = plain_sources()
    out = {"frame.ico": src["frame.qoi"], "frame_rgba.ico": src["frame_rgba.qoi"],
           "grey.ico": src["grey.bw"], "depth16.ico": src["depth16.im"]}
    out["frame_rgba.icns"] = src["frame_rgba.qoi"]
    return out


def jpeg2000_sources() -> dict[str, np.ndarray]:
    """The arrays behind ``JPEG2000_ENCODE_FILES``, by file name:
    ``plain_sources()``'s 64x48 frame, its RGBA, the grey ramp and the
    16-bit depth, each as JP2 and as a bare codestream; a 1x640 grey ramp,
    33x33 RGBA noise, a 65x130 smooth RGB (code-blocks clipped at the
    subbands' edges), 3x5 uint16 noise and one grey pixel."""
    src = plain_sources()
    rng = np.random.default_rng(20)
    out = {}
    for stem, key in (("frame", "frame.qoi"), ("frame_rgba", "frame_rgba.qoi"),
                      ("grey", "grey.bw"), ("depth16", "depth16.im")):
        out[stem + ".jp2"] = out[stem + ".j2k"] = src[key]
    y, x = np.mgrid[0:65, 0:130]
    out["row_1x640.j2k"] = (np.arange(640) * 255 // 639).astype(np.uint8)[None]
    out["square_33x33.jp2"] = rng.integers(0, 256, (33, 33, 4)).astype(np.uint8)
    out["odd_65x130.j2k"] = np.stack([x * 2 % 256, y * 3, (x + y) % 256], -1).astype(np.uint8)
    out["tiny_3x5.jp2"] = rng.integers(0, 65536, (3, 5)).astype(np.uint16)
    out["one_1x1.j2k"] = np.full((1, 1), 77, np.uint8)
    return out


def jpeg2000_saver_sources() -> dict[str, np.ndarray]:
    """The arrays whose JPEG 2000, EPS, PS and PDF files the digests
    (``JPEG2000_ENCODE``) hold, by file name: ``seeded_images()``'s 640x480
    frame as JP2 and codestream, with alpha 255 on a disc as JP2, 640x480
    uint16 depth from 0 to about 3500 as codestream; the 64x48 frame and
    grey ramp as EPS, PS and PDF, and the RGBA as PDF."""
    src = plain_sources()
    frame = seeded_images()["frame"]
    y, x = np.mgrid[0:480, 0:640]
    disc = ((y - 240) ** 2 + (x - 300) ** 2 < 150 ** 2).astype(np.uint8) * 255
    depth = (y * 5 + x * 2 + np.random.default_rng(21).integers(0, 60, (480, 640)))
    return {"frame640.jp2": frame, "frame640.j2k": frame,
            "frame640_rgba.jp2": np.concatenate([frame, disc[..., None]], -1),
            "depth640.j2k": depth.astype(np.uint16),
            "frame.eps": src["frame.qoi"], "grey.ps": src["grey.bw"],
            "frame.pdf": src["frame.qoi"], "grey.pdf": src["grey.bw"],
            "frame_rgba.pdf": src["frame_rgba.qoi"]}


def _waves(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Seeded uint8 (h, w, c): low-frequency waves and a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = [128 + 80 * np.sin(a * x + p * 7) + 40 * np.cos(b * y + k) + rng.normal(0, 3, (h, w))
           for k, (a, b, p) in enumerate(rng.uniform(0.02, 0.15, (c, 3)))]
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def _few_colours(h: int, w: int, seed: int, n: int = 4, cell: int = 4) -> np.ndarray:
    """Seeded uint8 (h, w, 3): ``n`` colours in cells of ``cell`` pixels
    (what sends aom to its screen-content tools: palette, intra block copy)."""
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3))
    idx = rng.integers(0, n, (h // cell + 1, w // cell + 1)).repeat(cell, 0).repeat(cell, 1)
    return pal[idx[:h, :w]].astype(np.uint8)


def orientation_exif(orientation: int) -> bytes:
    """Pillow's ``Exif.tobytes()`` of one Orientation tag (big-endian TIFF,
    one IFD entry of type SHORT), without Pillow."""
    return b"Exif\0\0MM\0*" + struct.pack(">IHHHIHHI", 8, 1, 0x0112, 3, 1, orientation, 0, 0)


def avif_sources() -> dict[str, tuple[np.ndarray, dict]]:
    """The arrays and the ``save`` options of the AVIF fixtures
    (``AVIF_FILES``; Pillow's defaults where the options are empty), by
    file name: ``plain_sources()``'s 64x48 frame, its RGBA, the grey ramp
    and the 16-bit depth (the modes the JAX ``ImageSaver`` hands Pillow);
    sizes 1x1 to 480x640 (H x W) with constant, random, smooth and
    few-colour content; ``seeded_images()``'s 640x480 frame, and with alpha
    on a disc; a smooth 64x48 at qualities 94, 85 and 30 (with the default
    75, ``base_q_idx`` in each of the four coefficient CDF sets); 128x128
    superblocks, chroma delta q, delta q and delta lf per superblock (aom's
    variance boost), the reduced transform set, 2x2 tiles; ``speed`` 1 and
    3 with CDEF and
    loop restoration off (``tools_*``: filter intra, the 4-way and 3-way
    partitions, 64-point transforms); EXIF orientations Pillow stores as
    ``irot`` and ``imir``; lossless, 4:4:4, 4:2:2, CDEF, loop restoration
    (``speed`` 4), film grain, quantizer matrices, premultiplied alpha,
    limited range; and the textured scene's
    images (the blob's base colour and the checker, ``write_avif_fixtures``).
    ``anim.avifs`` (three frames, ``save_all``) is not here:
    ``make_avif_fixtures`` writes it."""
    from ..procedural import base_color_texture, checker_texture

    src = plain_sources()
    frame = seeded_images()["frame"]
    rng = np.random.default_rng(40)
    y, x = np.mgrid[0:480, 0:640]
    disc = ((y - 240) ** 2 + (x - 300) ** 2 < 150 ** 2).astype(np.uint8) * 255
    small = _waves(48, 64, 3, 41)
    off = {"enable-restoration": "0", "enable-cdef": "0"}
    return {
        "frame.avif": (src["frame.qoi"], {}), "frame_rgba.avif": (src["frame_rgba.qoi"], {}),
        "grey.avif": (src["grey.bw"], {}), "depth16.avif": (src["depth16.im"], {}),
        "one_1x1.avif": (np.full((1, 1, 3), (200, 40, 90), np.uint8), {}),
        "two_2x2.avif": (rng.integers(0, 256, (2, 2, 3)).astype(np.uint8), {}),
        "tiny_3x5.avif": (rng.integers(0, 256, (3, 5, 4)).astype(np.uint8), {}),
        "row_1x640.avif": (_waves(1, 640, 3, 42), {}),
        "col_640x1.avif": (_few_colours(640, 1, 43, cell=16), {}),
        "square_33x33.avif": (rng.integers(0, 256, (33, 33, 3)).astype(np.uint8), {}),
        "odd_65x130.avif": (_waves(65, 130, 4, 44), {}),
        "flat_65x130.avif": (np.full((65, 130, 3), (30, 160, 220), np.uint8), {}),
        "few_480x640.avif": (_few_colours(480, 640, 45, n=5, cell=8), {}),
        "frame640.avif": (frame, {}),
        "frame640_rgba.avif": (np.concatenate([frame, disc[..., None]], -1), {}),
        "q94.avif": (small, {"quality": 94}), "q85.avif": (small, {"quality": 85}),
        "q30.avif": (small, {"quality": 30}),
        "sb128.avif": (_waves(130, 100, 3, 46), {"advanced": {"sb-size": "128"}}),
        "chroma_dq.avif": (small, {"advanced": {"enable-chroma-deltaq": "1"}}),
        "delta_q_lf.avif": (_waves(256, 256, 3, 7), {"advanced": {"deltaq-mode": "6",
                                                                  "delta-lf-mode": "1"}}),
        "reduced_tx_set.avif": (_waves(100, 130, 3, 51),
                                {"advanced": {"reduced-tx-type-set": "1"}}),
        "tiles.avif": (_waves(100, 130, 3, 47), {"tile_rows": 1, "tile_cols": 1}),
        "tools_smooth.avif": (_waves(160, 200, 3, 48), {"quality": 90, "speed": 1, "advanced": off}),
        "tools_smooth_q40.avif": (_waves(160, 200, 3, 48), {"quality": 40, "speed": 3,
                                                              "advanced": off}),
        "tools_noise.avif": (rng.integers(0, 256, (160, 200, 3)).astype(np.uint8),
                             {"quality": 40, "speed": 1, "advanced": off}),
        "tools_few.avif": (_few_colours(160, 200, 49, n=3), {"speed": 1, "advanced": off}),
        "rot.avif": (small, {"exif": orientation_exif(6)}),
        "mirror.avif": (small, {"exif": orientation_exif(2)}),
        "lossless.avif": (small, {"quality": 100}),
        "yuv444.avif": (small, {"subsampling": "4:4:4"}),
        "yuv422.avif": (small, {"subsampling": "4:2:2"}),
        "cdef.avif": (small, {"advanced": {"enable-cdef": "1"}}),
        "restoration.avif": (small, {"speed": 4}),
        "film_grain.avif": (small, {"advanced": {"film-grain-test": "1"}}),
        "qm.avif": (small, {"advanced": {"enable-qm": "1"}}),
        "prem.avif": (src["frame_rgba.qoi"], {"alpha_premultiplied": True}),
        "limited.avif": (small, {"range": "limited"}),
        "blob_basecolor.avif": (np.ascontiguousarray(base_color_texture(0)[..., :3]), {}),
        "checker.avif": (np.ascontiguousarray(checker_texture()[..., :3]), {}),
    }


def avif_tool_sources() -> dict[str, tuple[np.ndarray, dict]]:
    """The arrays and the ``save`` options of ``AVIF_TOOL_FILES`` but the
    patched ones (``avif_colr_variants()``), by file name. Loop restoration:
    ``speed`` 0 to 4 on contents and qualities where aom picks the Wiener
    filter, the self-guided filter and both (switchable) and the unit sizes
    128 and 256, and 64 with 64x64 superblocks; with 128x128 superblocks,
    2x2 tiles (each tile restarts the coefficients' references), an alpha
    item that restores too, and sizes 65x130, 130x65 and 77x201 (units and
    stripes cut by the frame's edges; aom restores nothing at 1x1 and 3x5,
    which are here as written). CDEF (``enable-cdef``) at qualities 30 to
    60, with 128x128 superblocks, on few colours with intra block copy and
    palettes off (both strengths of both planes), with alpha, at odd sizes,
    and at speed 4 with the Wiener or the self-guided filter restoring its
    output (the stripes' outer rows from the deblocked frame). 4:4:4 and
    4:2:2 in RGB and RGBA at speeds 6 and 4 and qualities 30 to 94, on few
    colours (chroma palettes), at 65x130. Lossless (``quality`` 100) in
    4:2:2 and 4:4:4. The 640x480 frame of ``frame640.avif`` at each new
    kind's settings (``AVIF_TIMED``: speed 4, CDEF, 4:4:4, lossless 4:4:4).
    And the textured scene's images of phase 26's second render: the blob's
    base colour at speed 4 in 4:4:4, the checker with CDEF."""
    from ..procedural import base_color_texture, checker_texture

    frame = seeded_images()["frame"]
    rng = np.random.default_rng(230)

    def mix(h, w, seed):  # the noisy frame on the left, waves on the right
        a = np.ascontiguousarray(frame[:h, :w]).copy()
        a[:, w // 2:] = _waves(h, w - w // 2, 3, seed)
        return a

    def rgba(a, seed):
        return np.concatenate([a, _waves(a.shape[0], a.shape[1], 1, seed)], -1)

    cdef = {"enable-cdef": "1"}
    few = _few_colours(96, 128, 231, n=4, cell=8)
    out = {
        "lr_speed0.avif": (mix(256, 256, 232), {"speed": 0, "quality": 40}),
        "lr_speed1.avif": (np.ascontiguousarray(frame[:256, :256]), {"speed": 1, "quality": 70}),
        "lr_speed2.avif": (_waves(256, 256, 3, 233), {"speed": 2, "quality": 40}),
        "lr_speed3.avif": (np.ascontiguousarray(frame[100:300, 200:456]), {"speed": 3,
                                                                           "quality": 70}),
        "lr_speed4.avif": (_waves(256, 256, 3, 234), {"speed": 4, "quality": 70}),
        "lr_sb128.avif": (mix(200, 256, 235), {"speed": 4, "quality": 60,
                                                "advanced": {"sb-size": "128"}}),
        "lr_unit64.avif": (mix(192, 256, 500), {"speed": 0, "quality": 80,
                                                 "advanced": {"sb-size": "64"}}),
        "lr_tiles.avif": (mix(256, 256, 236), {"speed": 4, "quality": 60, "tile_rows": 1,
                                                "tile_cols": 1}),
        "lr_rgba.avif": (rgba(_waves(160, 200, 3, 237), 238), {"speed": 4, "quality": 60}),
        "lr_1x1.avif": (np.full((1, 1, 3), (20, 200, 90), np.uint8), {"speed": 4}),
        "lr_3x5.avif": (rng.integers(0, 256, (3, 5, 3)).astype(np.uint8), {"speed": 4}),
        "lr_65x130.avif": (_waves(65, 130, 3, 585), {"speed": 4, "quality": 80}),
        "lr_130x65.avif": (np.ascontiguousarray(frame[:130, :65]), {"speed": 2, "quality": 80}),
        "lr_77x201.avif": (np.ascontiguousarray(frame[:77, :201]), {"speed": 4, "quality": 60}),
        "lr_640.avif": (frame, {"speed": 4}),
        "cdef_q30.avif": (np.ascontiguousarray(frame[:128, :160]), {"quality": 30,
                                                                    "advanced": cdef}),
        "cdef_sb128.avif": (_waves(200, 256, 3, 240), {"quality": 50, "advanced": {
            "enable-cdef": "1", "sb-size": "128"}}),
        "cdef_few.avif": (_few_colours(160, 200, 49, n=3), {"speed": 4, "quality": 60, "advanced": {
            "enable-cdef": "1", "enable-intrabc": "0", "enable-palette": "0"}}),
        "cdef_rgba.avif": (rgba(_waves(128, 160, 3, 241), 242), {"quality": 30, "advanced": cdef}),
        "cdef_3x5.avif": (rng.integers(0, 256, (3, 5, 3)).astype(np.uint8), {"quality": 30,
                                                                            "advanced": cdef}),
        "cdef_65x130.avif": (_waves(65, 130, 3, 243), {"quality": 30, "advanced": cdef}),
        "cdef_wiener.avif": (_waves(192, 256, 3, 300), {"speed": 4, "quality": 60,
                                                         "advanced": cdef}),
        "cdef_sgrproj.avif": (np.ascontiguousarray(frame[:192, :256]), {"speed": 4, "quality": 60,
                                                                        "advanced": cdef}),
        "cdef_640.avif": (frame, {"advanced": cdef}),
        "blob_basecolor_444_s4.avif": (np.ascontiguousarray(base_color_texture(0)[..., :3]),
                                       {"speed": 4, "subsampling": "4:4:4"}),
        "checker_cdef.avif": (np.ascontiguousarray(checker_texture()[..., :3]), {"advanced": cdef}),
        "lossless_422.avif": (_waves(48, 64, 3, 41), {"quality": 100, "subsampling": "4:2:2"}),
        "lossless_444.avif": (_waves(48, 64, 3, 41), {"quality": 100, "subsampling": "4:4:4"}),
        "lossless_444_rgba.avif": (rgba(_waves(40, 56, 3, 244), 245), {"quality": 100,
                                                                       "subsampling": "4:4:4"}),
        "lossless_444_640.avif": (frame, {"quality": 100, "subsampling": "4:4:4"}),
    }
    for sub in ("444", "422"):
        ss = f"4:{sub[1]}:{sub[2]}"
        out.update({
            f"yuv{sub}_s6_q30.avif": (_waves(96, 128, 3, 246), {"quality": 30, "subsampling": ss}),
            f"yuv{sub}_s4_q60_rgba.avif": (rgba(mix(96, 128, 247), 248), {
                "speed": 4, "quality": 60, "subsampling": ss}),
            f"yuv{sub}_s4_q94.avif": (mix(96, 128, 249), {"speed": 4, "quality": 94,
                                                           "subsampling": ss}),
            f"yuv{sub}_s6_q85_rgba.avif": (rgba(_waves(96, 128, 3, 250), 251), {
                "quality": 85, "subsampling": ss}),
            f"yuv{sub}_few.avif": (few, {"quality": 60, "subsampling": ss}),
            f"yuv{sub}_65x130.avif": (_waves(65, 130, 3, 252), {"speed": 4, "quality": 50,
                                                                 "subsampling": ss}),
        })
    out["yuv444_640.avif"] = (frame, {"subsampling": "4:4:4"})
    return out


def avif_colr_variants() -> dict[str, tuple[str, int, bool]]:
    """The AVIF fixtures made from another of ``avif_tool_sources()``'s by
    patching its ``colr`` box's ``nclx`` matrix coefficients and full-range
    flag alone (the AV1 bitstream is Pillow's): name -> (source, matrix,
    full range). ``alpha_limited.avif`` is not here: it is
    ``lr_rgba.avif`` with its alpha item's ``color_range`` bit cleared
    (``make_avif_tool_fixtures``)."""
    return {"bt709_full.avif": ("lr_speed4.avif", 1, True),
            "bt709_limited.avif": ("cdef_q30.avif", 1, False),
            "identity_444.avif": ("yuv444_s4_q94.avif", 0, True),
            "identity_444_rgba.avif": ("yuv444_s6_q85_rgba.avif", 0, True)}


def _deep(a: np.ndarray, depth: int, seed: int) -> np.ndarray:
    """uint8 ``a`` widened to ``depth`` bits, its new low bits seeded noise."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << (depth - 8), a.shape)
    return ((a.astype(np.uint16) << (depth - 8)) + low).astype(np.uint16)


def _qm_contents(seed: int = 60) -> dict[str, np.ndarray]:
    """uint8 RGB arrays whose blocks aom codes with every transform size:
    ``rect`` (64x64 squares split into 64x32, 32x64, 16x64, 64x16 and 32x8
    tiles of smooth content; at speed 0 the rectangular sizes up to 64),
    ``mix`` (stripes, a cut of the frame, waves: 4x4 to 64x64) and
    ``bands`` (16-row bands of horizontal waves: 64x16)."""
    rng = np.random.default_rng(seed)
    a = np.zeros((256, 256))

    def fill(y0, x0, h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        fy, fx = rng.integers(0, 3, 2)
        a[y0:y0 + h, x0:x0 + w] = rng.uniform(40, 200) + rng.uniform(-60, 60) * np.cos(
            np.pi * (xx + 0.5) / w * fx) * np.cos(np.pi * (yy + 0.5) / h * fy)

    for y0 in range(0, 256, 64):
        for x0 in range(0, 256, 64):
            k = (y0 // 64 + x0 // 64) % 5
            if k == 0:
                fill(y0, x0, 32, 64), fill(y0 + 32, x0, 32, 64)
            elif k == 1:
                fill(y0, x0, 64, 32), fill(y0, x0 + 32, 64, 32)
            elif k == 2:
                for i in range(0, 64, 16):
                    fill(y0, x0 + i, 64, 16)
            elif k == 3:
                for i in range(0, 64, 16):
                    fill(y0 + i, x0, 16, 64)
            else:
                for i in range(0, 64, 8):
                    fill(y0 + i, x0, 8, 32), fill(y0 + i, x0 + 32, 8, 32)
    rect = np.stack([a, a * 0.8 + 20, 255 - a], -1) + rng.normal(0, 1, (256, 256, 3))
    y, x = np.mgrid[0:256, 0:256]
    mix = np.zeros((256, 256, 3))
    mix[:128, :128] = (128 + 100 * np.sin(y[:128, :128] * 0.7))[..., None]
    mix[:128, 128:] = (128 + 100 * np.sin(x[:128, 128:] * 0.7))[..., None]
    mix[128:, :128] = seeded_images()["frame"][:128, :128]
    waves = 128 + 60 * np.sin(x[128:, 128:] * 0.2) + 60 * np.sin(y[128:, 128:] * 0.05)
    mix[128:, 128:] = waves[..., None]
    mix += rng.normal(0, 3, mix.shape)
    bands = np.zeros((128, 256))
    yy, xx = np.mgrid[0:16, 0:64]
    for y0 in range(0, 128, 16):
        for x0 in range(0, 256, 64):
            bands[y0:y0 + 16, x0:x0 + 64] = rng.uniform(40, 200) + rng.uniform(-80, 80) * np.cos(
                np.pi * (xx + 0.5) / 64 * rng.integers(1, 4))
    out = {"rect": rect, "mix": mix, "bands": np.stack([bands] * 3, -1)}
    return {k: np.clip(v, 0, 255).astype(np.uint8) for k, v in out.items()}


def _grain_planes(h: int, w: int, depth: int, subsampling: str, seed: int) -> list[np.ndarray]:
    """Seeded YUV planes of ``depth`` bits (waves), of 4:2:0, 4:2:2, 4:4:4
    or 4:0:0 (Y alone)."""
    rng = np.random.default_rng(seed)
    sx, sy = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0), "4:0:0": (1, 1)}[subsampling]
    sizes = [(h, w)] + ([] if subsampling == "4:0:0" else [((h + sy) >> sy, (w + sx) >> sx)] * 2)
    mid, amp = 1 << (depth - 1), 1 << (depth - 2)
    out = []
    for ph, pw in sizes:
        y, x = np.mgrid[0:ph, 0:pw]
        f = rng.uniform(0.02, 0.2, 2)
        out.append(np.clip(mid + amp * np.sin(x * f[0] + y * f[1]) + rng.normal(0, 2, (ph, pw)),
                           0, (1 << depth) - 1).astype(np.uint16 if depth > 8 else np.uint8))
    return out


def avif_cv2_sources() -> dict[str, tuple[str, object, dict]]:
    """The sources of ``AVIF_CV2_FILES`` but ``avif_cv2_variants()``'s, by
    file name: (writer, pixels, options). ``"cv2"``: OpenCV's ``imwrite``
    of the array (BGR order) with these ``IMWRITE_AVIF_*`` parameters by
    name (``DEPTH``, ``QUALITY``); ``"pillow"``: Pillow's ``save`` of the
    array with these options; ``"libavif"``: a list of YUV planes that
    OpenCV's libavif encodes with these settings (``depth``,
    ``subsampling``, ``film-grain-test``)."""
    from ..procedural import base_color_texture, checker_texture, sky_equirect

    src = plain_sources()
    frame, rgba, grey = src["frame.qoi"], src["frame_rgba.qoi"], src["grey.bw"]
    bgr, bgra = frame[..., ::-1], rgba[..., [2, 1, 0, 3]]
    big = seeded_images()["frame"]
    out: dict[str, tuple[str, object, dict]] = {
        "cv2_bgr.avif": ("cv2", bgr, {}), "cv2_grey.avif": ("cv2", grey, {}),
        "cv2_bgra.avif": ("cv2", bgra, {}),
        "cv2_bgr_q30.avif": ("cv2", bgr, {"QUALITY": 30}),
        "cv2_bgr_q90.avif": ("cv2", bgr, {"QUALITY": 90}),
        "cv2_bgr10_q60.avif": ("cv2", _deep(bgr, 10, 61), {"DEPTH": 10, "QUALITY": 60}),
        "cv2_bgr10_lossless.avif": ("cv2", _deep(bgr, 10, 62), {"DEPTH": 10, "QUALITY": 100}),
        "cv2_bgra12_lossless.avif": ("cv2", _deep(bgra, 12, 63), {"DEPTH": 12, "QUALITY": 100}),
        "yuv400.avif": ("pillow", frame, {"subsampling": "4:0:0"}),
        "yuv400_rgba.avif": ("pillow", rgba, {"subsampling": "4:0:0"}),
    }
    for depth in (10, 12):
        out[f"cv2_bgr{depth}.avif"] = ("cv2", _deep(bgr, depth, depth), {"DEPTH": depth})
        out[f"cv2_grey{depth}.avif"] = ("cv2", _deep(grey, depth, depth + 1), {"DEPTH": depth})
        out[f"cv2_bgra{depth}.avif"] = ("cv2", _deep(bgra, depth, depth + 2), {"DEPTH": depth})
    qm = _qm_contents()
    off = {"enable-qm": "1", "enable-cdef": "0", "enable-restoration": "0"}
    for level in range(15):
        opts = {**off, "qm-min": str(level), "qm-max": str(level)}
        out[f"qm_level{level}.avif"] = ("pillow", qm["rect"], {"quality": 50, "speed": 0,
                                                              "advanced": opts})
    three = {**off, "qm-min": "3", "qm-max": "3"}
    out["qm_mix.avif"] = ("pillow", qm["mix"], {"quality": 40, "speed": 1, "advanced": three})
    out["qm_bands.avif"] = ("pillow", qm["bands"], {"quality": 50, "speed": 0, "advanced": three})
    # film grain: (depth, subsampling, aom's film-grain-test vector, h, w)
    grain = {"grain8_422.avif": (8, "4:2:2", 3, 40, 56),
             "grain10_420.avif": (10, "4:2:0", 1, 48, 64),
             "grain10_444.avif": (10, "4:4:4", 10, 33, 47),
             "grain10_400.avif": (10, "4:0:0", 6, 40, 56),
             "grain12_420.avif": (12, "4:2:0", 13, 65, 70),
             "grain12_422.avif": (12, "4:2:2", 16, 37, 80)}
    for name, (depth, sub, test, h, w) in grain.items():
        out[name] = ("libavif", _grain_planes(h, w, depth, sub, test),
                     {"depth": depth, "subsampling": sub, "film-grain-test": test})
    # the 640x480 files timed on the card
    out["cv2_frame640.avif"] = ("cv2", big[..., ::-1], {})
    out["cv2_grey640.avif"] = ("cv2", big[..., 1], {})
    out["cv2_frame640_10.avif"] = ("cv2", _deep(big[..., ::-1], 10, 64), {"DEPTH": 10})
    out["cv2_frame640_12.avif"] = ("cv2", _deep(big[..., ::-1], 12, 65), {"DEPTH": 12})
    out["film_grain640.avif"] = ("pillow", big, {"advanced": {"film-grain-test": "1"}})
    # the scene's: base colour and plane as OpenCV writes them, panoramas
    sky = sky_equirect()  # 64x128 float32 HDR
    blob_bgr = np.ascontiguousarray(base_color_texture(0)[..., 2::-1])
    out["cv2_blob_basecolor.avif"] = ("cv2", blob_bgr, {})
    out["cv2_checker_grey.avif"] = ("cv2", np.ascontiguousarray(checker_texture()[..., 1]), {})
    for depth in (10, 12):
        top = (1 << depth) - 1
        pano = np.clip(sky / sky.max() * top * 4, 0, top).astype(np.uint16)[..., ::-1]
        out[f"cv2_sky{depth}.avif"] = ("cv2", np.ascontiguousarray(pano), {"DEPTH": depth})
    return out


def avif_cv2_variants() -> dict[str, tuple[str, int, bool]]:
    """The files of ``AVIF_CV2_FILES`` made from another by patching its
    ``colr`` box (``patch_colr``): name -> (source, matrix, full range)."""
    return {"cv2_grey_limited.avif": ("cv2_grey.avif", 2, False),
            "cv2_grey10_limited.avif": ("cv2_grey10.avif", 2, False),
            "cv2_bgr10_limited.avif": ("cv2_bgr10.avif", 6, False),
            "cv2_bgra10_bt709.avif": ("cv2_bgra10.avif", 1, True),
            "cv2_bgr12_bt709_limited.avif": ("cv2_bgr12.avif", 1, False)}


def patch_colr(data: bytes, matrix: int, full_range: bool) -> bytes:
    """``data`` with the first ``nclx`` colr box's matrix coefficients and
    full-range flag set."""
    i = data.index(b"colrnclx") + 8
    flags = (data[i + 6] & 0x7F) | (0x80 if full_range else 0)
    return data[:i + 4] + struct.pack(">HB", matrix, flags) + data[i + 7:]


def avif_write_sources() -> dict[str, np.ndarray]:
    """The arrays whose AVIF files the port's saver writes to the digests
    ``AVIF_ENCODE``: each distinct array of ``avif_sources()`` under its
    first file name (the saver writes Pillow's defaults, so the options are
    dropped), and the 64x48 frame with an opaque alpha (libavif drops an
    alpha of all 255)."""
    out: dict[str, np.ndarray] = {}
    for name, (a, _) in avif_sources().items():
        if not any(b.shape == a.shape and b.dtype == a.dtype and np.array_equal(b, a)
                   for b in out.values()):
            out[name] = a
    frame = out["frame.avif"]
    out["frame_opaque.avif"] = np.concatenate([frame, np.full(frame.shape[:2] + (1,), 255, np.uint8)], -1)
    return out
