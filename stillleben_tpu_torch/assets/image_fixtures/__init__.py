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
YCCK). ``digests.py`` holds the SHA-256 of each encode
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
