"""Multi-threaded async image writer (reference src/image_saver.cpp:22-111,
python wrapper python/src/py_image_saver.cpp:37-105).

Context manager; bounded input queue (2x threads); the destructor/exit drains
outstanding writes. Accepts uint8 RGB(A)/grayscale and uint16 grayscale
arrays (or torch tensors). Our render buffers are already
top-row-first (CV convention), so no vertical flip is needed — the reference
flips only because GL readback is bottom-up.

Copied from ``stillleben_tpu/assets/image_saver.py``; images are encoded
by the port's own encoders, picked by extension as Pillow picks its
writer (``ENCODERS``): ``.png``/``.apng`` (``image.encode_png``),
``.jpg``/``.jpeg``/``.jpe``/``.jfif``/``.mpo`` (``jpeg.encode_jpeg``),
``.bmp``, ``.dib`` (the BMP without its file header), ``.tga`` and its
aliases ``.icb``/``.vda``/``.vst``, ``.tif``/``.tiff``, ``.webp``
(``webp.encode_webp``: libwebp's lossy encoder at quality 80, method 4,
native), ``.gif`` (``gif.encode_gif``: Pillow's median cut for RGB, its
fast octree for RGBA, GIF's LZW, native) and ``.ppm``/``.pgm``/``.pbm``/
``.pnm``/``.pfm`` (``netpbm.encode_netpbm``, by mode whatever the
extension), ``.qoi`` (``qoi.encode_qoi``), ``.sgi``/``.rgb``/``.rgba``/
``.bw`` (``sgi.encode_sgi``), ``.pcx`` (``pcx.encode_pcx``), ``.im``
(``im.encode_im``), ``.dds`` (``dds.encode_dds``), ``.ico`` (``ico.encode_ico``:
PNG entries of Pillow's LANCZOS thumbnails) and ``.icns``
(``icns.encode_icns``: PNG entries of its BICUBIC resizes), ``.eps``/``.ps``
(``eps.encode_eps``), ``.pdf`` (``pdf.encode_pdf``: the JPEG, or for RGBA
the JPEG 2000, in Pillow's one-page file) and ``.jp2``/``.j2k``/``.j2c``/
``.jpc``/``.jpf``/``.jpx`` (``jpeg2000.encode_jpeg2000``: OpenJPEG's
reversible codestream at Pillow's defaults, in the JP2 container except
for ``.j2k``) and ``.avif``/``.avifs`` (``avif.encode_avif``: the port's AV1
encoder at the quantizer libavif picks for quality 75, in libavif's
container). Each but AVIF writes the bytes
of Pillow's ``save`` for the mode the JAX package hands Pillow (8-bit L,
RGB, RGBA; ``I;16`` for uint16); AVIF's bytes are the port's own (aom's
depend on the host's CPU count), with libavif's boxes, aom's sequence
header and quantizer, and a reconstruction every reader decodes alike
(ROADMAP C-24); SGI, IM and PDF write the path's base
name into their files, so the worker hands those encoders the path
(``TAKES_PATH``). A WebP with transparency has its alpha plane compressed
by the port's own lossless stream (the alpha is exact, the other chunks
are Pillow's bytes).

Failures follow the JAX package's: ``save()`` raises ``TypeError`` for a
dtype other than uint8 and uint16 and ``ValueError`` for a uint16 array
that is not 2-D. Everything else is queued, and what Pillow refuses fails
in the worker, printed as ``ImageSaver: failed to write <path>:
<reason>`` with nothing written: an array Pillow makes no L, RGB or RGBA
image of (a 1-D array, a channel count other than 3 and 4), an extension
Pillow does not know (``.exr``, none at all) or knows but cannot write
(``.psd``), and a mode or size Pillow refuses for the format (RGBA or
16-bit as JPEG, 16-bit as BMP, TGA, QOI, SGI, PCX, DDS, EPS or PDF, RGBA as
PCX or EPS, a side over 16383 as WebP). Where Pillow had opened the file
before its writer refused (a known format), a file that was there is left
empty, as Pillow leaves it, or, for a PDF, holding the objects Pillow had
written before it refused the mode (``pdf.PdfModeError.partial``). The
port writes every extension the JAX saver writes (``NOT_PORTED`` is
empty).
"""

from __future__ import annotations

import functools
import os
import queue
import threading

import numpy as np

from .avif import encode_avif
from .bmp import encode_bmp, encode_dib
from .dds import encode_dds
from .eps import encode_eps
from .gif import encode_gif
from .icns import encode_icns
from .ico import encode_ico
from .im import encode_im
from .image import encode_png
from .jpeg import encode_jpeg
from .jpeg2000 import EXTENSIONS as JPEG2000_EXTENSIONS
from .jpeg2000 import encode_jpeg2000
from .netpbm import encode_netpbm
from .pcx import encode_pcx
from .pdf import encode_pdf
from .qoi import encode_qoi
from .sgi import encode_sgi
from .tga import encode_tga
from .tiff import encode_tiff
from .webp import encode_webp

ENCODERS = {".png": encode_png, ".apng": encode_png,
            ".jpg": encode_jpeg, ".jpeg": encode_jpeg, ".jpe": encode_jpeg, ".jfif": encode_jpeg,
            ".mpo": encode_jpeg,
            ".bmp": encode_bmp, ".dib": encode_dib,
            ".tga": encode_tga, ".icb": encode_tga, ".vda": encode_tga, ".vst": encode_tga,
            ".tif": encode_tiff, ".tiff": encode_tiff, ".webp": encode_webp, ".gif": encode_gif,
            ".ppm": encode_netpbm, ".pgm": encode_netpbm, ".pbm": encode_netpbm,
            ".pnm": encode_netpbm, ".pfm": encode_netpbm, ".qoi": encode_qoi,
            ".sgi": encode_sgi, ".rgb": encode_sgi, ".rgba": encode_sgi, ".bw": encode_sgi,
            ".pcx": encode_pcx, ".im": encode_im, ".dds": encode_dds, ".ico": encode_ico,
            ".icns": encode_icns, ".eps": encode_eps, ".ps": encode_eps, ".pdf": encode_pdf,
            ".j2k": functools.partial(encode_jpeg2000, kind="j2k"),
            ".avif": encode_avif, ".avifs": encode_avif}
ENCODERS.update({ext: encode_jpeg2000 for ext in JPEG2000_EXTENSIONS if ext != ".j2k"})
# the encoders that write the path's base name into the file
TAKES_PATH = (encode_sgi, encode_im, encode_pdf)
# extensions Pillow 12.1.0 writes the saver's modes to that the port does not
# encode: none is left
NOT_PORTED = ()
# extensions Pillow opens the file for before its writer runs, but whose
# writers refuse every mode the saver hands them
PIL_REFUSES = (".blp", ".bufr", ".emf", ".grib", ".h5", ".hdf", ".msp", ".palm", ".wmf", ".xbm")


def _to_numpy(img):
    if "torch" in type(img).__module__:
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def _pillow_mode(arr: np.ndarray) -> str | None:
    """The mode of the image the JAX saver builds with ``Image.fromarray``,
    or None where that fails."""
    if arr.dtype == np.uint16:
        return "I;16"
    if arr.ndim == 2:
        return "L"
    if arr.ndim == 3 and arr.shape[2] in (3, 4):
        return "RGB" if arr.shape[2] == 3 else "RGBA"
    return None


def _write(arr: np.ndarray, path: str) -> None:
    """Encode ``arr`` for ``path`` and write it, or raise with the reason
    Pillow gives."""
    mode = _pillow_mode(arr)
    if mode is None:
        raise ValueError(f"Pillow makes no image of a {arr.dtype} array of shape {arr.shape}")
    ext = os.path.splitext(path)[1].lower()
    encoder = ENCODERS.get(ext)
    if ext == ".j2k" and not path.endswith(".j2k"):
        # Pillow writes the bare codestream only for a name that ends in
        # ".j2k" as written (Jpeg2KImagePlugin): ".J2K" and ".J2k" get JP2
        encoder = encode_jpeg2000
    try:
        if encoder is None:
            if ext in PIL_REFUSES:
                raise ValueError(f"cannot write mode {mode} as {ext[1:].upper()}")
            raise ValueError(f"unknown file extension: {ext}")
        data = encoder(arr, path) if encoder in TAKES_PATH else encoder(arr)
    except Exception as e:
        if (encoder is not None or ext in PIL_REFUSES) and os.path.exists(path):
            with open(path, "wb") as f:  # Pillow had opened (and so emptied) it
                f.write(getattr(e, "partial", b""))
        raise
    with open(path, "wb") as f:
        f.write(data)


class ImageSaver:
    def __init__(self, num_threads: int | None = None):
        n = num_threads or min(8, os.cpu_count() or 4)
        self._queue: queue.Queue = queue.Queue(maxsize=2 * n)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(n)
        ]
        self._running = True
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            arr, path = job
            try:
                _write(arr, path)
            except Exception as e:
                print(f"ImageSaver: failed to write {path}: {e}")
            finally:
                self._queue.task_done()

    def save(self, image, path: str):
        """Queue an image for asynchronous writing."""
        arr = _to_numpy(image)
        if arr.dtype not in (np.uint8, np.uint16):
            raise TypeError("ImageSaver expects uint8 or uint16 data")
        if arr.dtype == np.uint16 and arr.ndim != 2:
            raise ValueError("uint16 images must be single-channel")
        self._queue.put((np.ascontiguousarray(arr), path))

    def flush(self):
        self._queue.join()

    def close(self):
        if self._running:
            self.flush()
            for _ in self._threads:
                self._queue.put(None)
            for t in self._threads:
                t.join(timeout=5)
            self._running = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
