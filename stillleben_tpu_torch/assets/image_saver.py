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
extension). Each writes the bytes of Pillow's ``save`` for the mode the
JAX package hands Pillow (8-bit L, RGB, RGBA; ``I;16`` for uint16); a
WebP with transparency has its alpha plane compressed by the port's own
lossless stream (the alpha is exact, the other chunks are Pillow's bytes).
A mode or size Pillow refuses for a format (RGBA or 16-bit as JPEG and
its aliases, 16-bit as BMP, DIB or TGA and its aliases, a side over 16383
as WebP) fails in the worker as it does in the JAX package: printed,
nothing written. A path whose extension the port cannot encode (``.qoi``,
``.pcx``, any other Pillow writes or not) raises ``NotImplementedError``
in ``save()`` itself, before anything is queued.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from .bmp import encode_bmp, encode_dib
from .gif import encode_gif
from .image import encode_png
from .jpeg import encode_jpeg
from .netpbm import encode_netpbm
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
            ".pnm": encode_netpbm, ".pfm": encode_netpbm}


def _to_numpy(img):
    if "torch" in type(img).__module__:
        img = img.detach().cpu().numpy()
    return np.asarray(img)


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
                data = ENCODERS[os.path.splitext(path)[1].lower()](arr)
                with open(path, "wb") as f:
                    f.write(data)
            except Exception as e:
                print(f"ImageSaver: failed to write {path}: {e}")
            finally:
                self._queue.task_done()

    def save(self, image, path: str):
        """Queue an image for asynchronous writing."""
        ext = os.path.splitext(path)[1].lower()
        if ext not in ENCODERS:
            raise NotImplementedError(
                f"ImageSaver: cannot write {ext or 'extensionless'} files {path!r} "
                f"(the port encodes {' '.join(ENCODERS)})"
            )
        arr = _to_numpy(image)
        if arr.dtype not in (np.uint8, np.uint16):
            raise TypeError("ImageSaver expects uint8 or uint16 data")
        if arr.dtype == np.uint16 and arr.ndim != 2:
            raise ValueError("uint16 images must be single-channel")
        if arr.dtype == np.uint8 and not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (3, 4))):
            raise ValueError(f"ImageSaver expects (H, W), (H, W, 3) or (H, W, 4), not {arr.shape}")
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
