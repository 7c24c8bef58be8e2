"""Multi-threaded random image loader (reference src/image_loader.cpp:33-262).

Samples random images from a directory using a worker pool with input/output
queues, rate-limited error tolerance (bad files are skipped and re-enqueued;
a warning fires after 10 consecutive failures — reference
image_loader.cpp:94-99,165-201), seeded RNG, and returns Texture objects.

Copied from ``stillleben_tpu/assets/image_loader.py``; images are decoded
by the port's own codec (``image.py::read_image``, Pillow's
``convert("RGBA")``, of every format ``IMAGE_EXTENSIONS`` lists, WebP
frame 0 included). A file the codec cannot decode counts as a failed load,
as a file Pillow cannot open does in the JAX package.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import warnings

import numpy as np

from .image import read_image
from .texture import Texture, Texture2D

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tga", ".tif", ".tiff", ".webp")


class ImageLoader:
    def __init__(self, path: str, seed: int | None = None, num_threads: int | None = None):
        self._path = path
        self._files = [
            os.path.join(path, f)
            for f in sorted(os.listdir(path))
            if f.lower().endswith(IMAGE_EXTENSIONS)
        ]
        if not self._files:
            raise ValueError(f"ImageLoader: no images found in {path!r}")
        self._rng = np.random.default_rng(seed if seed is not None else int(time.time()))
        self._out: queue.Queue = queue.Queue(maxsize=8)
        self._failures = 0
        self._stop = False
        n = num_threads or min(8, os.cpu_count() or 4)
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(n)
        ]
        self._lock = threading.Lock()
        for t in self._threads:
            t.start()

    def _worker(self):
        while not self._stop:
            with self._lock:
                f = self._files[int(self._rng.integers(len(self._files)))]
            try:
                arr = read_image(f)
                with self._lock:
                    self._failures = 0
            except Exception:
                with self._lock:
                    self._failures += 1
                    if self._failures == 10:
                        warnings.warn(
                            f"ImageLoader: 10 consecutive failures loading from {self._path}"
                        )
                continue
            try:
                self._out.put(arr, timeout=0.5)
            except queue.Full:
                if self._stop:
                    return

    def next_rectangle_texture(self) -> Texture:
        """(reference ImageLoader::nextRectangleTexture)"""
        return Texture(self._out.get())

    def next_texture2d(self) -> Texture2D:
        """(reference ImageLoader::nextTexture2D — mipmapped variant)"""
        return Texture2D(self._out.get())

    # pythonic alias
    def next_texture(self) -> Texture:
        return self.next_rectangle_texture()

    def close(self):
        self._stop = True
        while not self._out.empty():
            try:
                self._out.get_nowait()
            except queue.Empty:
                break

    def __del__(self):
        self._stop = True
