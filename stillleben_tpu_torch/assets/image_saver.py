"""Multi-threaded async image writer (reference src/image_saver.cpp:22-111,
python wrapper python/src/py_image_saver.cpp:37-105).

Context manager; bounded input queue (2x threads); the destructor/exit drains
outstanding writes. Accepts uint8 RGB(A)/grayscale and uint16 grayscale
arrays (or torch tensors). Our render buffers are already
top-row-first (CV convention), so no vertical flip is needed — the reference
flips only because GL readback is bottom-up.

Copied from ``stillleben_tpu/assets/image_saver.py``; images are encoded
by the port's own PNG encoder (``image.py::encode_png``: 8-bit L, RGB,
RGBA and 16-bit grey, the modes the JAX package hands Pillow). A path
whose extension the port cannot encode raises in ``save()`` itself, before
anything is queued.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from .image import encode_png


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
                data = encode_png(arr)
                with open(path, "wb") as f:
                    f.write(data)
            except Exception as e:  # pragma: no cover
                print(f"ImageSaver: failed to write {path}: {e}")
            finally:
                self._queue.task_done()

    def save(self, image, path: str):
        """Queue an image for asynchronous writing (PNG)."""
        ext = os.path.splitext(path)[1].lower()
        if ext != ".png":
            raise NotImplementedError(
                f"ImageSaver: cannot write {ext or 'extensionless'} files {path!r} "
                "(the port encodes PNG only)"
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
