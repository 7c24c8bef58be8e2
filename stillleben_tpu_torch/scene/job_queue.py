"""Multi-threaded physics simulator facade.

Counterpart of ``stillleben_tpu/scene/job_queue.py`` (reference
src/job_queue.cpp:30-144, python/src/py_job_queue.cpp:18-48). The reference
runs one PhysX scene per CPU thread; here each worker thread runs a scene's
``simulate_tabletop_scene`` on the context's device (the worker makes that
device its current CUDA device, so a launch of the thread lands there too).
A scene draws only from its own generators, so its result does not depend
on how the threads interleave. The settle issues its small ops from Python,
so the threads overlap little under the interpreter lock; for throughput
use ``parallel.batch.generate_batch``. This class exists for API
compatibility.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading

import torch

from ..context import context


class JobQueue:
    def __init__(self, num_threads: int | None = None):
        n = num_threads or max((os.cpu_count() or 2) // 2, 1)
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self._threads = [threading.Thread(target=self._worker, daemon=True) for _ in range(n)]
        for t in self._threads:
            t.start()

    def _worker(self):
        while True:
            scene = self._in.get()
            if scene is None:
                return
            try:
                dev = context().device
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    scene.simulate_tabletop_scene()
                self._out.put(scene)
            except Exception as e:  # handed to retrieve_scene, which raises it
                self._out.put(e)

    def add_scene(self, scene) -> None:
        """Queue a scene for tabletop simulation."""
        self._in.put(scene)

    def retrieve_scene(self):
        """Block until a simulated scene is available and return it (FIFO)."""
        out = self._out.get()
        if isinstance(out, Exception):
            raise out
        return out

    # reference camelCase aliases
    addScene = add_scene
    retrieveScene = retrieve_scene

    def close(self):
        for _ in self._threads:
            self._in.put(None)
