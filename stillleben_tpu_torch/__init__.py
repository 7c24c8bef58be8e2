"""stillleben_tpu_torch: the datagen path of ``stillleben_tpu`` in PyTorch,
for NVIDIA Hopper GPUs.

The package imports torch and numpy, never jax and nothing of
``stillleben_tpu``. It has its own host asset layer (``assets/``: OBJ and
PLY import, consolidation, convex cooking, decimation; ``physics/bodies``:
mass properties), copied from the JAX package's and trimmed to what the
port uses. Every TPU kernel of the JAX package is a CUDA kernel here
(``csrc/``, wrapped by ``ops/``): the compact-cell z-buffer of the default
raster, the fine z-buffer of the classic raster
(``FrameConfig(raster="classic")``) and the toolchain check.

Entry point: ``parallel.batch.generate_batch``; templates go to ``cuda``
unless the caller asks for the CPU.
"""
