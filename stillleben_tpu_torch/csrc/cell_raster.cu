// Compact-cell z-buffer for Hopper (sm_90a), cells to tiles in one pass.
//
// Replaces stillleben_tpu/ops/cell_raster.py::_kernel (the Pallas kernel
// behind cell_raster_pallas) together with the gather before it and the
// cells -> tiles merge after it (stillleben_tpu/render/rasterize_tiled.py
// :334 and :360-377). Each CELL holds up to C triangle ids that all touch
// one screen tile; per pixel centre of that tile the kernel keeps the
// nearest depth wp = Ez / Esum that passes the inside, near/far, depth-peel
// and id tests, the lowest id at equal depth, and folds it into the tile's
// result with the same rule.
//
// What bounds it: operations at the camera shape (tile 16), bytes at the
// 2048^2 shadow shape (tile 32). Counted from the data, a cell needs a cull
// of each live slot against each 8x4-pixel patch of its tile, the inside
// test only at the pixels of the patches the cull keeps and the depth only
// where a pixel is inside (313 M operations at the 640x480 bench camera);
// the bytes are a 64-B line row per live slot, the ids, the floor and the
// outputs (chip_smoke.py::needed_ops).
//
// Design:
// - One block per cell; a block of an invalid cell (cell_tile >= n_tiles)
//   returns at once and writes nothing.
// - The block gathers its live slots' rows LT[id] (64 B each) straight into
//   shared memory with cp.async, 16 B per thread; the gathered table G of
//   the plain version never exists. md is read per tile through cell_tile
//   (or not at all: a null md is a floor of 0).
// - A warp owns 8x4-pixel patches of the tile and culls the slots against
//   each patch, 32 at a time, before it evaluates any pixel; then the
//   inside test comes first, and a warp whose pixels are all outside skips
//   the division (raster_common.cuh). Most (slot, pixel) pairs are outside:
//   at 640x480 a triangle covers a few pixels of a 256- or 1,024-pixel tile.
// - The merge: each pixel's cell winner goes into a per-tile 64-bit key,
//   (orderable(w) << 32) | id, with atomicMin. The lexicographic minimum
//   of those keys is the minimum depth with the lowest id at ties, which is
//   exactly the merge of rasterize_tiled.py:360-377, and atomicMin does not
//   depend on the order of the blocks, so the result is deterministic. The
//   key buffer starts all ones (empty) and a short unpack kernel turns it
//   into (depth, id), the empty key into (inf, -1).
// - A thread owns PPT pixels, one in each of PPT patches of its warp, and
//   keeps a pixel's running (depth, id) in registers until its atomicMin.
//   PPT is fixed by the tile: 1 at tile 16 and 2 at tile 32, by
//   measurement (PERF.md), 16 at tile 64 (256 threads).

#include "raster_common.cuh"

namespace {

using namespace raster;

// Pixels per thread, by tile; a block has tile^2 / PPT threads.
template <int TILE>
__host__ __device__ constexpr int ppt_of() {
  return TILE == 16 ? 1 : TILE == 32 ? 2 : 16;
}

template <int TILE>
__global__ void __launch_bounds__(TILE * TILE / ppt_of<TILE>())
    cell_raster_kernel(const float* __restrict__ LT, const int* __restrict__ ids,
                       const int* __restrict__ cell_tile,
                       const float* __restrict__ md,
                       unsigned long long* __restrict__ keys, int C, int tw,
                       int n_tiles, float near_z, float far_z) {
  constexpr int PPT = ppt_of<TILE>();
  constexpr int THREADS = TILE * TILE / PPT;
  constexpr int tile = TILE;
  extern __shared__ float4 smem[];
  float4* g_s = smem;                                 // C x 4 parts
  int* id_s = reinterpret_cast<int*>(smem + C * 4);  // C

  const int cell = blockIdx.x;
  const int ti = cell_tile[cell];
  if (ti >= n_tiles || ti < 0) return;  // invalid cell: nothing to write
  const int pix_n = tile * tile;

  copy_rows_async(LT, ids + static_cast<size_t>(cell) * C, C, g_s, id_s);
  cp_async_wait_all();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float tile_f = static_cast<float>(tile);
  const float tile_ox = tile_f * static_cast<float>(ti % tw);
  const float tile_oy = tile_f * static_cast<float>(ti / tw);
  unsigned long long* keys_tile = keys + static_cast<size_t>(ti) * pix_n;
  __syncthreads();

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int g = warp + k * (THREADS / 32);  // this warp's k-th 8x4 patch
    const int p = pixel_of(g >> 3, g & 7, lane, tile);
    const int p0 = pixel_of(g >> 3, g & 7, 0, tile);  // the patch's first pixel
    const float m = md ? md[static_cast<size_t>(ti) * pix_n + p] : 0.0f;
    float bw = INFINITY;
    int bt = -1;
    raster_patch(g_s, id_s, C, centre(tile_ox, p % tile), centre(tile_oy, p / tile),
                 tile_ox + static_cast<float>(p0 % tile) + 4.0f,
                 tile_oy + static_cast<float>(p0 / tile) + 2.0f, __fadd_rn(m, 1e-5f), near_z,
                 far_z, bw, bt);
    if (bw < INFINITY) {
      const unsigned long long key =
          (static_cast<unsigned long long>(orderable(bw)) << 32) | static_cast<unsigned>(bt);
      atomicMin(keys_tile + p, key);
    }
  }
}

// Keys -> (depth, id), two pixels a thread (16-byte loads); n is even.
__global__ void unpack_kernel(const ulonglong2* __restrict__ keys,
                              float2* __restrict__ w, int2* __restrict__ t,
                              size_t n2) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n2; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const ulonglong2 k = keys[i];
    const bool e0 = k.x == kEmptyKey, e1 = k.y == kEmptyKey;
    w[i] = make_float2(e0 ? INFINITY : from_orderable(static_cast<unsigned>(k.x >> 32)),
                       e1 ? INFINITY : from_orderable(static_cast<unsigned>(k.y >> 32)));
    t[i] = make_int2(e0 ? -1 : static_cast<int>(k.x & 0xffffffffu),
                     e1 ? -1 : static_cast<int>(k.y & 0xffffffffu));
  }
}

template <int TILE>
cudaError_t launch(const float* LT, const int* ids, const int* cell_tile,
                   const float* md, unsigned long long* keys, int n_cells,
                   int C, int tw, int n_tiles, float near_z, float far_z,
                   cudaStream_t stream) {
  constexpr int THREADS = TILE * TILE / ppt_of<TILE>();
  const size_t smem = static_cast<size_t>(C) * (kFields + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cell_raster_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cell_raster_kernel<TILE><<<n_cells, THREADS, smem, stream>>>(
      LT, ids, cell_tile, md, keys, C, tw, n_tiles, near_z, far_z);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``keys`` is scratch of n_tiles
// x tile^2 uint64; w and t (n_tiles x tile^2) receive the per-tile result.
// Returns a cudaError_t value: 0 on success, cudaErrorInvalidValue for a
// tile other than 16, 32 or 64.
extern "C" int sl_cell_raster(const void* LT, const void* ids,
                              const void* cell_tile, const void* md,
                              void* keys, void* w, void* t, int n_cells, int C,
                              int tile, int tw, int n_tiles, float near_z,
                              float far_z, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lt = static_cast<const float*>(LT);
  const auto* id = static_cast<const int*>(ids);
  const auto* ct = static_cast<const int*>(cell_tile);
  const auto* m = static_cast<const float*>(md);
  auto* k = static_cast<unsigned long long*>(keys);
  if (tile != 16 && tile != 32 && tile != 64) return cudaErrorInvalidValue;
  const size_t n = static_cast<size_t>(n_tiles) * tile * tile;
  if (n == 0) return 0;
  cudaError_t err = cudaMemsetAsync(k, 0xff, n * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return err;
  if (n_cells > 0) {
    err = tile == 16   ? launch<16>(lt, id, ct, m, k, n_cells, C, tw, n_tiles, near_z, far_z, s)
          : tile == 32 ? launch<32>(lt, id, ct, m, k, n_cells, C, tw, n_tiles, near_z, far_z, s)
                       : launch<64>(lt, id, ct, m, k, n_cells, C, tw, n_tiles, near_z, far_z, s);
    if (err != cudaSuccess) return err;
  }
  const size_t n2 = n / 2;  // tile^2 is even
  const int blocks = static_cast<int>((n2 + 255) / 256 < 4096 ? (n2 + 255) / 256 : 4096);
  unpack_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const ulonglong2*>(k),
                                       static_cast<float2*>(w), static_cast<int2*>(t), n2);
  return cudaGetLastError();
}
