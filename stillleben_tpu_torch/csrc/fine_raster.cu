// Classic-raster fine stage (per-tile z-buffer) for Hopper (sm_90a).
//
// Replaces stillleben_tpu/ops/fine_raster.py::_kernel (tiles_per_cell = 1)
// and ::_kernel_grouped (tiles_per_cell = TPG > 1), the Pallas kernels
// behind fine_raster_pallas, together with the row gather before them
// (stillleben_tpu/render/rasterize_tiled.py:627-659). Each screen tile has
// a list of K triangle ids cut into n_chunks chunks of C; per tile the
// kernel evaluates the five edge lines [L0|L1|L2|Lsum|Lz] of every live
// slot at the tile's pixel centres and keeps, per pixel, the nearest depth
// wp = Ez / Esum that passes the inside, near/far, depth-peel and id tests.
// Within a chunk the lowest id wins at equal depth; across chunks a later
// chunk wins only with a strictly smaller depth, so at an equal-depth tie
// the earlier chunk keeps its id even when it is the larger one.
//
// What bounds it: bytes at both bench shapes, md and the two outputs (8 B
// per pixel, ~34 MB at 2048^2), for most tiles are empty; the operations
// the data needs (a cull per live slot and 8x4-pixel patch, the inside test
// at the pixels the cull keeps) take less (chip_smoke.py::needed_ops).
//
// Design, two kernels:
// - occupancy_kernel, one block per tile: reads the tile's ids once and
//   writes its chunk occupancy mask (one bit a chunk, 32 chunks a word, any
//   number of words); an empty tile gets (inf, -1) with 16-byte stores and
//   no md or row read; an occupied tile is appended to a list (the list's
//   order varies from run to run, the result does not depend on it). The
//   many empty tiles cost one short block each, not one per 256 pixels.
// - fine_raster_kernel, a persistent grid that walks the list: a work item
//   is one 16x16 square (256 pixels) of TPG listed tiles (one tile for K2;
//   K3 takes TPG = 4 or 8), so a 64x64 tile is sixteen independent items.
//   The block gathers the occupied chunks' live rows LT[id] (64 B each)
//   straight into shared memory with cp.async, up to four chunks at once
//   (fewer where C x 68 B would not fit the block's shared memory); the
//   gathered, transposed G of the plain version never exists.
// - In a block, S slices of 8 warps share the square: warp w owns the 8x4
//   patch w % 8 and the slot batches w / 8, w / 8 + S, ...; it culls a
//   batch's 32 slots against its patch, one slot a lane, and evaluates only
//   the slots that may cover the patch, inside test first
//   (raster_common.cuh). At the end of each chunk the slices' (depth, id)
//   are folded by the lowest (depth, id), which is the chunk's own rule;
//   then the chunk's winner replaces the running one only when strictly
//   nearer. The chunks run in order, so both tie rules hold without atomics.
//   S > 1 shortens the chain of a heavy tile (up to 320 live slots at the
//   camera), which otherwise sets the kernel's time. S is fixed by the tile
//   (4 at tile 16, 2 at 32, 1 at 64), by measurement at tiles 16 and 64.
//
// Numerics: raster_common.cuh; the kernel matches
// ops/fine_raster.py::fine_raster_plain bit for bit.

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kMaxStages = 4;  // occupied chunks staged at once, at most

// Warps per 8x4-pixel patch (blocks of 256 x S threads), by tile.
template <int TILE>
__host__ __device__ constexpr int slices_of() {
  return TILE == 16 ? 4 : TILE == 32 ? 2 : 1;
}

__global__ void __launch_bounds__(256)
    occupancy_kernel(const int* __restrict__ ids, float* __restrict__ w_out,
                     int* __restrict__ t_out, int* __restrict__ work,
                     int n_tiles, int n_chunks, int C, int pix_n) {
  // work: [0] the count, [1, 1 + n_tiles) the listed tiles, then each
  // tile's occupancy mask, ``words`` words a tile
  const int tile = blockIdx.x;
  const int words = (n_chunks + 31) >> 5;
  const int* ids_tile = ids + static_cast<size_t>(tile) * n_chunks * C;
  unsigned* masks = reinterpret_cast<unsigned*>(work + 1 + n_tiles) +
                    static_cast<size_t>(tile) * words;
  bool any = false;
  for (int wd = 0; wd < words; ++wd) {
    const int j_end = min(n_chunks, (wd + 1) << 5);
    unsigned occupied = 0;
    for (int j = wd << 5; j < j_end; ++j) {
      bool mine = false;
      for (int i = threadIdx.x; i < C; i += blockDim.x) mine |= ids_tile[j * C + i] >= 0;
      if (__syncthreads_or(mine)) occupied |= 1u << (j & 31);
    }
    if (threadIdx.x == 0) masks[wd] = occupied;
    any |= occupied != 0;
  }
  if (any) {
    if (threadIdx.x == 0) work[1 + atomicAdd(work, 1)] = tile;
    return;
  }
  float4* w4 = reinterpret_cast<float4*>(w_out + static_cast<size_t>(tile) * pix_n);
  int4* t4 = reinterpret_cast<int4*>(t_out + static_cast<size_t>(tile) * pix_n);
  for (int i = threadIdx.x; i < pix_n / 4; i += blockDim.x) {
    w4[i] = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    t4[i] = make_int4(-1, -1, -1, -1);
  }
}

template <int TPG, int TILE>
__global__ void __launch_bounds__(256 * slices_of<TILE>())
    fine_raster_kernel(const float* __restrict__ LT, const int* __restrict__ ids,
                       const float* __restrict__ md, float* __restrict__ w_out,
                       int* __restrict__ t_out, const int* __restrict__ work,
                       int n_tiles, int n_chunks, int C, int tw, int tile_offset,
                       int stages, float near_z, float far_z) {
  constexpr int S = slices_of<TILE>();
  constexpr int pix_n = TILE * TILE;
  constexpr int squares = pix_n >> 8;
  extern __shared__ float4 smem[];
  // stage b: rows at smem + b * C * 4, ids at id_base + b * C; then the
  // slices' chunk results
  int* id_base = reinterpret_cast<int*>(smem + stages * C * 4);
  float* red_w = reinterpret_cast<float*>(id_base + stages * C);  // S x 256
  int* red_t = reinterpret_cast<int*>(red_w + S * 256);          // S x 256

  const int count = work[0];
  const int* listed = work + 1;
  const unsigned* masks = reinterpret_cast<const unsigned*>(work + 1 + n_tiles);
  const int words = (n_chunks + 31) >> 5;
  const int n_items = (count + TPG - 1) / TPG * squares;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slice = warp >> 3;
  const int local_px = threadIdx.x & 255;  // this thread's pixel of the square
  const float tile_f = static_cast<float>(TILE);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int square = item % squares;
    const int p = pixel_of(square, warp & 7, lane, TILE);
    const int p0 = pixel_of(square, warp & 7, 0, TILE);  // patch's first pixel
    for (int tt = 0; tt < TPG; ++tt) {
      const int e = item / squares * TPG + tt;
      if (e >= count) break;  // uniform over the block
      const int local = listed[e];
      const unsigned* mask_tile = masks + static_cast<size_t>(local) * words;
      const int* ids_tile = ids + static_cast<size_t>(local) * n_chunks * C;
      const int gi = tile_offset + local;  // global tile id: pixel origin
      const float tile_ox = tile_f * static_cast<float>(gi % tw);
      const float tile_oy = tile_f * static_cast<float>(gi / tw);
      const float X = centre(tile_ox, p % TILE);
      const float Y = centre(tile_oy, p / TILE);
      const float xc = tile_ox + static_cast<float>(p0 % TILE) + 4.0f;
      const float yc = tile_oy + static_cast<float>(p0 / TILE) + 2.0f;
      const float floor_z = __fadd_rn(md[static_cast<size_t>(local) * pix_n + p], 1e-5f);
      float bw = INFINITY;
      int bt = -1;
      // the occupied chunks in order, uniform over the block
      int wd = 0;
      unsigned todo = words > 0 ? mask_tile[0] : 0u;
      auto next_chunk = [&]() {
        while (!todo && ++wd < words) todo = mask_tile[wd];
        if (!todo) return -1;
        const int j = (wd << 5) + __ffs(todo) - 1;
        todo &= todo - 1;
        return j;
      };
      int j = next_chunk();
      while (j >= 0) {
        __syncthreads();  // the staging buffers are free
        int n = 0;  // stage the next occupied chunks, at most ``stages``
        for (; j >= 0 && n < stages; ++n, j = next_chunk()) {
          copy_rows_async(LT, ids_tile + j * C, C, smem + n * C * 4, id_base + n * C);
        }
        cp_async_wait_all();
        __syncthreads();
        for (int b = 0; b < n; ++b) {  // in chunk order
          float cw = INFINITY;
          int ct = -1;
          raster_patch(smem + b * C * 4, id_base + b * C, C, X, Y, xc, yc, floor_z,
                       near_z, far_z, cw, ct, slice, S);
          if (S > 1) {  // fold the slices: the lowest (depth, id)
            red_w[slice * 256 + local_px] = cw;
            red_t[slice * 256 + local_px] = ct;
            __syncthreads();
            if (slice == 0) {
              for (int o = 1; o < S; ++o) {
                const float ow = red_w[o * 256 + local_px];
                const int ot = red_t[o * 256 + local_px];
                if (ow < cw || (ow == cw && ow < INFINITY && ot < ct)) {
                  cw = ow;
                  ct = ot;
                }
              }
            }
            __syncthreads();
          }
          if (cw < bw) {  // strict: the earlier chunk keeps a tie
            bw = cw;
            bt = ct;
          }
        }
      }
      if (slice == 0) {
        w_out[static_cast<size_t>(local) * pix_n + p] = bw;
        t_out[static_cast<size_t>(local) * pix_n + p] = bt;
      }
    }
  }
}

// The current device's SM count and the shared memory a block may opt in
// to, read once per device (the port drives one device per process).
struct Device {
  int id = -1;
  int sms = 0;
  int smem_optin = 0;
};

cudaError_t current_device(Device* out) {
  static Device cached;
  int id = 0;
  cudaError_t err = cudaGetDevice(&id);
  if (err != cudaSuccess) return err;
  if (cached.id != id) {
    Device d;
    d.id = id;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, id);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, id);
    if (err != cudaSuccess) return err;
    cached = d;
  }
  *out = cached;
  return cudaSuccess;
}

template <int TPG, int TILE>
cudaError_t launch(const float* LT, const int* ids, const float* md, float* w,
                   int* t, int* work, int n_tiles, int n_chunks, int C,
                   int tw, int tile_offset, float near_z, float far_z,
                   cudaStream_t stream) {
  constexpr int S = slices_of<TILE>();
  Device dev;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  // as many chunks staged as fit beside the slices' results, at most four
  const size_t per_stage = static_cast<size_t>(C) * (kFields + 1) * sizeof(float);
  const size_t fold = static_cast<size_t>(S) * 256 * 8;
  const size_t room = static_cast<size_t>(dev.smem_optin);
  const int fit = room > fold ? static_cast<int>((room - fold) / per_stage) : 0;
  int stages = n_chunks < 1 ? 1 : n_chunks < kMaxStages ? n_chunks : kMaxStages;
  if (fit < stages) stages = fit;
  if (stages < 1) return cudaErrorInvalidValue;
  const size_t smem = stages * per_stage + fold;
  // a persistent grid: as many blocks as the card holds at once, at most
  // one per work item; the attribute and the occupancy are set and read
  // again only when the device or the shared memory changes
  static int cached_device = -1;
  static size_t cached_smem = 0;
  static int cached_blocks = 0;
  if (cached_device != dev.id || cached_smem != smem) {
    err = cudaFuncSetAttribute(fine_raster_kernel<TPG, TILE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fine_raster_kernel<TPG, TILE>,
                                                        256 * S, smem);
    if (err != cudaSuccess) return err;
    cached_device = dev.id;
    cached_smem = smem;
    cached_blocks = dev.sms * (per_sm > 0 ? per_sm : 1);
  }
  err = cudaMemsetAsync(work, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  occupancy_kernel<<<n_tiles, 256, 0, stream>>>(ids, w, t, work, n_tiles,
                                                n_chunks, C, TILE * TILE);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int items = (n_tiles + TPG - 1) / TPG * (TILE * TILE / 256);
  const int blocks = cached_blocks < items ? cached_blocks : items;
  fine_raster_kernel<TPG, TILE><<<blocks, 256 * S, smem, stream>>>(
      LT, ids, md, w, t, work, n_tiles, n_chunks, C, tw, tile_offset, stages, near_z, far_z);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``work`` is int32 scratch of
// 1 + n_tiles * (1 + ceil(n_chunks / 32)). Returns a cudaError_t value: 0
// on a successful launch; cudaErrorInvalidValue for a tile or a TPG the
// kernel does not take (tile 16, 32 or 64; TPG 1, 4 or 8), or a chunk
// whose rows do not fit a block's shared memory.
extern "C" int sl_fine_raster(const void* LT, const void* ids, const void* md,
                              void* w, void* t, void* work, int n_tiles,
                              int n_chunks, int C, int tile, int tw,
                              int tile_offset, int tpg, float near_z,
                              float far_z, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_chunks < 0 || C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lt = static_cast<const float*>(LT);
  const auto* id = static_cast<const int*>(ids);
  const auto* m = static_cast<const float*>(md);
  auto* wo = static_cast<float*>(w);
  auto* to = static_cast<int*>(t);
  auto* wk = static_cast<int*>(work);
  switch (tpg * 100 + tile) {
#define SL_CASE(TPG, TILE)                                                    \
  case TPG * 100 + TILE:                                                      \
    return launch<TPG, TILE>(lt, id, m, wo, to, wk, n_tiles, n_chunks, C, tw, \
                             tile_offset, near_z, far_z, s);
    SL_CASE(1, 16)
    SL_CASE(1, 32)
    SL_CASE(1, 64)
    SL_CASE(4, 16)
    SL_CASE(4, 32)
    SL_CASE(4, 64)
    SL_CASE(8, 16)
    SL_CASE(8, 32)
    SL_CASE(8, 64)
#undef SL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
