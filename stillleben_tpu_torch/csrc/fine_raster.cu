// Classic-raster fine stage (per-tile z-buffer) for Hopper (sm_90a).
//
// Replaces stillleben_tpu/ops/fine_raster.py::_kernel (tiles_per_cell = 1,
// K2) and ::_kernel_grouped (tiles_per_cell = TPG = 4 or 8, K3), the
// Pallas kernels behind fine_raster_pallas, together with the row gather
// before them (stillleben_tpu/render/rasterize_tiled.py:627-659). Each
// screen tile has a list of K triangle ids cut into n_chunks chunks of C;
// per tile the kernel evaluates the five edge lines [L0|L1|L2|Lsum|Lz] of
// every live slot at the tile's pixel centres and keeps, per pixel, the
// nearest depth wp = Ez / Esum that passes the inside, near/far, depth-peel
// and id tests. Within a chunk the lowest id wins at equal depth; across
// chunks a later chunk wins only with a strictly smaller depth, so at an
// equal-depth tie the earlier chunk keeps its id even when it is the larger
// one.
//
// What bounds it: bytes at both bench shapes, md and the two outputs (8 B
// per pixel, ~34 MB at 2048^2), for most tiles are empty; the operations
// the data needs (a cull per live slot and 8x4-pixel patch, the inside test
// at the pixels the cull keeps) take less (chip_smoke.py::needed_ops). In
// practice the fixed costs (the launches, the fill of the empty tiles) and
// the latency chain of the heaviest tile set the time.
//
// K2 (tiles_per_cell = 1), two kernels:
// - occupancy_kernel, one block per tile: reads the tile's ids once and
//   writes its chunk occupancy mask (one bit a chunk, 32 chunks a word, any
//   number of words); an empty tile gets (inf, -1) with 16-byte stores and
//   no md or row read; an occupied tile is appended to a list (the list's
//   order varies from run to run, the result does not depend on it). The
//   many empty tiles cost one short block each, not one per 256 pixels.
// - fine_raster_kernel, a persistent grid that walks the list: a work item
//   is one 16x16 square (256 pixels) of a listed tile, so a 64x64 tile is
//   sixteen independent items. The block gathers the occupied chunks' live
//   rows LT[id] (64 B each) straight into shared memory with cp.async, up
//   to four chunks at once (fewer where C x 68 B would not fit the block's
//   shared memory); the gathered, transposed G of the plain version never
//   exists.
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
// K3 (tiles_per_cell = TPG = 4 or 8): the JAX package's group, tiles
// g*TPG ... g*TPG + TPG - 1 of the slab (a strip of one tile row where tw
// is a multiple of TPG; the last group may be ragged), fixed by tile id. On
// the TPU the group cut the per-cell fixed cost; here the per-tile fixed
// cost is the occupancy pass and the list, so the group carries them:
// - group_occupancy_kernel, one block per group (ceil(n_tiles / TPG)
//   blocks, not one per tile): one warp per (tile, chunk) reads the chunk's
//   ids once; the block writes K2's masks, fills the group's empty tiles
//   and lists the group as one word, a bit per occupied tile. No counter,
//   so no memset before it and no atomic order in it.
// - grouped_fine_raster_kernel: K2's items on K2's persistent grid. Each
//   block ranks the occupied tiles from the groups' words (a block scan,
//   list_groups) and keeps its own items in shared memory, so an item
//   costs no load of a global list. The group's tiles are rasterized at
//   the same time by different blocks, never one after another in one
//   block, and no tile's chain grows by its group mates'.
// A design with a thread-block cluster per group, whose blocks split the
// heaviest tile's slot batches and folded them through distributed shared
// memory, measured 1.5-2.8x K2: that tile's time is a chain of dependent
// loads, not issue throughput, and the clusters' shared memory cut the
// resident blocks (PERF.md).
//
// Numerics: raster_common.cuh; the kernels match
// ops/fine_raster.py::fine_raster_plain bit for bit.

#include <mutex>

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

// K3's list, built by each block of the fine kernel from the groups' bits
// (group_occupancy_kernel): each thread counts the occupied tiles of a run
// of groups, a block scan ranks them in tile id order, and the block keeps
// the tiles of its own items. The persistent grid hands out items round
// robin (item i to block i % gridDim.x), and neighbouring tiles carry
// similar loads, so the ranks are scattered by a fixed bijection, rank *
// P mod count with P a prime that does not divide count: items of
// neighbouring heavy tiles do not meet on one block. Tile k of the list
// is items k * SQUARES ... (k + 1) * SQUARES - 1; item i lands at
// items_s[i / gridDim.x]. Returns the number of occupied tiles.
template <int TPG, int SQUARES>
__device__ int list_groups(const unsigned* __restrict__ group_bits, int n_tiles,
                           int* items_s) {
  __shared__ int warp_count[32];
  __shared__ int total_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_groups = (n_tiles + TPG - 1) / TPG;
  const int per = (n_groups + blockDim.x - 1) / blockDim.x;
  const int g0 = min(n_groups, static_cast<int>(threadIdx.x) * per);
  const int g1 = min(n_groups, g0 + per);
  int mine = 0;
  for (int g = g0; g < g1; ++g) mine += __popc(group_bits[g]);
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  int rank = incl - mine;
  for (int w = 0; w < warp; ++w) rank += warp_count[w];
  if (threadIdx.x == blockDim.x - 1) total_s = rank + mine;
  __syncthreads();
  const int total = total_s;
  const long long prime = total % 1000003 ? 1000003 : 1000033;
  const int grid = gridDim.x, block = blockIdx.x;
  for (int g = g0; g < g1; ++g) {
    for (unsigned bits = group_bits[g]; bits; bits &= bits - 1, ++rank) {
      const int lo = static_cast<int>(rank * prime % total) * SQUARES;  // the tile's items
      for (int i = lo + ((block - lo) % grid + grid) % grid; i < lo + SQUARES; i += grid) {
        items_s[i / grid] = g * TPG + __ffs(bits) - 1;
      }
    }
  }
  __syncthreads();
  return total;
}

template <int TPG, int TILE>
__device__ __forceinline__ void fine_items(const float* __restrict__ LT,
                                           const int* __restrict__ ids,
                                           const float* __restrict__ md,
                                           float* __restrict__ w_out, int* __restrict__ t_out,
                                           const int* __restrict__ work, int n_tiles,
                                           int n_chunks, int C, int tw, int tile_offset,
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

  const int* listed = work + 1;
  const unsigned* masks = reinterpret_cast<const unsigned*>(work + 1 + n_tiles);
  const int words = (n_chunks + 31) >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int count;
  int* items_s = red_t + S * 256;  // K3: this block's tiles, in item order
  if constexpr (TPG == 1) {
    count = work[0];
  } else {
    count = list_groups<TPG, squares>(masks + static_cast<size_t>(n_tiles) * words, n_tiles,
                                      items_s);  // the groups' words follow the masks
  }
  const int n_items = count * squares;
  const int slice = warp >> 3;
  const int local_px = threadIdx.x & 255;  // this thread's pixel of the square
  const float tile_f = static_cast<float>(TILE);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int square = item % squares;
    const int p = pixel_of(square, warp & 7, lane, TILE);
    const int p0 = pixel_of(square, warp & 7, 0, TILE);  // patch's first pixel
    const int local = TPG == 1 ? listed[item / squares] : items_s[item / gridDim.x];
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

template <int TILE>
__global__ void __launch_bounds__(256 * slices_of<TILE>())
    fine_raster_kernel(const float* __restrict__ LT, const int* __restrict__ ids,
                       const float* __restrict__ md, float* __restrict__ w_out,
                       int* __restrict__ t_out, const int* __restrict__ work,
                       int n_tiles, int n_chunks, int C, int tw, int tile_offset,
                       int stages, float near_z, float far_z) {
  fine_items<1, TILE>(LT, ids, md, w_out, t_out, work, n_tiles, n_chunks, C, tw, tile_offset,
                      stages, near_z, far_z);
}

// K3's entry: K2's items, its list built by each block. The list takes
// registers; the bound keeps as many blocks on an SM as K2's own registers
// allow (49 / 51 / 48 at tiles 16 / 32 / 64: 1, 2 and 5 blocks).
template <int TPG, int TILE>
__global__ void __launch_bounds__(256 * slices_of<TILE>(), TILE == 16 ? 1 : TILE == 32 ? 2 : 5)
    grouped_fine_raster_kernel(const float* __restrict__ LT, const int* __restrict__ ids,
                               const float* __restrict__ md, float* __restrict__ w_out,
                               int* __restrict__ t_out, const int* __restrict__ work,
                               int n_tiles, int n_chunks, int C, int tw, int tile_offset,
                               int stages, float near_z, float far_z) {
  fine_items<TPG, TILE>(LT, ids, md, w_out, t_out, work, n_tiles, n_chunks, C, tw, tile_offset,
                        stages, near_z, far_z);
}

template <int TPG, int TILE>
constexpr auto fine_kernel() {
  if constexpr (TPG == 1) {
    return fine_raster_kernel<TILE>;
  } else {
    return grouped_fine_raster_kernel<TPG, TILE>;
  }
}

// K3's occupancy pass, one block per group of TPG tiles: K2's masks and
// fills, and after the masks each group's occupied tiles, a bit a tile.
template <int TPG>
__global__ void __launch_bounds__(256)
    group_occupancy_kernel(const int* __restrict__ ids, float* __restrict__ w_out,
                           int* __restrict__ t_out, int* __restrict__ work, int n_tiles,
                           int n_chunks, int C, int pix_n) {
  __shared__ unsigned occupied_s;  // bit r: tile r of the group
  const int words = (n_chunks + 31) >> 5;
  unsigned* masks = reinterpret_cast<unsigned*>(work + 1 + n_tiles);
  const int g = blockIdx.x;
  const int first = g * TPG;
  const int nt = min(TPG, n_tiles - first);  // the last group may be ragged
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < nt * words; i += blockDim.x) {
    masks[static_cast<size_t>(first) * words + i] = 0u;
  }
  if (threadIdx.x == 0) occupied_s = 0u;
  __syncthreads();
  // one warp a (tile, chunk): a chunk's ids at once
  for (int i = warp; i < nt * n_chunks; i += 8) {
    const int r = i / n_chunks, j = i % n_chunks;
    const int* chunk = ids + (static_cast<size_t>(first) * n_chunks + i) * C;
    bool mine = false;
    for (int s = lane; s < C; s += 32) mine |= chunk[s] >= 0;
    if (__any_sync(0xffffffffu, mine) && lane == 0) {
      atomicOr(masks + static_cast<size_t>(first + r) * words + (j >> 5), 1u << (j & 31));
      atomicOr(&occupied_s, 1u << r);
    }
  }
  __syncthreads();
  const unsigned occupied = occupied_s;
  if (threadIdx.x == 0) masks[static_cast<size_t>(n_tiles) * words + g] = occupied;
  for (int r = 0; r < nt; ++r) {  // the group's empty tiles: (inf, -1)
    if ((occupied >> r) & 1u) continue;
    float4* w4 = reinterpret_cast<float4*>(w_out + static_cast<size_t>(first + r) * pix_n);
    int4* t4 = reinterpret_cast<int4*>(t_out + static_cast<size_t>(first + r) * pix_n);
    for (int i = threadIdx.x; i < pix_n / 4; i += blockDim.x) {
      w4[i] = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      t4[i] = make_int4(-1, -1, -1, -1);
    }
  }
}

// The SM count and the shared memory a block may opt in to of the device
// being launched on (the wrappers in ops/ make it current),
// read once per device id. A process may drive several cards, from several
// threads, so each id has its own entry, filled once under std::call_once.
constexpr int kMaxDevices = 64;

struct Device {
  int id = -1;
  int sms = 0;
  int smem_optin = 0;
  cudaError_t err = cudaSuccess;
};

Device g_devices[kMaxDevices];
std::once_flag g_device_once[kMaxDevices];

cudaError_t current_device(Device* out) {
  int id = 0;
  cudaError_t err = cudaGetDevice(&id);
  if (err != cudaSuccess) return err;
  if (id < 0 || id >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(g_device_once[id], [id] {
    Device& d = g_devices[id];
    d.err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, id);
    if (d.err == cudaSuccess)
      d.err = cudaDeviceGetAttribute(&d.smem_optin,
                                     cudaDevAttrMaxSharedMemoryPerBlockOptin, id);
    d.id = id;
  });
  *out = g_devices[id];
  return out->err;
}

// A kernel's launch shape on one device: its dynamic shared memory
// attribute and its persistent grid. The attribute is state of the device
// being launched on, so each instantiation keeps one entry per device id,
// read and updated under the instantiation's lock.
struct LaunchShape {
  size_t smem = 0;     // the shared memory the grid was sized for
  int blocks = 0;      // the persistent grid at that size
  size_t allowed = 0;  // the kernel's dynamic shared memory attribute
};

template <int TPG, int TILE>
cudaError_t launch(const float* LT, const int* ids, const float* md, float* w,
                   int* t, int* work, int n_tiles, int n_chunks, int C,
                   int tw, int tile_offset, float near_z, float far_z,
                   cudaStream_t stream) {
  constexpr int S = slices_of<TILE>();
  constexpr int squares = TILE * TILE / 256;
  const auto kernel = fine_kernel<TPG, TILE>();
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
  size_t smem = stages * per_stage + fold;
  // a persistent grid: as many blocks as the card holds at once, at most
  // one per work item; the attribute and the occupancy are set and read
  // again only when the shared memory changes on that device
  static std::mutex mu;
  static LaunchShape shapes[kMaxDevices];
  std::lock_guard<std::mutex> lock(mu);
  LaunchShape& shape = shapes[dev.id];
  if (shape.smem != smem) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    shape.allowed = smem;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        256 * S, smem);
    if (err != cudaSuccess) return err;
    shape.smem = smem;
    shape.blocks = dev.sms * (per_sm > 0 ? per_sm : 1);
  }
  const int items = n_tiles * squares;
  const int blocks = shape.blocks < items ? shape.blocks : items;
  if (TPG == 1) {
    err = cudaMemsetAsync(work, 0, sizeof(int), stream);
    if (err != cudaSuccess) return err;
    occupancy_kernel<<<n_tiles, 256, 0, stream>>>(ids, w, t, work, n_tiles,
                                                  n_chunks, C, TILE * TILE);
  } else {
    smem += static_cast<size_t>((items + blocks - 1) / blocks) * sizeof(int);  // its items
    if (smem > shape.allowed) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      shape.allowed = smem;
    }
    group_occupancy_kernel<TPG><<<(n_tiles + TPG - 1) / TPG, 256, 0, stream>>>(
        ids, w, t, work, n_tiles, n_chunks, C, TILE * TILE);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  kernel<<<blocks, 256 * S, smem, stream>>>(
      LT, ids, md, w, t, work, n_tiles, n_chunks, C, tw, tile_offset, stages, near_z, far_z);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). ``work`` is int32 scratch of
// 1 + n_tiles * (1 + ceil(n_chunks / 32)), and ceil(n_tiles / tpg) more for
// tpg 4 or 8. Returns a cudaError_t value: 0
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
