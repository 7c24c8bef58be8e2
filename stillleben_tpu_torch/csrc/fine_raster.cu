// Classic-raster fine stage (per-tile z-buffer) for Hopper (sm_90a).
//
// Replaces stillleben_tpu/ops/fine_raster.py::_kernel (tiles_per_cell = 1)
// and ::_kernel_grouped (tiles_per_cell = TPG > 1), the Pallas kernels
// behind fine_raster_pallas. Each screen tile has a list of K triangle
// slots cut into n_chunks chunks of C; per tile the kernel evaluates the
// five edge lines [L0|L1|L2|Lsum|Lz] of every unmasked slot at the tile's
// tile*tile pixel centres and keeps, per pixel, the nearest depth
// wp = Ez / Esum that passes the inside, near/far, depth-peel and id tests.
// Within a chunk the lowest id wins at equal depth; across chunks a later
// chunk wins only with a strictly smaller depth, so at an equal-depth tie
// the earlier chunk keeps its id even when it is the larger one.
//
// What bounds it: at the camera shape (tile 16, C 128) arithmetic, about
// 20 flops and one IEEE division per (unmasked slot, pixel); at the shadow
// shape (tile 64) bytes, because nearly every slot is masked while md and
// the two outputs (3 x 4,096 px x 4 B per tile, ~50 MB at 2048^2) must
// still be read and written once.
//
// Design: one block of 256 threads per tile (K2) or per TPG consecutive
// tiles (K3; TPG is a template parameter instantiated at 1, 4 and 8, and
// the ragged last group is masked instead of padded). The block walks the
// tile's chunks in order. For each chunk it first asks block-wide whether
// any slot is unmasked (__syncthreads_or) and skips the chunk otherwise:
// that is the Pallas kernel's occupancy flag, without a separate array.
// An occupied chunk's 16 x C line rows and C ids are staged in shared
// memory (8.5 KB at C = 128; the rows are contiguous in the triangle-minor
// layout, so the loads coalesce) and every thread reads the same slot at
// the same time (a broadcast). A thread owns tile^2/256 pixels (1 at tile
// 16, 16 at tile 64) and keeps, per pixel, the chunk-local winner and the
// running tile winner in registers; md is read once and each output pixel
// written once, at the end.
//
// Numerics: pixel centres and edge values are computed in exactly the
// plain version's order, (lx*X + ly*Y) + lc, with explicit round-to-nearest
// intrinsics (and --fmad=false) so no multiply-add is contracted, and the
// depth is an IEEE division. The kernel therefore matches
// ops/fine_raster.py::fine_raster_reference bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 16;

template <int PPT, int TPG>
__global__ void fine_raster_kernel(const float* __restrict__ G,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ md,
                                   float* __restrict__ w_out,
                                   int* __restrict__ t_out, int n_tiles,
                                   int n_chunks, int C, int tile, int tw,
                                   int tile_offset, float near_z,
                                   float far_z) {
  extern __shared__ float smem[];
  float* g_s = smem;                                       // kFields * C
  int* id_s = reinterpret_cast<int*>(smem + kFields * C);  // C

  const int pix_n = tile * tile;
  const float tile_f = static_cast<float>(tile);

  for (int tt = 0; tt < TPG; ++tt) {
    const int local = blockIdx.x * TPG + tt;
    if (local >= n_tiles) break;  // uniform over the block
    const int gi = tile_offset + local;  // global tile id: pixel origin
    const float tile_ox = tile_f * static_cast<float>(gi % tw);
    const float tile_oy = tile_f * static_cast<float>(gi / tw);
    const float* md_tile = md + static_cast<size_t>(local) * pix_n;

    float X[PPT], Y[PPT], floor_z[PPT], bw[PPT];
    int bt[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = threadIdx.x + k * kThreads;
      X[k] = __fadd_rn(__fadd_rn(tile_ox, static_cast<float>(p % tile)), 0.5f);
      Y[k] = __fadd_rn(__fadd_rn(tile_oy, static_cast<float>(p / tile)), 0.5f);
      floor_z[k] = __fadd_rn(md_tile[p], 1e-5f);
      bw[k] = INFINITY;
      bt[k] = -1;
    }

    for (int j = 0; j < n_chunks; ++j) {
      const size_t cell = static_cast<size_t>(local) * n_chunks + j;
      const int* ids_c = ids + cell * C;
      int any = 0;
      for (int i = threadIdx.x; i < C; i += kThreads) any |= ids_c[i] >= 0;
      // also the barrier that frees the staging buffer of the last chunk
      if (!__syncthreads_or(any)) continue;  // occupancy skip

      const float* g_c = G + cell * kFields * C;
      for (int i = threadIdx.x; i < kFields * C; i += kThreads) g_s[i] = g_c[i];
      for (int i = threadIdx.x; i < C; i += kThreads) id_s[i] = ids_c[i];
      __syncthreads();

      float cw[PPT];
      int ct[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        cw[k] = INFINITY;
        ct[k] = -1;
      }
      for (int s = 0; s < C; ++s) {
        const int id = id_s[s];
        if (id < 0) continue;  // masked slot: never passes the id >= 0 test
        float g[15];
#pragma unroll
        for (int f = 0; f < 15; ++f) g[f] = g_s[f * C + s];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          float E[5];
#pragma unroll
          for (int e = 0; e < 5; ++e) {
            E[e] = __fadd_rn(__fadd_rn(__fmul_rn(g[3 * e], X[k]),
                                       __fmul_rn(g[3 * e + 1], Y[k])),
                             g[3 * e + 2]);
          }
          const bool inside = (E[0] >= 0.f && E[1] >= 0.f && E[2] >= 0.f) ||
                              (E[0] <= 0.f && E[1] <= 0.f && E[2] <= 0.f);
          const float esum = E[3];
          const bool nondegen = fabsf(esum) > 1e-20f;
          const float denom = fabsf(esum) < 1e-20f ? 1.0f : esum;
          const float wp = __fdiv_rn(E[4], denom);
          const bool ok = inside && nondegen && wp > near_z && wp <= far_z &&
                          wp > floor_z[k];
          if (ok && (wp < cw[k] || (wp == cw[k] && id < ct[k]))) {
            cw[k] = wp;
            ct[k] = id;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (cw[k] < bw[k]) {  // strict: the earlier chunk keeps a tie
          bw[k] = cw[k];
          bt[k] = ct[k];
        }
      }
    }

    float* w_tile = w_out + static_cast<size_t>(local) * pix_n;
    int* t_tile = t_out + static_cast<size_t>(local) * pix_n;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = threadIdx.x + k * kThreads;
      w_tile[p] = bw[k];
      t_tile[p] = bt[k];
    }
  }
}

template <int PPT, int TPG>
cudaError_t launch(const float* G, const int* ids, const float* md, float* w,
                   int* t, int n_tiles, int n_chunks, int C, int tile, int tw,
                   int tile_offset, float near_z, float far_z,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(C) * (kFields + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fine_raster_kernel<PPT, TPG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_tiles + TPG - 1) / TPG;
  fine_raster_kernel<PPT, TPG><<<blocks, kThreads, smem, stream>>>(
      G, ids, md, w, t, n_tiles, n_chunks, C, tile, tw, tile_offset, near_z,
      far_z);
  return cudaGetLastError();
}

template <int PPT>
cudaError_t launch_tpg(int tpg, const float* G, const int* ids,
                       const float* md, float* w, int* t, int n_tiles,
                       int n_chunks, int C, int tile, int tw, int tile_offset,
                       float near_z, float far_z, cudaStream_t s) {
  switch (tpg) {
    case 1:
      return launch<PPT, 1>(G, ids, md, w, t, n_tiles, n_chunks, C, tile, tw,
                            tile_offset, near_z, far_z, s);
    case 4:
      return launch<PPT, 4>(G, ids, md, w, t, n_tiles, n_chunks, C, tile, tw,
                            tile_offset, near_z, far_z, s);
    case 8:
      return launch<PPT, 8>(G, ids, md, w, t, n_tiles, n_chunks, C, tile, tw,
                            tile_offset, near_z, far_z, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns a cudaError_t value:
// 0 on a successful launch; cudaErrorInvalidValue for a tile or a TPG the
// kernel was not instantiated for (tile 16, 32 or 64; TPG 1, 4 or 8).
extern "C" int sl_fine_raster(const void* G, const void* ids, const void* md,
                              void* w, void* t, int n_tiles, int n_chunks,
                              int C, int tile, int tw, int tile_offset,
                              int tpg, float near_z, float far_z,
                              void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* g = static_cast<const float*>(G);
  const auto* id = static_cast<const int*>(ids);
  const auto* m = static_cast<const float*>(md);
  auto* wo = static_cast<float*>(w);
  auto* to = static_cast<int*>(t);
  switch (tile * tile) {
    case 256:
      return launch_tpg<1>(tpg, g, id, m, wo, to, n_tiles, n_chunks, C, tile,
                           tw, tile_offset, near_z, far_z, s);
    case 1024:
      return launch_tpg<4>(tpg, g, id, m, wo, to, n_tiles, n_chunks, C, tile,
                           tw, tile_offset, near_z, far_z, s);
    case 4096:
      return launch_tpg<16>(tpg, g, id, m, wo, to, n_tiles, n_chunks, C, tile,
                            tw, tile_offset, near_z, far_z, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
