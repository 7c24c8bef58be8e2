// Pieces shared by the two z-buffer kernels (cell_raster.cu, fine_raster.cu).
//
// - The line-row gather: a triangle's packed line row LT[id] is 16 floats
//   (64 B), copied into shared memory as four 16-byte cp.async transfers.
// - The pixel layout: 256 pixels of a 16x16 square of a tile, each warp
//   an 8x4 patch of it, so that a small triangle touches few patches.
// - The patch cull: 32 slots at a time, each lane tests one slot's three
//   edges against its warp's patch (conservatively, see may_cover); the
//   warp then evaluates only the slots that may cover a pixel of it.
// - The edge evaluation, two surviving slots at a time (their instructions
//   overlap), inside test first: E0..E2 and the inside test for every
//   (slot, pixel) left; Esum, Ez, the IEEE division and the depth tests
//   only where the pixel is inside, and a warp whose lanes are all outside
//   skips them (__any_sync). Every operation is an explicit
//   round-to-nearest intrinsic (and the build passes --fmad=false), in the
//   plain version's order (lx*X + ly*Y) + lc, so a pixel that is inside
//   gets bit for bit the depth of ops/cell_raster.py::cell_raster_reference,
//   and a pixel that is not gets nothing, as there.
//   The edge product has an inner dimension of 3 and must stay float32 to
//   be exact, so tensor cores (TF32, bf16) have no part in it.
// - The 64-bit merge keys: (orderable(w) << 32) | low bits. orderable maps
//   float32 bits to an unsigned int whose order is the float order
//   (negative depths included), after -0.0 becomes +0.0, which the float
//   compare treats as equal. ops/cell_raster.py::depth_keys mirrors it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace raster {

constexpr int kFields = 16;  // [L0|L1|L2|Lsum|Lz] x (x, y, c) + 1 pad
constexpr unsigned long long kEmptyKey = ~0ull;

// Pixel index within a tile of the ``lane`` of warp ``wslot`` (0..7) of
// 16x16 square ``q`` (row-major over the tile's tile/16 x tile/16 squares).
__device__ __forceinline__ int pixel_of(int q, int wslot, int lane, int tile) {
  const int squares = tile >> 4;
  const int x = ((q % squares) << 4) + ((wslot & 1) << 3) + (lane & 7);
  const int y = ((q / squares) << 4) + ((wslot >> 1) << 2) + (lane >> 3);
  return y * tile + x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shared-memory row layout: slot s's row is four float4 parts, part p at
// float4 index s * 4 + (p ^ ((s >> 1) & 3)). The XOR spreads the rows of 8
// consecutive slots over all 32 banks, so the cull (each lane reads
// another slot's row) has no bank conflicts; a broadcast read (every lane
// the same slot) has none either way.
__device__ __forceinline__ int part_index(int s, int p) {
  return s * 4 + (p ^ ((s >> 1) & 3));
}

// Start copying the line rows of C slots into g_s (C x 4 float4) and
// their ids into id_s; masked slots (id < 0) copy nothing. The caller waits
// (cp_async_wait_all) and synchronises.
__device__ __forceinline__ void copy_rows_async(const float* __restrict__ LT,
                                                const int* __restrict__ ids, int C,
                                                float4* g_s, int* id_s) {
  for (int i = threadIdx.x; i < C * 4; i += blockDim.x) {
    const int slot = i >> 2, part = i & 3;
    const int id = ids[slot];
    if (part == 0) id_s[slot] = id;
    if (id >= 0) {
      cp_async16(g_s + part_index(slot, part),
                 LT + static_cast<size_t>(id) * kFields + part * 4);
    }
  }
}

__device__ __forceinline__ void load_row(const float4* g_s, int s, float g[16]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float4 v = g_s[part_index(s, p)];
    g[4 * p] = v.x;
    g[4 * p + 1] = v.y;
    g[4 * p + 2] = v.z;
    g[4 * p + 3] = v.w;
  }
}

// Can a triangle be inside at any pixel centre of a warp's 8x4 patch?
// The centres span xc +- 3.5, yc +- 1.5, and an edge value is affine in
// (X, Y), so over the patch it lies within c +- r (c at the middle, r the
// half-range). The patch is out when some edge is below 0 at every centre
// (no "all >= 0") and some edge is above 0 at every centre (no "all <=
// 0"). The margin, 1e-5 of the largest term sum (some 80 float32 ulps)
// plus 1e-30 (for subnormal terms), is far beyond the rounding of c, r and
// of the per-pixel evaluation, so a pixel that the evaluation finds inside
// is never culled; a NaN or inf coefficient fails every compare and culls
// nothing.
__device__ __forceinline__ bool may_cover(const float g[16], float xc, float yc) {
  bool below = false, above = false;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float ax = fabsf(g[3 * e]), ay = fabsf(g[3 * e + 1]);
    const float c = g[3 * e] * xc + g[3 * e + 1] * yc + g[3 * e + 2];
    const float r = ax * 3.5f + ay * 1.5f;
    const float m = 1e-5f * (ax * (fabsf(xc) + 3.5f) + ay * (fabsf(yc) + 1.5f) +
                             fabsf(g[3 * e + 2])) +
                    1e-30f;
    below |= c + r < -m;
    above |= c - r > m;
  }
  return !(below && above);
}

// Pixel centre coordinate: (origin + index) + 0.5, as the plain version.
__device__ __forceinline__ float centre(float origin, int index) {
  return __fadd_rn(__fadd_rn(origin, static_cast<float>(index)), 0.5f);
}

__device__ __forceinline__ float edge(float lx, float ly, float lc, float X,
                                      float Y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(lx, X), __fmul_rn(ly, Y)), lc);
}

// The depth path of one slot at one pixel, for a lane that is inside:
// updates the running (bw, bt) with the lowest id at equal depth.
__device__ __forceinline__ void depth_update(const float g[16], int id, float X,
                                             float Y, float floor_z, float near_z,
                                             float far_z, bool inside, float& bw,
                                             int& bt) {
  const float esum = edge(g[9], g[10], g[11], X, Y);
  const float ez = edge(g[12], g[13], g[14], X, Y);
  const bool nondegen = fabsf(esum) > 1e-20f;
  const float denom = fabsf(esum) < 1e-20f ? 1.0f : esum;
  const float wp = __fdiv_rn(ez, denom);
  const bool ok = inside && nondegen && wp > near_z && wp <= far_z && wp > floor_z;
  if (ok && (wp < bw || (wp == bw && id < bt))) {
    bw = wp;
    bt = id;
  }
}

__device__ __forceinline__ bool inside_of(const float g[16], float X, float Y) {
  const float E0 = edge(g[0], g[1], g[2], X, Y);
  const float E1 = edge(g[3], g[4], g[5], X, Y);
  const float E2 = edge(g[6], g[7], g[8], X, Y);
  return (E0 >= 0.f && E1 >= 0.f && E2 >= 0.f) || (E0 <= 0.f && E1 <= 0.f && E2 <= 0.f);
}

// Two slots at one pixel, inside test first; a slot that no lane of the
// warp is inside skips its depth path (__any_sync). The two slots'
// instructions are independent, so they overlap; the result is that of
// one slot after the other, in either order.
__device__ __forceinline__ void eval_pair(const float g0[16], int id0, const float g1[16],
                                          int id1, float X, float Y, float floor_z,
                                          float near_z, float far_z, float& bw, int& bt) {
  const bool in0 = inside_of(g0, X, Y);
  const bool in1 = inside_of(g1, X, Y);
  const bool any0 = __any_sync(0xffffffffu, in0);
  const bool any1 = __any_sync(0xffffffffu, in1);
  if (any0) depth_update(g0, id0, X, Y, floor_z, near_z, far_z, in0, bw, bt);
  if (any1) depth_update(g1, id1, X, Y, floor_z, near_z, far_z, in1, bw, bt);
}

// A warp z-buffers its 8x4 patch (this lane: X, Y) against the C staged
// slots: 32 slots at a time (the batches slice, slice + slices, ... when
// several warps share the patch), each lane culls one slot against the
// patch (xc, yc: the patch's middle), then the warp evaluates the slots that
// may cover it. The running minimum does not depend on the order, so
// neither culling nor slicing changes a result.
__device__ __forceinline__ void raster_patch(const float4* g_s, const int* id_s,
                                             int C, float X, float Y, float xc,
                                             float yc, float floor_z,
                                             float near_z, float far_z,
                                             float& bw, int& bt, int slice = 0,
                                             int slices = 1) {
  const int lane = threadIdx.x & 31;
  for (int base = 32 * slice; base < C; base += 32 * slices) {
    const int s = base + lane;
    bool cand = false;
    if (s < C && id_s[s] >= 0) {
      float g[16];
      load_row(g_s, s, g);
      cand = may_cover(g, xc, yc);
    }
    unsigned todo = __ballot_sync(0xffffffffu, cand);
    while (todo) {  // two slots at a time; a lone last one pairs with itself
      const int j0 = base + __ffs(todo) - 1;
      todo &= todo - 1;
      const int j1 = todo ? base + __ffs(todo) - 1 : j0;
      todo &= todo - 1;
      float g0[16], g1[16];
      load_row(g_s, j0, g0);
      load_row(g_s, j1, g1);
      eval_pair(g0, id_s[j0], g1, id_s[j1], X, Y, floor_z, near_z, far_z, bw, bt);
    }
  }
}

__device__ __forceinline__ unsigned orderable(float w) {
  const unsigned u = __float_as_uint(__fadd_rn(w, 0.0f));  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

}  // namespace raster
