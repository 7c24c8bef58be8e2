// Public C API of the native convex-decomposition helper (sl_decompose.cpp),
// a copy of native/sl_decompose.h.
#ifndef STILLLEBEN_TPU_SL_DECOMPOSE_H
#define STILLLEBEN_TPU_SL_DECOMPOSE_H

#ifdef __cplusplus
extern "C" {
#endif

// Approximate convex decomposition (voxelize + recursive split + quickhull).
// Returns the number of hulls written (<= max_hulls), or -1 on error.
//
//   verts            [n_verts * 3] float32 positions
//   tris             [n_tris * 3] int32 vertex indices
//   concavity        split threshold (hull_volume/part_volume tolerance)
//   resolution       voxel grid resolution along the longest axis
//   force_single     nonzero -> single convex hull of everything
//   out_verts        [max_hulls * max_hull_verts * 3]
//   out_vert_counts  [max_hulls]
//   out_planes       [max_hulls * max_hull_planes * 4] (nx ny nz d)
//   out_plane_counts [max_hulls]
//   out_volumes      [max_hulls]
//   out_coms         [max_hulls * 3]
//   out_inertias     [max_hulls * 9] (row-major, about the COM, unit density)
int sl_decompose(const float* verts, int n_verts, const int* tris, int n_tris,
                 float concavity, int max_hulls, int resolution,
                 int force_single, int max_hull_verts, int max_hull_planes,
                 float* out_verts, int* out_vert_counts, float* out_planes,
                 int* out_plane_counts, float* out_volumes, float* out_coms,
                 float* out_inertias);

// Convenience: single convex hull of a point cloud (no triangles needed).
// Returns 1 on success, -1 on error.
int sl_convex_hull(const float* verts, int n_verts, int max_hull_verts,
                   int max_hull_planes, float* out_verts, int* out_vert_count,
                   float* out_planes, int* out_plane_count, float* out_volume,
                   float* out_com, float* out_inertia);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // STILLLEBEN_TPU_SL_DECOMPOSE_H
