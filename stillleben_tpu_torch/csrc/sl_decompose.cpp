// sl_decompose: native approximate convex decomposition (host code, C++17).
//
// A copy of native/sl_decompose.cpp, the JAX package's native cooker; the
// code is the same, so the same input gives the same hulls in both
// packages. Functional replacement for the reference's vendored V-HACD
// (reference contrib/v-hacd, used from src/mesh.cpp:340-430):
//   1. exact solid voxelization (triangle-box SAT surface marking + outside
//      flood fill),
//   2. recursive longest-axis splitting until parts are convex enough,
//   3. quickhull per part + analytic mass properties.
//
// Exposed as a C API consumed via ctypes (assets/native_decompose.py), the
// port's default cooker; assets/convex.py holds the Python decomposition,
// selected with STILLLEBEN_TPU_NATIVE_DECOMP=0.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 sl_decompose.cpp -o libsl_decompose.so
// (assets/native_decompose.py does this at first use, into _build/)

#include "sl_decompose.h"

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct V3 {
  double x = 0, y = 0, z = 0;
  V3() = default;
  V3(double a, double b, double c) : x(a), y(b), z(c) {}
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

// ---------------------------------------------------------------------------
// Quickhull (incremental, with horizon walking)
// ---------------------------------------------------------------------------

struct QHFace {
  int v[3];
  V3 n;         // outward unit normal
  double d;     // plane offset: n·x + d = 0, inside < 0
  bool alive = true;
  std::vector<int> outside;  // candidate points above this face
};

struct Hull {
  std::vector<V3> verts;                 // hull vertices
  std::vector<std::array<int, 3>> tris;  // faces indexing verts
};

constexpr double kEps = 1e-10;

static bool quickhull(const std::vector<V3>& pts, Hull& out) {
  const int n = (int)pts.size();
  if (n < 4) return false;

  // initial extreme points
  int ix0 = 0, ix1 = 0;
  for (int i = 1; i < n; ++i) {
    if (pts[i].x < pts[ix0].x) ix0 = i;
    if (pts[i].x > pts[ix1].x) ix1 = i;
  }
  if (ix0 == ix1) return false;
  // farthest from the line
  int ix2 = -1;
  double best = kEps;
  V3 dir = pts[ix1] - pts[ix0];
  for (int i = 0; i < n; ++i) {
    V3 w = (pts[i] - pts[ix0]).cross(dir);
    double d2 = w.dot(w);
    if (d2 > best) { best = d2; ix2 = i; }
  }
  if (ix2 < 0) return false;
  // farthest from the plane
  V3 pn = (pts[ix1] - pts[ix0]).cross(pts[ix2] - pts[ix0]);
  double pl = pn.norm();
  if (pl < kEps) return false;
  pn = pn * (1.0 / pl);
  int ix3 = -1;
  best = 1e-9;
  for (int i = 0; i < n; ++i) {
    double d = std::abs(pn.dot(pts[i] - pts[ix0]));
    if (d > best) { best = d; ix3 = i; }
  }
  if (ix3 < 0) return false;

  std::vector<QHFace> faces;
  auto makeFace = [&](int a, int b, int c, const V3& interior) {
    QHFace f;
    f.v[0] = a; f.v[1] = b; f.v[2] = c;
    V3 nn = (pts[b] - pts[a]).cross(pts[c] - pts[a]);
    double l = nn.norm();
    if (l < kEps) l = 1.0;
    nn = nn * (1.0 / l);
    double dd = -nn.dot(pts[a]);
    if (nn.dot(interior) + dd > 0) {  // flip outward
      std::swap(f.v[1], f.v[2]);
      nn = nn * -1.0;
      dd = -dd;
    }
    f.n = nn;
    f.d = dd;
    return f;
  };

  V3 centroid = (pts[ix0] + pts[ix1] + pts[ix2] + pts[ix3]) * 0.25;
  faces.push_back(makeFace(ix0, ix1, ix2, centroid));
  faces.push_back(makeFace(ix0, ix1, ix3, centroid));
  faces.push_back(makeFace(ix0, ix2, ix3, centroid));
  faces.push_back(makeFace(ix1, ix2, ix3, centroid));

  // assign outside sets
  double scale = 0;
  for (int i = 0; i < n; ++i)
    scale = std::max(scale, std::abs(pts[i].x) + std::abs(pts[i].y) + std::abs(pts[i].z));
  const double tol = 1e-9 * std::max(scale, 1.0) + 1e-12;
  for (int i = 0; i < n; ++i) {
    for (auto& f : faces) {
      if (f.n.dot(pts[i]) + f.d > tol) { f.outside.push_back(i); break; }
    }
  }

  for (int guard = 0; guard < 8 * n + 64; ++guard) {
    // find a face with outside points
    int fi = -1;
    for (int i = 0; i < (int)faces.size(); ++i)
      if (faces[i].alive && !faces[i].outside.empty()) { fi = i; break; }
    if (fi < 0) break;

    // farthest point
    QHFace& f = faces[fi];
    int far = f.outside[0];
    double fd = f.n.dot(pts[far]) + f.d;
    for (int p : f.outside) {
      double d = f.n.dot(pts[p]) + f.d;
      if (d > fd) { fd = d; far = p; }
    }

    // visible set (BFS over all faces; simple O(F) per step)
    std::vector<int> visible;
    for (int i = 0; i < (int)faces.size(); ++i)
      if (faces[i].alive && faces[i].n.dot(pts[far]) + faces[i].d > tol)
        visible.push_back(i);

    // horizon edges: edges of visible faces shared with non-visible faces
    auto edgeKey = [](int a, int b) { return ((int64_t)std::min(a, b) << 32) | std::max(a, b); };
    std::vector<std::pair<int, int>> horizon;
    {
      // count directed edges of the visible set
      std::vector<std::pair<int64_t, std::pair<int, int>>> edges;
      for (int vi : visible) {
        const QHFace& vf = faces[vi];
        for (int e = 0; e < 3; ++e) {
          int a = vf.v[e], b = vf.v[(e + 1) % 3];
          edges.push_back({edgeKey(a, b), {a, b}});
        }
      }
      std::sort(edges.begin(), edges.end(),
                [](auto& l, auto& r) { return l.first < r.first; });
      for (size_t i = 0; i < edges.size();) {
        size_t j = i;
        while (j < edges.size() && edges[j].first == edges[i].first) ++j;
        if (j - i == 1) horizon.push_back(edges[i].second);  // boundary edge
        i = j;
      }
    }
    if (horizon.empty()) { f.outside.clear(); continue; }

    // collect orphaned points, kill visible faces
    std::vector<int> orphans;
    for (int vi : visible) {
      for (int p : faces[vi].outside)
        if (p != far) orphans.push_back(p);
      faces[vi].alive = false;
      faces[vi].outside.clear();
    }

    // create new faces from horizon to the far point
    size_t firstNew = faces.size();
    for (auto& e : horizon)
      faces.push_back(makeFace(e.first, e.second, far, centroid));

    // reassign orphans
    for (int p : orphans) {
      for (size_t i = firstNew; i < faces.size(); ++i) {
        if (faces[i].n.dot(pts[p]) + faces[i].d > tol) {
          faces[i].outside.push_back(p);
          break;
        }
      }
    }
  }

  // compact output
  std::vector<int> remap(n, -1);
  for (auto& f : faces) {
    if (!f.alive) continue;
    std::array<int, 3> t{};
    for (int e = 0; e < 3; ++e) {
      int v = f.v[e];
      if (remap[v] < 0) {
        remap[v] = (int)out.verts.size();
        out.verts.push_back(pts[v]);
      }
      t[e] = remap[v];
    }
    out.tris.push_back(t);
  }
  return out.verts.size() >= 4;
}

// vertex reduction: farthest-point sampling (matches assets/convex.py)
static std::vector<V3> reduceVerts(const std::vector<V3>& verts, int target) {
  const int n = (int)verts.size();
  if (n <= target) return verts;
  V3 mean;
  for (auto& v : verts) mean = mean + v;
  mean = mean * (1.0 / n);
  int first = 0;
  double best = -1;
  for (int i = 0; i < n; ++i) {
    double d = (verts[i] - mean).norm();
    if (d > best) { best = d; first = i; }
  }
  std::vector<char> chosen(n, 0);
  std::vector<double> dist(n);
  chosen[first] = 1;
  for (int i = 0; i < n; ++i) dist[i] = (verts[i] - verts[first]).norm();
  for (int k = 1; k < target; ++k) {
    int far = 0;
    double fd = -1;
    for (int i = 0; i < n; ++i)
      if (!chosen[i] && dist[i] > fd) { fd = dist[i]; far = i; }
    chosen[far] = 1;
    for (int i = 0; i < n; ++i)
      dist[i] = std::min(dist[i], (verts[i] - verts[far]).norm());
  }
  std::vector<V3> out;
  for (int i = 0; i < n; ++i)
    if (chosen[i]) out.push_back(verts[i]);
  return out;
}

// mass properties via signed tetrahedra about the hull centroid
static void massProperties(const Hull& h, double* volume, V3* com, double I[9]) {
  V3 centroid;
  for (auto& v : h.verts) centroid = centroid + v;
  centroid = centroid * (1.0 / std::max<size_t>(h.verts.size(), 1));

  double vol = 0;
  V3 comAcc;
  double Ixx[3][3] = {{0}};
  for (auto& t : h.tris) {
    V3 a = h.verts[t[0]] - centroid;
    V3 b = h.verts[t[1]] - centroid;
    V3 c = h.verts[t[2]] - centroid;
    // orient outward
    if (b.cross(c).dot(a) < 0) std::swap(b, c);
    double det = a.dot(b.cross(c));
    vol += det / 6.0;
    comAcc = comAcc + (a + b + c) * (det / 24.0);
    double p[3] = {a.x, a.y, a.z}, q[3] = {b.x, b.y, b.z}, r[3] = {c.x, c.y, c.z};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double term = p[i] * p[j] + q[i] * q[j] + r[i] * r[j] +
                      0.5 * (p[i] * q[j] + q[i] * p[j]) +
                      0.5 * (q[i] * r[j] + r[i] * q[j]) +
                      0.5 * (p[i] * r[j] + r[i] * p[j]);
        Ixx[i][j] += det * term / 60.0;
      }
  }
  double m = std::max(vol, 1e-12);
  V3 comLocal = comAcc * (1.0 / m);
  *volume = vol;
  *com = comLocal + centroid;
  double trace = Ixx[0][0] + Ixx[1][1] + Ixx[2][2];
  double d[3] = {comLocal.x, comLocal.y, comLocal.z};
  double dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double Ic = (i == j ? trace : 0.0) - Ixx[i][j];
      I[i * 3 + j] = Ic - m * ((i == j ? dd : 0.0) - d[i] * d[j]);
    }
}

// face planes (deduplicated) from hull triangles
static void facePlanes(const Hull& h, std::vector<std::array<float, 4>>& planes) {
  V3 centroid;
  for (auto& v : h.verts) centroid = centroid + v;
  centroid = centroid * (1.0 / std::max<size_t>(h.verts.size(), 1));
  for (auto& t : h.tris) {
    V3 a = h.verts[t[0]], b = h.verts[t[1]], c = h.verts[t[2]];
    V3 n = (b - a).cross(c - a);
    double l = n.norm();
    if (l < kEps) continue;
    n = n * (1.0 / l);
    if (n.dot(a - centroid) < 0) n = n * -1.0;
    double d = -n.dot(a);
    bool dup = false;
    for (auto& p : planes) {
      if (std::abs(p[0] - n.x) < 1e-5 && std::abs(p[1] - n.y) < 1e-5 &&
          std::abs(p[2] - n.z) < 1e-5 && std::abs(p[3] - d) < 1e-5) {
        dup = true;
        break;
      }
    }
    if (!dup) planes.push_back({(float)n.x, (float)n.y, (float)n.z, (float)d});
  }
}

// ---------------------------------------------------------------------------
// Voxelization: triangle-box SAT surface marking + outside flood fill
// ---------------------------------------------------------------------------

static bool triBoxOverlap(const V3& bc, const V3& bh, const V3& a, const V3& b,
                          const V3& c) {
  // Akenine-Moller triangle-box SAT
  V3 v0 = a - bc, v1 = b - bc, v2 = c - bc;
  V3 e0 = v1 - v0, e1 = v2 - v1, e2 = v0 - v2;

  auto axisTest = [&](const V3& ax) {
    double p0 = ax.dot(v0), p1 = ax.dot(v1), p2 = ax.dot(v2);
    double mn = std::min({p0, p1, p2}), mx = std::max({p0, p1, p2});
    double r = bh.x * std::abs(ax.x) + bh.y * std::abs(ax.y) + bh.z * std::abs(ax.z);
    return !(mn > r || mx < -r);
  };

  const V3 axes[3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (auto& ax : axes)
    if (!axisTest(ax)) return false;
  const V3 edges[3] = {e0, e1, e2};
  for (auto& ax : axes)
    for (auto& e : edges)
      if (!axisTest(ax.cross(e))) return false;
  return axisTest(e0.cross(e1));
}

}  // namespace

extern "C" {

// Decompose; returns number of hulls written (<= max_hulls), or -1 on error.
int sl_decompose(const float* verts, int n_verts, const int* tris, int n_tris,
                 float concavity, int max_hulls, int resolution,
                 int force_single, int max_hull_verts, int max_hull_planes,
                 float* out_verts,     // [max_hulls * max_hull_verts * 3]
                 int* out_vert_counts, // [max_hulls]
                 float* out_planes,    // [max_hulls * max_hull_planes * 4]
                 int* out_plane_counts,
                 float* out_volumes,   // [max_hulls]
                 float* out_coms,      // [max_hulls * 3]
                 float* out_inertias)  // [max_hulls * 9]
{
  if (n_verts < 4 || n_tris < 1) return -1;
  std::vector<V3> pts(n_verts);
  for (int i = 0; i < n_verts; ++i)
    pts[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};

  auto buildHull = [&](const std::vector<V3>& source, Hull& h) -> bool {
    std::vector<V3> p = source;
    // iterate until verts AND planes fit the device budget
    int target = std::min((int)p.size(), max_hull_verts);
    for (int iter = 0; iter < 12; ++iter) {
      Hull cand;
      std::vector<V3> reduced = reduceVerts(p, target);
      if (!quickhull(reduced, cand)) return false;
      std::vector<std::array<float, 4>> planes;
      facePlanes(cand, planes);
      if ((int)cand.verts.size() <= max_hull_verts &&
          (int)planes.size() <= max_hull_planes) {
        h = std::move(cand);
        return true;
      }
      target = std::max(target * 3 / 4, 8);
    }
    return false;
  };

  auto emit = [&](const Hull& h, int slot) {
    int nv = std::min((int)h.verts.size(), max_hull_verts);
    for (int i = 0; i < nv; ++i) {
      out_verts[(slot * max_hull_verts + i) * 3 + 0] = (float)h.verts[i].x;
      out_verts[(slot * max_hull_verts + i) * 3 + 1] = (float)h.verts[i].y;
      out_verts[(slot * max_hull_verts + i) * 3 + 2] = (float)h.verts[i].z;
    }
    out_vert_counts[slot] = nv;
    std::vector<std::array<float, 4>> planes;
    facePlanes(h, planes);
    int np = std::min((int)planes.size(), max_hull_planes);
    for (int i = 0; i < np; ++i)
      std::memcpy(&out_planes[(slot * max_hull_planes + i) * 4], planes[i].data(),
                  4 * sizeof(float));
    out_plane_counts[slot] = np;
    double vol;
    V3 com;
    double I[9];
    massProperties(h, &vol, &com, I);
    out_volumes[slot] = (float)vol;
    out_coms[slot * 3 + 0] = (float)com.x;
    out_coms[slot * 3 + 1] = (float)com.y;
    out_coms[slot * 3 + 2] = (float)com.z;
    for (int i = 0; i < 9; ++i) out_inertias[slot * 9 + i] = (float)I[i];
  };

  // single hull of everything
  Hull single;
  if (!buildHull(pts, single)) return -1;
  double singleVol;
  {
    V3 com; double I[9];
    massProperties(single, &singleVol, &com, I);
  }

  if (force_single || max_hulls <= 1) {
    emit(single, 0);
    return 1;
  }

  // ---- solid voxelization ----
  V3 lo = pts[0], hi = pts[0];
  for (auto& p : pts) {
    lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
    hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
  }
  V3 ext = hi - lo;
  double maxExt = std::max({ext.x, ext.y, ext.z, 1e-9});
  double vox = maxExt / (resolution - 3);
  int dims[3] = {(int)std::ceil(ext.x / vox) + 3, (int)std::ceil(ext.y / vox) + 3,
                 (int)std::ceil(ext.z / vox) + 3};
  V3 origin = lo - V3(vox, vox, vox);
  auto idx = [&](int x, int y, int z) {
    return (size_t)(z * dims[1] + y) * dims[0] + x;
  };
  std::vector<uint8_t> grid((size_t)dims[0] * dims[1] * dims[2], 0);  // 1=surface

  // conservative inflation: geometry exactly on a voxel boundary must mark
  // at least one neighbor (float equality can otherwise exclude both)
  const double hb = vox * 0.5 * 1.0001;
  const V3 half(hb, hb, hb);
  for (int t = 0; t < n_tris; ++t) {
    V3 a = pts[tris[3 * t]], b = pts[tris[3 * t + 1]], c = pts[tris[3 * t + 2]];
    V3 tl = {std::min({a.x, b.x, c.x}), std::min({a.y, b.y, c.y}), std::min({a.z, b.z, c.z})};
    V3 th = {std::max({a.x, b.x, c.x}), std::max({a.y, b.y, c.y}), std::max({a.z, b.z, c.z})};
    int x0 = std::max(0, (int)((tl.x - origin.x) / vox));
    int y0 = std::max(0, (int)((tl.y - origin.y) / vox));
    int z0 = std::max(0, (int)((tl.z - origin.z) / vox));
    int x1 = std::min(dims[0] - 1, (int)((th.x - origin.x) / vox) + 1);
    int y1 = std::min(dims[1] - 1, (int)((th.y - origin.y) / vox) + 1);
    int z1 = std::min(dims[2] - 1, (int)((th.z - origin.z) / vox) + 1);
    for (int z = z0; z <= z1; ++z)
      for (int y = y0; y <= y1; ++y)
        for (int x = x0; x <= x1; ++x) {
          if (grid[idx(x, y, z)]) continue;
          V3 bc = origin + V3((x + 0.5) * vox, (y + 0.5) * vox, (z + 0.5) * vox);
          if (triBoxOverlap(bc, half, a, b, c)) grid[idx(x, y, z)] = 1;
        }
  }

  // outside flood fill from the border (0=unknown, 1=surface, 2=outside)
  std::queue<std::array<int, 3>> q;
  auto push = [&](int x, int y, int z) {
    if (x < 0 || y < 0 || z < 0 || x >= dims[0] || y >= dims[1] || z >= dims[2]) return;
    size_t i = idx(x, y, z);
    if (grid[i] == 0) {
      grid[i] = 2;
      q.push({x, y, z});
    }
  };
  for (int z = 0; z < dims[2]; ++z)
    for (int y = 0; y < dims[1]; ++y) {
      push(0, y, z);
      push(dims[0] - 1, y, z);
    }
  for (int z = 0; z < dims[2]; ++z)
    for (int x = 0; x < dims[0]; ++x) {
      push(x, 0, z);
      push(x, dims[1] - 1, z);
    }
  for (int y = 0; y < dims[1]; ++y)
    for (int x = 0; x < dims[0]; ++x) {
      push(x, y, 0);
      push(x, y, dims[2] - 1);
    }
  while (!q.empty()) {
    auto [x, y, z] = q.front();
    q.pop();
    push(x - 1, y, z); push(x + 1, y, z);
    push(x, y - 1, z); push(x, y + 1, z);
    push(x, y, z - 1); push(x, y, z + 1);
  }

  // interior+surface voxel centers
  std::vector<V3> solid;
  for (int z = 0; z < dims[2]; ++z)
    for (int y = 0; y < dims[1]; ++y)
      for (int x = 0; x < dims[0]; ++x)
        if (grid[idx(x, y, z)] != 2)
          solid.push_back(origin + V3((x + 0.5) * vox, (y + 0.5) * vox, (z + 0.5) * vox));

  const double voxVol = vox * vox * vox;
  const double relThreshold = std::max(0.04, 20.0 * (double)concavity);

  double solidVol = solid.size() * voxVol;
  if (singleVol > 1e-12 &&
      (singleVol - solidVol) / singleVol <= relThreshold) {
    emit(single, 0);
    return 1;  // single-hull shortcut (reference src/mesh.cpp:424-429)
  }

  // recursive splitting
  struct Part { std::vector<V3> pts; int depth; };
  std::vector<Part> stack{{solid, 0}};
  std::vector<std::vector<V3>> parts;
  int maxDepth = (int)std::ceil(std::log2(std::max(max_hulls, 2)));
  while (!stack.empty()) {
    Part part = std::move(stack.back());
    stack.pop_back();
    bool leaf = true;
    if ((int)part.pts.size() >= 8 && part.depth < maxDepth) {
      Hull h;
      if (buildHull(part.pts, h)) {
        double vol; V3 com; double I[9];
        massProperties(h, &vol, &com, I);
        double pvol = part.pts.size() * voxVol;
        double conc = vol > 1e-12 ? std::max(0.0, (vol - pvol) / vol) : 0.0;
        if (conc > relThreshold) leaf = false;
      }
    }
    if (leaf) {
      parts.push_back(std::move(part.pts));
      continue;
    }
    // split along the largest extent at the median
    V3 plo = part.pts[0], phi = part.pts[0];
    for (auto& p : part.pts) {
      plo = {std::min(plo.x, p.x), std::min(plo.y, p.y), std::min(plo.z, p.z)};
      phi = {std::max(phi.x, p.x), std::max(phi.y, p.y), std::max(phi.z, p.z)};
    }
    V3 pext = phi - plo;
    int axis = pext.x >= pext.y && pext.x >= pext.z ? 0 : (pext.y >= pext.z ? 1 : 2);
    auto get = [&](const V3& p) { return axis == 0 ? p.x : (axis == 1 ? p.y : p.z); };
    std::vector<double> coords;
    coords.reserve(part.pts.size());
    for (auto& p : part.pts) coords.push_back(get(p));
    std::nth_element(coords.begin(), coords.begin() + coords.size() / 2, coords.end());
    double median = coords[coords.size() / 2];
    Part left{{}, part.depth + 1}, right{{}, part.depth + 1};
    for (auto& p : part.pts)
      (get(p) <= median ? left.pts : right.pts).push_back(p);
    if (left.pts.size() < 4 || right.pts.size() < 4) {
      parts.push_back(std::move(part.pts));
      continue;
    }
    stack.push_back(std::move(left));
    stack.push_back(std::move(right));
  }

  // hull each part; fall back to single hull if the decomposition is
  // not better (reference convexity >= 0.75 rule)
  std::vector<Hull> hulls;
  double decompVol = 0;
  for (auto& p : parts) {
    if ((int)hulls.size() >= max_hulls) break;
    if (p.size() < 4) continue;
    Hull h;
    if (!buildHull(p, h)) continue;
    double vol; V3 com; double I[9];
    massProperties(h, &vol, &com, I);
    decompVol += vol;
    hulls.push_back(std::move(h));
  }
  if (hulls.empty() || decompVol / std::max(singleVol, 1e-12) >= 0.75) {
    emit(single, 0);
    return 1;
  }
  for (int i = 0; i < (int)hulls.size(); ++i) emit(hulls[i], i);
  return (int)hulls.size();
}

// Convenience: single convex hull only.
int sl_convex_hull(const float* verts, int n_verts, int max_hull_verts,
                   int max_hull_planes, float* out_verts, int* out_vert_count,
                   float* out_planes, int* out_plane_count, float* out_volume,
                   float* out_com, float* out_inertia) {
  int vc[1];
  int pc[1];
  int n = sl_decompose(verts, n_verts, nullptr, 0, 1.0f, 1, 16, 1,
                       max_hull_verts, max_hull_planes, out_verts, vc,
                       out_planes, pc, out_volume, out_com, out_inertia);
  // sl_decompose requires tris; inline the single-hull path instead
  if (n < 0) {
    std::vector<V3> pts(n_verts);
    for (int i = 0; i < n_verts; ++i)
      pts[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    Hull h;
    std::vector<V3> reduced = pts;
    int target = std::min((int)pts.size(), max_hull_verts);
    for (int iter = 0; iter < 12; ++iter) {
      Hull cand;
      std::vector<V3> rp = reduceVerts(pts, target);
      if (!quickhull(rp, cand)) return -1;
      std::vector<std::array<float, 4>> planes;
      facePlanes(cand, planes);
      if ((int)cand.verts.size() <= max_hull_verts &&
          (int)planes.size() <= max_hull_planes) {
        h = std::move(cand);
        break;
      }
      target = std::max(target * 3 / 4, 8);
      if (iter == 11) return -1;
    }
    int nv = (int)h.verts.size();
    for (int i = 0; i < nv; ++i) {
      out_verts[i * 3] = (float)h.verts[i].x;
      out_verts[i * 3 + 1] = (float)h.verts[i].y;
      out_verts[i * 3 + 2] = (float)h.verts[i].z;
    }
    *out_vert_count = nv;
    std::vector<std::array<float, 4>> planes;
    facePlanes(h, planes);
    int np = std::min((int)planes.size(), max_hull_planes);
    for (int i = 0; i < np; ++i)
      std::memcpy(&out_planes[i * 4], planes[i].data(), 4 * sizeof(float));
    *out_plane_count = np;
    double vol; V3 com; double I[9];
    massProperties(h, &vol, &com, I);
    *out_volume = (float)vol;
    out_com[0] = (float)com.x; out_com[1] = (float)com.y; out_com[2] = (float)com.z;
    for (int i = 0; i < 9; ++i) out_inertia[i] = (float)I[i];
    return 1;
  }
  *out_vert_count = vc[0];
  *out_plane_count = pc[0];
  return n;
}

}  // extern "C"
