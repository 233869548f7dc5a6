// Native host-side data pipeline for habitat_torch (a copy of the JAX
// package's habitat_native.cpp; the port keeps its own).
//
// Counterpart of habitat-sim's C++ Recast/Detour navmesh build + pathfinder
// precompute (SURVEY §2.9): the engine consumes precomputed occupancy
// grids and geodesic distance fields; this module produces them at asset-load
// time at C++ speed (numpy equivalents are ~20-100x slower on large scan
// meshes).
//
// Exposed C ABI (ctypes):
//   geodesic_field:       exact Dijkstra (binary heap) over the 16-connected
//                         navgrid — replaces the chamfer-sweep iteration.
//   rasterize_triangles:  conservative xz rasterization of floor/obstacle
//                         triangles into the occupancy masks.
//
// Build: habitat_torch/native/__init__.py runs g++ at first use into
// habitat_torch/build/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

static const float INF_DIST = 1e6f;

// 16-neighborhood (dx, dz, cost-in-cells)
static const int NOFF[16][2] = {
    {1, 0},  {-1, 0}, {0, 1},  {0, -1}, {1, 1},   {1, -1}, {-1, 1}, {-1, -1},
    {2, 1},  {2, -1}, {-2, 1}, {-2, -1}, {1, 2},  {1, -2}, {-1, 2}, {-1, -2}};
static const float NCOST[16] = {
    1.f, 1.f, 1.f, 1.f,
    1.41421356f, 1.41421356f, 1.41421356f, 1.41421356f,
    2.23606798f, 2.23606798f, 2.23606798f, 2.23606798f,
    2.23606798f, 2.23606798f, 2.23606798f, 2.23606798f};

// Exact multi-source Dijkstra over the navgrid.
// occ: (nx*nz) uint8, 1 = navigable. sources: (n_src*2) int64 cell indices.
// out: (nx*nz) float32 distances in meters (INF_DIST where unreachable).
void geodesic_field(const uint8_t* occ, int64_t nx, int64_t nz,
                    const int64_t* sources, int64_t n_src, float res,
                    float* out) {
  const int64_t n = nx * nz;
  for (int64_t i = 0; i < n; ++i) out[i] = INF_DIST;

  using QE = std::pair<float, int64_t>;  // (dist, cell)
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> heap;

  for (int64_t s = 0; s < n_src; ++s) {
    int64_t i = sources[2 * s], k = sources[2 * s + 1];
    if (i < 0 || i >= nx || k < 0 || k >= nz) continue;
    int64_t c = i * nz + k;
    if (out[c] > 0.f) {
      out[c] = 0.f;
      heap.emplace(0.f, c);
    }
  }

  while (!heap.empty()) {
    auto [d, c] = heap.top();
    heap.pop();
    if (d > out[c]) continue;  // stale entry
    int64_t ci = c / nz, ck = c % nz;
    for (int m = 0; m < 16; ++m) {
      int64_t ni = ci + NOFF[m][0], nk = ck + NOFF[m][1];
      if (ni < 0 || ni >= nx || nk < 0 || nk >= nz) continue;
      int64_t nc = ni * nz + nk;
      if (!occ[nc]) continue;
      float nd = d + NCOST[m] * res;
      if (nd < out[nc]) {
        out[nc] = nd;
        heap.emplace(nd, nc);
      }
    }
  }
}

// Conservative rasterization of triangles (xz projection) into a mask.
// tri_xz: (n_tris * 3 * 2) float32; mask: (nx*nz) uint8 OR-accumulated.
// tol: inflation distance in meters (cell-diagonal tolerance).
void rasterize_triangles(const float* tri_xz, int64_t n_tris, float lo_x,
                         float lo_z, float res, int64_t nx, int64_t nz,
                         float tol, uint8_t* mask) {
  for (int64_t t = 0; t < n_tris; ++t) {
    const float* v = tri_xz + t * 6;
    float minx = std::min({v[0], v[2], v[4]}) - tol;
    float maxx = std::max({v[0], v[2], v[4]}) + tol;
    float minz = std::min({v[1], v[3], v[5]}) - tol;
    float maxz = std::max({v[1], v[3], v[5]}) + tol;
    int64_t i0 = std::max<int64_t>(0, (int64_t)std::floor((minx - lo_x) / res));
    int64_t i1 = std::min<int64_t>(nx - 1, (int64_t)std::ceil((maxx - lo_x) / res));
    int64_t k0 = std::max<int64_t>(0, (int64_t)std::floor((minz - lo_z) / res));
    int64_t k1 = std::min<int64_t>(nz - 1, (int64_t)std::ceil((maxz - lo_z) / res));
    if (i1 < i0 || k1 < k0) continue;

    // edge functions (orientation agnostic: inside if all >= -tol*|e| or all
    // <= tol*|e|)
    float ex[3], ez[3], px[3], pz[3], el[3];
    for (int a = 0; a < 3; ++a) {
      int b = (a + 1) % 3;
      px[a] = v[2 * a];
      pz[a] = v[2 * a + 1];
      ex[a] = v[2 * b] - v[2 * a];
      ez[a] = v[2 * b + 1] - v[2 * a + 1];
      el[a] = std::sqrt(ex[a] * ex[a] + ez[a] * ez[a]) + 1e-12f;
    }
    for (int64_t i = i0; i <= i1; ++i) {
      float cx = lo_x + i * res;
      for (int64_t k = k0; k <= k1; ++k) {
        float cz = lo_z + k * res;
        bool pos = true, neg = true;
        for (int a = 0; a < 3; ++a) {
          float d = ((cx - px[a]) * ez[a] - (cz - pz[a]) * ex[a]) / el[a];
          pos &= (d <= tol);
          neg &= (d >= -tol);
        }
        if (pos || neg) mask[i * nz + k] = 1;
      }
    }
  }
}

}  // extern "C"
