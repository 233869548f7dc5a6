// Closest-hit ray casting of the general render route (any camera model,
// any image size) and of the ray-batch entry points, for sm_90a.
//
// Replaces the TPU kernels of habitat_tpu/ops/raycast_pallas.py:
//   raycast_index     <- raycast_pallas_index_t / _kernel_t: every chunk of
//                        min(128, T) triangles of the env's scene, in order,
//                        from transposed ray features
//   raycast_index_rm  <- raycast_pallas_index / _kernel (the v3 kernel under
//                        raycast_pallas_batch): the same from row-major ray
//                        features, with the split hit margin
//   raycast_culled    <- raycast_pallas_culled_t / _culled_kernel_t: each
//                        (env, ray tile)'s K candidate chunks in the order
//                        given, with the winner's 8 attributes, transposed
//   raycast_culled_rm <- raycast_pallas_culled / _culled_kernel (v3): the
//                        same from row-major features and attribute rows
// One index kernel and one culled kernel, templated on the feature layout
// (and the index kernel on the margin); each TPU kernel keeps its own
// exported function.
//
// Ray features F = [d, o, o x d, 1] are precomputed, since rays of a
// non-pinhole camera are not bilinear in a camera-frame grid: transposed
// feat_t (N, nt, 16, rt) (rows 10:16 padding) or row-major feat (N, R, 10)
// (40 B per ray, read as ten consecutive floats). For every triangle of every
// visited chunk, the four Möller–Trumbore determinants G = M_chunk^T F (dot
// products of length 10) and, with aa = detA^2, p = u*detA, q = v*detA,
// w = tnum*detA:
//   fused margin (raycast_index):
//           hit iff min(min(p, q), aa - p - q, w - TMIN*aa, aa - EPS^2) >= 0
//   split margin (raycast_index_rm and both culled kernels):
//           hit iff min(min(p, q), aa - p - q) >= 0 and
//                   min(w - TMIN*aa, aa - EPS^2) > 0 (strict on the t/det side)
// A hit has t = tnum / detA. Chunks are visited in order (ascending, or the
// list's order) and triangles in lane order with a strict < throughout,
// which is the TPU kernels' argmin-first within a chunk and strict < across
// chunks. index: a miss (best t >= 5e5) gives t = 1e6, idx = -1. culled: a
// ray that no candidate hits keeps t = 1e6 and all-zero attributes
// (attribute 7, "valid", is 0).
//
// The culled kernels take the chunk size C as given for their chunk ids:
// the general route passes the pack's own chunk size T / NC (the unit of
// select_chunks_occluded's ids), the ray-batch entry point its tri_chunk.
//
// Both are ring kernels (closest_hit_ring.cuh): one block of 256 threads
// per 1024-ray slab, 4 rays per thread, a 2-stage cp.async ring of chunks,
// 16-byte broadcast loads that feed 16 FMAs, the margin term by term and
// tnum only where a ray's line meets a triangle. They are bound by FP32
// issue: a test is 30 FMAs and ~8 other FP32 operations, 10 FMAs more where
// the ray's line meets the triangle, against 160 B of coefficients per
// triangle read once per block from L2, 40 B of features and 8-36 B of
// output per ray. The index kernels walk every chunk of the scene (one
// chunk on the bench scenes, 34 on the mid-size one) with walk_chunks; the
// culled kernels walk each tile's list with the same ring and test written
// out in the kernel (see there), drop invalid ids from the list (one
// ballot per 32 slots) before any copy is issued, and stage no attributes:
// the winner's global index stays in registers and its 8 attributes are
// read from device memory once, at the end. Every listed slot is tested
// (no early stop: the list's tail holds sentinel scores, not distances).
//
// Numerics: see closest_hit_ring.cuh.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat    (S, 10, 4, T)  rows (i, k): feature i of determinant k
//                             (detA, tnum, unum, vnum) for triangle t;
//                             16-byte aligned, T % 4 == 0
//   tri_attr_t (S, 8, T)      attribute columns (culled)
//   tri_attr   (S, T, 8)      attribute rows (culled_rm)
//   sids       (N,)           int32 scene per env
//   chunk_ids  (N, nt, K)     int32 candidate chunk ids (culled)
//   feat_t     (N, nt, 16, rt) | feat (N, R, 10), R = nt * rt
//   index:     t_out (N, R), idx_out (N, R) int32
//   culled:    t_out (N, R), attr_out (N, 8, R) | culled_rm: (N, R, 8)

#include "closest_hit_ring.cuh"

namespace {

constexpr int kAttr = 8;

// The thread's kRays rays of the slab at r0 (ray r0 + r * kThreads),
// transposed (N, nt, 16, rt) or row-major (N, nt*rt, 10) features; rays
// past rt (the ragged slab of an untiled image) get zero features, which
// never pass the margin. Also resets the running winners.
template <bool kRowMajor>
__device__ __forceinline__ void load_rays(const float* feat, int env, int tile, int nt, int rt, int r0,
                                          float (&f)[kRays][10], float (&best_t)[kRays],
                                          int (&best_i)[kRays]) {
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = r0 + r * kThreads;
    if (ray >= rt) {
#pragma unroll
      for (int i = 0; i < 10; ++i) f[r][i] = 0.f;
    } else if (kRowMajor) {
      const float* src = feat + ((size_t)env * nt * rt + (size_t)tile * rt + ray) * 10;
#pragma unroll
      for (int i = 0; i < 10; ++i) f[r][i] = src[i];
    } else {
      const float* src = feat + ((size_t)(env * nt + tile) * 16) * rt + ray;
#pragma unroll
      for (int i = 0; i < 10; ++i) f[r][i] = src[(size_t)i * rt];
    }
    best_t[r] = kTMax;
    best_i[r] = -1;
  }
}

// Every chunk of C triangles of the env's scene, in order. kC: the chunk
// size, or 0 for the C argument.
template <bool kRowMajor, bool kSplit, int kC>
__global__ void __launch_bounds__(kThreads, 2) index_raycast_kernel(
    const float* __restrict__ tri_mat, const int* __restrict__ sids,
    const float* __restrict__ feat, float* __restrict__ t_out,
    int* __restrict__ idx_out, int T, int C, int nt, int rt) {
  extern __shared__ __align__(16) float smem[];  // kStages x 40 x C
  const int C_ = kC ? kC : C;
  const int env = blockIdx.y;
  const int slabs = (rt + kBlockRays - 1) / kBlockRays;
  const int tile = blockIdx.x / slabs;
  const int r0 = (blockIdx.x % slabs) * kBlockRays + threadIdx.x;
  float f[kRays][10];
  float best_t[kRays];
  int best_i[kRays];
  load_rays<kRowMajor>(feat, env, tile, nt, rt, r0, f, best_t, best_i);
  walk_chunks<false, kSplit, kC>(smem, tri_mat + (size_t)sids[env] * 40 * T, C_, T, nullptr, T / C_, f,
                                 best_t, best_i);
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray = r0 + r * kThreads;
    if (ray >= rt) continue;
    const size_t out = (size_t)env * nt * rt + (size_t)tile * rt + ray;
    const bool miss = best_t[r] >= kTMax * 0.5f;
    t_out[out] = miss ? kTMax : best_t[r];
    idx_out[out] = miss ? -1 : best_i[r];
  }
}

// kRowMajor: row-major features, attribute rows (S, T, 8) and output
// (N, R, 8); else transposed features, attribute columns (S, 8, T) and
// output (N, 8, R). kC: the chunk size, or 0 for the C argument.
template <bool kRowMajor, int kC>
__global__ void __launch_bounds__(kThreads, 2) culled_raycast_kernel(
    const float* __restrict__ tri_mat, const float* __restrict__ tri_attr,
    const int* __restrict__ chunk_ids, const int* __restrict__ sids,
    const float* __restrict__ feat, float* __restrict__ t_out,
    float* __restrict__ attr_out, int T, int C, int nt, int k_max, int rt) {
  extern __shared__ __align__(16) float smem[];  // kStages x 40 x C, then the list
  const int C_ = kC ? kC : C;
  int* list = reinterpret_cast<int*>(smem + kStages * 40 * C_);
  __shared__ int n_list;
  const int env = blockIdx.y;
  const int slabs = (rt + kBlockRays - 1) / kBlockRays;
  const int tile = blockIdx.x / slabs;
  const int r0 = (blockIdx.x % slabs) * kBlockRays + threadIdx.x;
  const int sid = sids[env];
  const int n_chunks = T / C_;

  // the tile's valid ids, in list order (warp 0; one ballot per 32 slots)
  if (threadIdx.x < 32) {
    const int* ids = chunk_ids + (size_t)(env * nt + tile) * k_max;
    const unsigned below = (1u << threadIdx.x) - 1u;
    int n = 0;
    for (int k0 = 0; k0 < k_max; k0 += 32) {
      const int k = k0 + threadIdx.x;
      const int cid = k < k_max ? ids[k] : -1;
      const bool ok = cid >= 0 && cid < n_chunks;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) list[n + __popc(m & below)] = cid;
      n += __popc(m);
    }
    if (threadIdx.x == 0) n_list = n;
  }

  float f[kRays][10];
  float best_t[kRays];
  int best_i[kRays];
  load_rays<kRowMajor>(feat, env, tile, nt, rt, r0, f, best_t, best_i);
  __syncthreads();
  // The ring of walk_chunks and the test of test_lanes, written out here
  // with the vote on p, q and aa - p - q only (aa - EPS^2 is tested on the
  // t side: a tile's list holds scan-pack chunks, with almost no zero
  // padding). Through the shared functions this kernel measured 4-6% slower
  // on an H100 with the same arithmetic (scripts/ab_ring_kernels.py, scan
  // equirect reset: 69.4-71.0 ms against 66.3-67.0).
  const int n = n_list;
  const float* m_g = tri_mat + (size_t)sid * 40 * T;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue_chunk<false, kC>(smem + s * 40 * C_, m_g, C_, T, list[s]);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    cp_async_wait<kStages - 2>();
    // chunk k has landed for every thread, and chunk k - 1 is consumed
    __syncthreads();
    const int kn = k + kStages - 1;
    if (kn < n) issue_chunk<false, kC>(smem + (kn % kStages) * 40 * C_, m_g, C_, T, list[kn]);
    cp_async_commit();
    const float* m_s = smem + (k % kStages) * 40 * C_;
    const int base = list[k] * C_;
    for (int j = 0; j < C_; j += 4) {
      float det[kRays][4], p[kRays][4], g[kRays][4];
      unsigned inside = 0;  // bit 4r + l: p, q and aa - p - q pass
      dots<kC>(m_s, C_, j, 0, f, det);
      dots<kC>(m_s, C_, j, 2, f, g);  // unum
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) p[r][l] = __fmul_rn(g[r][l], det[r][l]);
      dots<kC>(m_s, C_, j, 3, f, g);  // vnum
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const float aa = __fmul_rn(det[r][l], det[r][l]);
          const float q = __fmul_rn(g[r][l], det[r][l]);
          if (p[r][l] >= 0.f && q >= 0.f && __fsub_rn(aa, p[r][l]) >= q) inside |= 1u << (4 * r + l);
        }
      if (!__any_sync(0xffffffffu, inside != 0)) continue;
      dots<kC>(m_s, C_, j, 1, f, g);  // tnum
#pragma unroll
      for (int r = 0; r < kRays; ++r)
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const float aa = __fmul_rn(det[r][l], det[r][l]);
          const float w = __fmul_rn(g[r][l], det[r][l]);
          if ((inside >> (4 * r + l) & 1u) && w > __fmul_rn(kTMin, aa) && aa > kEps2) {
            const float t = g[r][l] / det[r][l];
            if (t < best_t[r]) {
              best_t[r] = t;
              best_i[r] = base + j + l;
            }
          }
        }
    }
  }
  cp_async_wait<0>();

  // the winner's 8 attributes, gathered once; a miss writes zeros
  const size_t R = (size_t)nt * rt;
  const float* a_g = tri_attr + (size_t)sid * kAttr * T;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int ray_in_tile = r0 + r * kThreads;
    if (ray_in_tile >= rt) continue;
    const size_t ray = (size_t)tile * rt + ray_in_tile;
    t_out[(size_t)env * R + ray] = best_t[r];
    const int w = best_i[r];
#pragma unroll
    for (int a = 0; a < kAttr; ++a) {
      float v = 0.f;
      if (w >= 0) v = kRowMajor ? a_g[(size_t)w * kAttr + a] : a_g[(size_t)a * T + w];
      if (kRowMajor) {
        attr_out[((size_t)env * R + ray) * kAttr + a] = v;
      } else {
        attr_out[((size_t)env * kAttr + a) * R + ray] = v;
      }
    }
  }
}

// The ring's 16-byte copies need C % 4 == 0, T % C == 0 (so T % 4 == 0) and
// a 16-byte aligned matrix.
bool ring_layout_ok(const void* tri_mat, int T, int C) {
  return C > 0 && C % 4 == 0 && T % C == 0 && (uintptr_t)tri_mat % 16 == 0;
}

template <bool kRowMajor, bool kSplit>
const void* index_kernel(int C) {
  return C == 128 ? (const void*)index_raycast_kernel<kRowMajor, kSplit, 128>
                  : (const void*)index_raycast_kernel<kRowMajor, kSplit, 0>;
}

template <bool kRowMajor, bool kSplit>
int launch_index(const void* tri_mat, const void* sids, const void* feat,
                 void* t_out, void* idx_out, int n_env, int T, int C, int nt,
                 int rt, void* stream) {
  if (!ring_layout_ok(tri_mat, T, C) || rt <= 0) return (int)cudaErrorInvalidValue;
  const int smem = ring_smem(C);
  const void* kernel = index_kernel<kRowMajor, kSplit>(C);
  const int err = launch_config(kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kBlockRays - 1) / kBlockRays), n_env);
  void* args[] = {(void*)&tri_mat, (void*)&sids, (void*)&feat, (void*)&t_out,
                  (void*)&idx_out, (void*)&T, (void*)&C, (void*)&nt, (void*)&rt};
  return (int)cudaLaunchKernel(kernel, grid, dim3(kThreads), args, smem,
                               (cudaStream_t)stream);
}

template <bool kRowMajor>
const void* culled_kernel(int C) {
  switch (C) {
    case 128:
      return (const void*)culled_raycast_kernel<kRowMajor, 128>;
    case 256:
      return (const void*)culled_raycast_kernel<kRowMajor, 256>;
    default:
      return (const void*)culled_raycast_kernel<kRowMajor, 0>;
  }
}

int culled_smem(int C, int k_max) {
  return ring_smem(C) + k_max * (int)sizeof(int);
}

template <bool kRowMajor>
int launch_culled(const void* tri_mat, const void* tri_attr,
                  const void* chunk_ids, const void* sids, const void* feat,
                  void* t_out, void* attr_out, int n_env, int T, int C,
                  int nt, int k_max, int rt, void* stream) {
  if (!ring_layout_ok(tri_mat, T, C) || rt <= 0 || k_max < 0) return (int)cudaErrorInvalidValue;
  const int smem = culled_smem(C, k_max);
  const void* kernel = culled_kernel<kRowMajor>(C);
  const int err = launch_config(kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kBlockRays - 1) / kBlockRays), n_env);
  void* args[] = {(void*)&tri_mat, (void*)&tri_attr, (void*)&chunk_ids,
                  (void*)&sids, (void*)&feat, (void*)&t_out, (void*)&attr_out,
                  (void*)&T, (void*)&C, (void*)&nt, (void*)&k_max, (void*)&rt};
  return (int)cudaLaunchKernel(kernel, grid, dim3(kThreads), args, smem,
                               (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Every chunk of C triangles of the env's scene, in order; T % C == 0;
// transposed features, fused margin.
int raycast_index(const void* tri_mat, const void* sids, const void* feat_t,
                  void* t_out, void* idx_out, int n_env, int T, int C, int nt,
                  int rt, void* stream) {
  return launch_index<false, false>(tri_mat, sids, feat_t, t_out, idx_out,
                                    n_env, T, C, nt, rt, stream);
}

// The same from row-major features (N, R, 10), split margin. The rays of an
// env are one slab of R: the TPU kernel's ray tiles change no value.
int raycast_index_rm(const void* tri_mat, const void* sids, const void* feat,
                     void* t_out, void* idx_out, int n_env, int T, int C,
                     int R, void* stream) {
  return launch_index<true, true>(tri_mat, sids, feat, t_out, idx_out, n_env,
                                  T, C, 1, R, stream);
}

// Each (env, tile)'s k_max listed chunks of C triangles, in list order;
// transposed features and attribute columns.
int raycast_culled(const void* tri_mat, const void* tri_attr_t,
                   const void* chunk_ids, const void* sids, const void* feat_t,
                   void* t_out, void* attr_out, int n_env, int T, int C,
                   int nt, int k_max, int rt, void* stream) {
  return launch_culled<false>(tri_mat, tri_attr_t, chunk_ids, sids, feat_t,
                              t_out, attr_out, n_env, T, C, nt, k_max, rt,
                              stream);
}

// The same from row-major features (N, R, 10) and attribute rows (S, T, 8),
// writing attribute rows (N, R, 8).
int raycast_culled_rm(const void* tri_mat, const void* tri_attr,
                      const void* chunk_ids, const void* sids,
                      const void* feat, void* t_out, void* attr_out,
                      int n_env, int T, int C, int nt, int k_max, int rt,
                      void* stream) {
  return launch_culled<true>(tri_mat, tri_attr, chunk_ids, sids, feat, t_out,
                             attr_out, n_env, T, C, nt, k_max, rt, stream);
}

// The index kernels' design at chunk size C (row_major: raycast_index_rm's),
// as ring_design reports it.
int raycast_index_design(int row_major, int C, int* out) {
  const void* kernel = row_major ? index_kernel<true, true>(C) : index_kernel<false, false>(C);
  return ring_design(kernel, ring_smem(C), out);
}

// The culled kernels' design at chunk size C and list length k_max.
int raycast_culled_design(int row_major, int C, int k_max, int* out) {
  const void* kernel = row_major ? culled_kernel<true>(C) : culled_kernel<false>(C);
  return ring_design(kernel, culled_smem(C, k_max), out);
}

}  // extern "C"
