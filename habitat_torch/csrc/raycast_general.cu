// Closest-hit ray casting of the general render route (any camera model,
// any image size), one thread per ray, for sm_90a.
//
// Replaces the TPU kernels of habitat_tpu/ops/raycast_pallas.py:
//   raycast_index   <- raycast_pallas_index_t / _kernel_t: every chunk of
//                      min(128, T) triangles of the env's scene, in order
//   raycast_culled  <- raycast_pallas_culled_t / _culled_kernel_t: each
//                      (env, ray tile)'s K candidate chunks in the order
//                      given, with the winner's 8 attributes
//
// Both read precomputed ray features F = [d, o, o x d, 1] in the transposed
// layout features_t (N, nt, 16, rt) (rows 10:16 are padding), since rays of
// a non-pinhole camera are not bilinear in a camera-frame grid. For every
// triangle of every visited chunk, the four Möller–Trumbore determinants
// G = M_chunk^T F (dot products of length 10) and, with aa = detA^2,
// p = u*detA, q = v*detA, w = tnum*detA:
//   index:  hit iff min(min(p, q), aa - p - q, w - TMIN*aa, aa - EPS^2) >= 0
//           (the TPU kernel's fused margin)
//   culled: hit iff min(min(p, q), aa - p - q) >= 0 and
//           min(w - TMIN*aa, aa - EPS^2) > 0 (strict on the t/det side)
// A hit has t = tnum / detA. Chunks are visited in order (ascending, or the
// list's order) and triangles in lane order with a strict < throughout,
// which is the TPU kernels' argmin-first within a chunk and strict < across
// chunks. index: a miss (best t >= 5e5) gives t = 1e6, idx = -1. culled: a
// ray that no candidate hits keeps t = 1e6 and all-zero attributes
// (attribute 7, "valid", is 0).
//
// The culled kernel takes the pack's own chunk size C = T / NC (128 or 256)
// for its chunk ids: the ids of select_chunks_occluded are in units of the
// pack's chunks.
//
// What bounds them on an H100: arithmetic. Each ray-triangle test is 40
// FMAs plus ~15 other FP32 operations, and an IEEE division on a hit, while
// the bytes are small: the scene matrix (160 B per triangle) and the
// attribute columns (32 B) are read once per block into shared memory, each
// ray reads 40 B of features and writes 8 B (index) or 36 B (culled). The
// block stages one chunk's 40 x C coefficients (and 8 x C attributes) in
// shared memory, which every thread reads at the same address (a
// broadcast), and keeps its ray's features, running best t and winner in
// registers, so the inner loop is FP32 arithmetic only. The culled kernel
// copies the winner's 8 attributes from shared memory into registers only
// when a chunk improves the ray's hit.
//
// Numerics: no fast math, so the division is IEEE. The margin terms use
// explicitly rounded multiplies and adds (no FMA contraction); the
// determinant dots use fmaf.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat    (S, 10, 4, T)  rows (i, k): feature i of determinant k
//                             (detA, tnum, unum, vnum) for triangle t
//   tri_attr_t (S, 8, T)      attribute columns
//   sids       (N,)           int32 scene per env
//   chunk_ids  (N, nt, K)     int32 candidate chunk ids (culled)
//   feat_t     (N, nt, 16, rt)
//   index:  t_out (N, nt*rt), idx_out (N, nt*rt) int32
//   culled: t_out (N, nt*rt), attr_out (N, 8, nt*rt)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMax = 1e6f;
constexpr float kTMin = 1e-3f;
constexpr float kEps2 = 1e-14f;  // (1e-7)^2
constexpr int kThreads = 256;
constexpr int kAttr = 8;

struct Det {
  float det, tn, un, vn;
};

// The four determinants of lane j of the staged chunk m_s (40 rows of C).
__device__ __forceinline__ Det determinants(const float* m_s, int C, int j,
                                            const float (&f)[10]) {
  Det g{0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float* row = m_s + i * 4 * C + j;
    g.det = fmaf(f[i], row[0], g.det);
    g.tn = fmaf(f[i], row[C], g.tn);
    g.un = fmaf(f[i], row[2 * C], g.un);
    g.vn = fmaf(f[i], row[3 * C], g.vn);
  }
  return g;
}

// Stage rows [0, rows) x chunk columns [c0, c0 + C) of a (rows, T) matrix.
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int C, int T, int c0) {
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int row = e / C;
    dst[e] = src[(size_t)row * T + c0 + (e - row * C)];
  }
}

// The ray's features; rays past rt (the ragged slab of an untiled image)
// are inactive but still take part in the block's barriers.
__device__ __forceinline__ bool load_features(const float* feat_t, int env,
                                              int tile, int nt, int rt,
                                              int r, float (&f)[10]) {
  if (r >= rt) return false;
  const float* src = feat_t + ((size_t)(env * nt + tile) * 16) * rt + r;
#pragma unroll
  for (int i = 0; i < 10; ++i) f[i] = src[(size_t)i * rt];
  return true;
}

__global__ void __launch_bounds__(kThreads) index_raycast_kernel(
    const float* __restrict__ tri_mat, const int* __restrict__ sids,
    const float* __restrict__ feat_t, float* __restrict__ t_out,
    int* __restrict__ idx_out, int T, int C, int nt, int rt) {
  extern __shared__ float m_s[];  // 40 x C
  const int env = blockIdx.y;
  const int slabs = (rt + kThreads - 1) / kThreads;
  const int tile = blockIdx.x / slabs;
  const int r = (blockIdx.x % slabs) * kThreads + threadIdx.x;
  float f[10];
  const bool active = load_features(feat_t, env, tile, nt, rt, r, f);
  const float* m_g = tri_mat + (size_t)sids[env] * 40 * T;
  float best_t = kTMax;
  int best_i = -1;
  for (int c = 0; c < T / C; ++c) {
    __syncthreads();  // the previous chunk is fully consumed
    stage(m_s, m_g, 40, C, T, c * C);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < C; ++j) {
      const Det g = determinants(m_s, C, j, f);
      const float aa = __fmul_rn(g.det, g.det);
      const float p = __fmul_rn(g.un, g.det);
      const float q = __fmul_rn(g.vn, g.det);
      const float w = __fmul_rn(g.tn, g.det);
      const float m = fminf(
          fminf(fminf(p, q), __fsub_rn(__fsub_rn(aa, p), q)),
          fminf(__fsub_rn(w, __fmul_rn(kTMin, aa)), __fsub_rn(aa, kEps2)));
      if (m >= 0.f) {
        const float t = g.tn / g.det;
        if (t < best_t) {
          best_t = t;
          best_i = c * C + j;
        }
      }
    }
  }
  if (!active) return;
  const size_t out = (size_t)env * nt * rt + (size_t)tile * rt + r;
  const bool miss = best_t >= kTMax * 0.5f;
  t_out[out] = miss ? kTMax : best_t;
  idx_out[out] = miss ? -1 : best_i;
}

__global__ void __launch_bounds__(kThreads) culled_raycast_kernel(
    const float* __restrict__ tri_mat, const float* __restrict__ tri_attr_t,
    const int* __restrict__ chunk_ids, const int* __restrict__ sids,
    const float* __restrict__ feat_t, float* __restrict__ t_out,
    float* __restrict__ attr_out, int T, int C, int nt, int k_max, int rt) {
  extern __shared__ float smem[];
  float* m_s = smem;           // 40 x C
  float* a_s = smem + 40 * C;  // 8 x C
  const int env = blockIdx.y;
  const int slabs = (rt + kThreads - 1) / kThreads;
  const int tile = blockIdx.x / slabs;
  const int r = (blockIdx.x % slabs) * kThreads + threadIdx.x;
  float f[10];
  const bool active = load_features(feat_t, env, tile, nt, rt, r, f);
  const int sid = sids[env];
  const float* m_g = tri_mat + (size_t)sid * 40 * T;
  const float* a_g = tri_attr_t + (size_t)sid * kAttr * T;
  const int* ids = chunk_ids + (size_t)(env * nt + tile) * k_max;
  const int n_chunks = T / C;
  float best_t = kTMax;
  float attr[kAttr];
#pragma unroll
  for (int a = 0; a < kAttr; ++a) attr[a] = 0.f;
  for (int k = 0; k < k_max; ++k) {
    const int cid = ids[k];
    if (cid < 0 || cid >= n_chunks) continue;  // uniform across the block
    __syncthreads();  // the previous chunk is fully consumed
    stage(m_s, m_g, 40, C, T, cid * C);
    stage(a_s, a_g, kAttr, C, T, cid * C);
    __syncthreads();
    if (!active) continue;
    int win = -1;
    for (int j = 0; j < C; ++j) {
      const Det g = determinants(m_s, C, j, f);
      const float aa = __fmul_rn(g.det, g.det);
      const float p = __fmul_rn(g.un, g.det);
      const float q = __fmul_rn(g.vn, g.det);
      const float w = __fmul_rn(g.tn, g.det);
      const float m1 = fminf(fminf(p, q), __fsub_rn(__fsub_rn(aa, p), q));
      const float m2 = fminf(__fsub_rn(w, __fmul_rn(kTMin, aa)), __fsub_rn(aa, kEps2));
      if (m1 >= 0.f && m2 > 0.f) {
        const float t = g.tn / g.det;
        if (t < best_t) {
          best_t = t;
          win = j;
        }
      }
    }
    if (win >= 0) {
#pragma unroll
      for (int a = 0; a < kAttr; ++a) attr[a] = a_s[a * C + win];
    }
  }
  if (!active) return;
  const size_t R = (size_t)nt * rt;
  const size_t ray = (size_t)tile * rt + r;
  t_out[(size_t)env * R + ray] = best_t;
#pragma unroll
  for (int a = 0; a < kAttr; ++a) attr_out[((size_t)env * kAttr + a) * R + ray] = attr[a];
}

int launch_config(const void* kernel, int smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" {

// Every chunk of C triangles of the env's scene, in order; T % C == 0.
int raycast_index(const void* tri_mat, const void* sids, const void* feat_t,
                  void* t_out, void* idx_out, int n_env, int T, int C, int nt,
                  int rt, void* stream) {
  if (C <= 0 || T % C != 0 || rt <= 0) return (int)cudaErrorInvalidValue;
  const int smem = 40 * C * (int)sizeof(float);
  const int err = launch_config((const void*)index_raycast_kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kThreads - 1) / kThreads), n_env);
  index_raycast_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_mat, (const int*)sids, (const float*)feat_t,
      (float*)t_out, (int*)idx_out, T, C, nt, rt);
  return (int)cudaGetLastError();
}

// Each (env, tile)'s k_max listed chunks of C triangles, in list order.
int raycast_culled(const void* tri_mat, const void* tri_attr_t,
                   const void* chunk_ids, const void* sids, const void* feat_t,
                   void* t_out, void* attr_out, int n_env, int T, int C,
                   int nt, int k_max, int rt, void* stream) {
  if (C <= 0 || T % C != 0 || rt <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (40 + kAttr) * C * (int)sizeof(float);
  const int err = launch_config((const void*)culled_raycast_kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kThreads - 1) / kThreads), n_env);
  culled_raycast_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_mat, (const float*)tri_attr_t, (const int*)chunk_ids,
      (const int*)sids, (const float*)feat_t, (float*)t_out,
      (float*)attr_out, T, C, nt, k_max, rt);
  return (int)cudaGetLastError();
}

}  // extern "C"
