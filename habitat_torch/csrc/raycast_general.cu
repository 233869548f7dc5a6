// Closest-hit ray casting of the general render route (any camera model,
// any image size) and of the ray-batch entry points, one thread per ray, for
// sm_90a.
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
// What bounds them on an H100: arithmetic. Each ray-triangle test is 40
// FMAs plus ~15 other FP32 operations, and an IEEE division on a hit, while
// the bytes are small: the scene matrix (160 B per triangle) and the
// attribute columns (32 B) are read once per block into shared memory, each
// ray reads 40 B of features and writes 8 B (index) or 36 B (culled). The
// block stages one chunk's 40 x C coefficients (and 8 x C attributes) in
// shared memory, which every thread reads at the same address (a
// broadcast), and keeps its ray's features, running best t and winner in
// registers, so the inner loop is FP32 arithmetic only. The culled kernels
// copy the winner's 8 attributes from shared memory into registers only
// when a chunk improves the ray's hit.
//
// Numerics: no fast math, so the division is IEEE. The margin terms use
// explicitly rounded multiplies and adds (no FMA contraction); the
// determinant dots use fmaf.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat    (S, 10, 4, T)  rows (i, k): feature i of determinant k
//                             (detA, tnum, unum, vnum) for triangle t
//   tri_attr_t (S, 8, T)      attribute columns (culled)
//   tri_attr   (S, T, 8)      attribute rows (culled_rm)
//   sids       (N,)           int32 scene per env
//   chunk_ids  (N, nt, K)     int32 candidate chunk ids (culled)
//   feat_t     (N, nt, 16, rt) | feat (N, R, 10), R = nt * rt
//   index:     t_out (N, R), idx_out (N, R) int32
//   culled:    t_out (N, R), attr_out (N, 8, R) | culled_rm: (N, R, 8)

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

// The hit test of one triangle: the fused margin (kSplit false) or the split
// one (kSplit true).
template <bool kSplit>
__device__ __forceinline__ bool is_hit(const Det& g) {
  const float aa = __fmul_rn(g.det, g.det);
  const float p = __fmul_rn(g.un, g.det);
  const float q = __fmul_rn(g.vn, g.det);
  const float w = __fmul_rn(g.tn, g.det);
  const float m1 = fminf(fminf(p, q), __fsub_rn(__fsub_rn(aa, p), q));
  const float m2 = fminf(__fsub_rn(w, __fmul_rn(kTMin, aa)), __fsub_rn(aa, kEps2));
  return kSplit ? (m1 >= 0.f && m2 > 0.f) : fminf(m1, m2) >= 0.f;
}

// Stage rows [0, rows) x chunk columns [c0, c0 + C) of a (rows, T) matrix.
__device__ __forceinline__ void stage(float* dst, const float* src, int rows,
                                      int C, int T, int c0) {
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int row = e / C;
    dst[e] = src[(size_t)row * T + c0 + (e - row * C)];
  }
}

// Stage rows [c0, c0 + C) of a (T, 8) attribute table as 8 columns of C.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int C,
                                           int c0) {
  for (int e = threadIdx.x; e < kAttr * C; e += kThreads) {
    const int j = e / kAttr;
    dst[(e - j * kAttr) * C + j] = src[(size_t)(c0 + j) * kAttr + e - j * kAttr];
  }
}

// The ray's features, transposed (N, nt, 16, rt) or row-major (N, nt*rt,
// 10); rays past rt (the ragged slab of an untiled image) are inactive but
// still take part in the block's barriers.
template <bool kRowMajor>
__device__ __forceinline__ bool load_features(const float* feat, int env,
                                              int tile, int nt, int rt,
                                              int r, float (&f)[10]) {
  if (r >= rt) return false;
  if (kRowMajor) {
    const float* src = feat + ((size_t)env * nt * rt + (size_t)tile * rt + r) * 10;
#pragma unroll
    for (int i = 0; i < 10; ++i) f[i] = src[i];
  } else {
    const float* src = feat + ((size_t)(env * nt + tile) * 16) * rt + r;
#pragma unroll
    for (int i = 0; i < 10; ++i) f[i] = src[(size_t)i * rt];
  }
  return true;
}

template <bool kRowMajor, bool kSplit>
__global__ void __launch_bounds__(kThreads) index_raycast_kernel(
    const float* __restrict__ tri_mat, const int* __restrict__ sids,
    const float* __restrict__ feat, float* __restrict__ t_out,
    int* __restrict__ idx_out, int T, int C, int nt, int rt) {
  extern __shared__ float m_s[];  // 40 x C
  const int env = blockIdx.y;
  const int slabs = (rt + kThreads - 1) / kThreads;
  const int tile = blockIdx.x / slabs;
  const int r = (blockIdx.x % slabs) * kThreads + threadIdx.x;
  float f[10];
  const bool active = load_features<kRowMajor>(feat, env, tile, nt, rt, r, f);
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
      if (is_hit<kSplit>(g)) {
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

// kRowMajor: row-major features, attribute rows (S, T, 8) and output
// (N, R, 8); else transposed features, attribute columns (S, 8, T) and
// output (N, 8, R).
template <bool kRowMajor>
__global__ void __launch_bounds__(kThreads) culled_raycast_kernel(
    const float* __restrict__ tri_mat, const float* __restrict__ tri_attr,
    const int* __restrict__ chunk_ids, const int* __restrict__ sids,
    const float* __restrict__ feat, float* __restrict__ t_out,
    float* __restrict__ attr_out, int T, int C, int nt, int k_max, int rt) {
  extern __shared__ float smem[];
  float* m_s = smem;           // 40 x C
  float* a_s = smem + 40 * C;  // 8 x C
  const int env = blockIdx.y;
  const int slabs = (rt + kThreads - 1) / kThreads;
  const int tile = blockIdx.x / slabs;
  const int r = (blockIdx.x % slabs) * kThreads + threadIdx.x;
  float f[10];
  const bool active = load_features<kRowMajor>(feat, env, tile, nt, rt, r, f);
  const int sid = sids[env];
  const float* m_g = tri_mat + (size_t)sid * 40 * T;
  const float* a_g = tri_attr + (size_t)sid * kAttr * T;
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
    if (kRowMajor) {
      stage_rows(a_s, a_g, C, cid * C);
    } else {
      stage(a_s, a_g, kAttr, C, T, cid * C);
    }
    __syncthreads();
    if (!active) continue;
    int win = -1;
    for (int j = 0; j < C; ++j) {
      const Det g = determinants(m_s, C, j, f);
      if (is_hit<true>(g)) {
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
  for (int a = 0; a < kAttr; ++a) {
    if (kRowMajor) {
      attr_out[((size_t)env * R + ray) * kAttr + a] = attr[a];
    } else {
      attr_out[((size_t)env * kAttr + a) * R + ray] = attr[a];
    }
  }
}

int launch_config(const void* kernel, int smem_bytes) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <bool kRowMajor, bool kSplit>
int launch_index(const void* tri_mat, const void* sids, const void* feat,
                 void* t_out, void* idx_out, int n_env, int T, int C, int nt,
                 int rt, void* stream) {
  if (C <= 0 || T % C != 0 || rt <= 0) return (int)cudaErrorInvalidValue;
  const int smem = 40 * C * (int)sizeof(float);
  const void* kernel = (const void*)index_raycast_kernel<kRowMajor, kSplit>;
  const int err = launch_config(kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kThreads - 1) / kThreads), n_env);
  index_raycast_kernel<kRowMajor, kSplit><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_mat, (const int*)sids, (const float*)feat,
      (float*)t_out, (int*)idx_out, T, C, nt, rt);
  return (int)cudaGetLastError();
}

template <bool kRowMajor>
int launch_culled(const void* tri_mat, const void* tri_attr,
                  const void* chunk_ids, const void* sids, const void* feat,
                  void* t_out, void* attr_out, int n_env, int T, int C,
                  int nt, int k_max, int rt, void* stream) {
  if (C <= 0 || T % C != 0 || rt <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (40 + kAttr) * C * (int)sizeof(float);
  const void* kernel = (const void*)culled_raycast_kernel<kRowMajor>;
  const int err = launch_config(kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kThreads - 1) / kThreads), n_env);
  culled_raycast_kernel<kRowMajor><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tri_mat, (const float*)tri_attr, (const int*)chunk_ids,
      (const int*)sids, (const float*)feat, (float*)t_out,
      (float*)attr_out, T, C, nt, k_max, rt);
  return (int)cudaGetLastError();
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

}  // extern "C"
