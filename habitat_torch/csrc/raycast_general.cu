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
// The index kernels: one thread per ray; a block stages one chunk's 40 x C
// coefficients in shared memory, which every thread reads at the same
// address (a broadcast), and keeps its ray's features, running best t and
// winner in registers. One 4-byte shared load feeds one FMA, and an SM
// issues about one shared load per clock against four FP32 warp
// instructions, so they are bound by shared loads.
//
// The culled kernels are bound by FP32 issue instead: a test is 30 FMAs and
// ~8 other FP32 operations, 10 FMAs and a few operations more (an IEEE
// division on a hit) where the ray's line meets the triangle, against 160 B
// of coefficients per triangle, read once per block from L2 (neighbouring
// tiles list the same chunks), 40 B of features and 36 B of output per ray.
// Their design for the H100:
//   - one block of 256 threads per 1024-ray tile, 4 rays per thread (rays
//     r, r + 256, r + 512, r + 768 of the tile), so each listed chunk is
//     staged once per tile;
//   - each 16-byte broadcast load of a coefficient row (four consecutive
//     triangles) feeds 4 lanes x 4 rays = 16 FMAs; each determinant is
//     fmaf over i = 0..9 in order, as in the index kernels, and lanes are
//     visited in order with a strict <, so the first minimum wins;
//   - a ring of 2 chunk stages (2 x 40 KB at C = 256, dynamic shared
//     memory) filled with 16-byte cp.async copies: chunk k + 1 is in flight
//     while chunk k is tested, and one barrier per chunk both publishes
//     chunk k and frees the stage of chunk k - 1; invalid ids are dropped
//     from the list (one ballot per 32 slots) before any copy is issued;
//   - no attribute staging: the winner's global index stays in registers
//     and its 8 attributes are read from device memory once, at the end;
//   - 128 registers a thread, no spills, two blocks per SM.
// Every listed slot is tested (no early stop: the list's tail holds
// sentinel scores, not distances). The margin is tested term by term
// (x - y > 0 iff x > y for finite floats), which gives the hits of the min
// form: detA, unum and vnum first, and tnum is summed for a group of 4
// lanes only if the line of some ray of the warp meets one of them, so
// every result is the one the whole test gives.
//
// Numerics: no fast math, so the division is IEEE. The margin terms use
// explicitly rounded multiplies and adds (no FMA contraction); the
// determinant dots use fmaf.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat    (S, 10, 4, T)  rows (i, k): feature i of determinant k
//                             (detA, tnum, unum, vnum) for triangle t;
//                             16-byte aligned for the culled kernels
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

// ---- the culled kernels: a block per 1024-ray tile, a ring of staged chunks ----

constexpr int kRays = 4;                      // rays per thread
constexpr int kTileRays = kThreads * kRays;   // rays per block
constexpr int kStages = 2;                    // chunks in the ring

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Issue the 16-byte copies of chunk cid's 40 rows of C coefficients (row
// (i, k) of the (S, 10, 4, T) matrix, columns [cid * C, (cid + 1) * C)) into
// dst, 40 x C.
template <int kC>
__device__ __forceinline__ void issue_chunk(float* dst, const float* m_g, int C,
                                            int T, int cid) {
  const int C_ = kC ? kC : C;
  const int q = C_ / 4;
  const float* src = m_g + (size_t)cid * C_;
  for (int e = threadIdx.x; e < 40 * q; e += kThreads) {
    const int row = e / q;
    const int c4 = (e - row * q) * 4;
    cp_async16(dst + row * C_ + c4, src + (size_t)row * T + c4);
  }
}

// The determinant k (0 detA, 1 tnum, 2 unum, 3 vnum) of four consecutive
// lanes [j, j + 4) for each of the thread's rays: one 16-byte broadcast load
// of a coefficient row feeds 4 lanes x kRays rays.
template <int kC>
__device__ __forceinline__ void dots(const float* m_s, int C, int j, int k,
                                     const float (&f)[kRays][10],
                                     float (&g)[kRays][4]) {
  const int C_ = kC ? kC : C;
#pragma unroll
  for (int r = 0; r < kRays; ++r)
#pragma unroll
    for (int l = 0; l < 4; ++l) g[r][l] = 0.f;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float4 a = *reinterpret_cast<const float4*>(m_s + (4 * i + k) * C_ + j);
#pragma unroll
    for (int r = 0; r < kRays; ++r) {
      g[r][0] = fmaf(f[r][i], a.x, g[r][0]);
      g[r][1] = fmaf(f[r][i], a.y, g[r][1]);
      g[r][2] = fmaf(f[r][i], a.z, g[r][2]);
      g[r][3] = fmaf(f[r][i], a.w, g[r][3]);
    }
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
  const int slabs = (rt + kTileRays - 1) / kTileRays;
  const int tile = blockIdx.x / slabs;
  const int r0 = (blockIdx.x % slabs) * kTileRays + threadIdx.x;
  const int sid = sids[env];
  const float* m_g = tri_mat + (size_t)sid * 40 * T;
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
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    if (!load_features<kRowMajor>(feat, env, tile, nt, rt, r0 + r * kThreads, f[r])) {
#pragma unroll
      for (int i = 0; i < 10; ++i) f[r][i] = 0.f;  // inactive: computed, never written
    }
    best_t[r] = kTMax;
    best_i[r] = -1;
  }
  __syncthreads();
  const int n = n_list;

  // the ring: chunk k sits in stage k % kStages; the copy of chunk
  // k + kStages - 1 is in flight while chunk k is tested
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue_chunk<kC>(smem + s * 40 * C_, m_g, C_, T, list[s]);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    cp_async_wait<kStages - 2>();
    // chunk k has landed for every thread, and chunk k - 1 is consumed
    __syncthreads();
    const int kn = k + kStages - 1;
    if (kn < n) issue_chunk<kC>(smem + (kn % kStages) * 40 * C_, m_g, C_, T, list[kn]);
    cp_async_commit();
    const float* m_s = smem + (k % kStages) * 40 * C_;
    const int base = list[k] * C_;
    for (int j = 0; j < C_; j += 4) {
      // the split margin of is_hit<true> term by term: x - y >= 0 iff
      // x >= y, and x - y > 0 iff x > y, for finite floats
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
      // tnum is summed only where the line of some ray of the warp meets a triangle
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
  return (kStages * 40 * C + k_max) * (int)sizeof(float);
}

template <bool kRowMajor>
int launch_culled(const void* tri_mat, const void* tri_attr,
                  const void* chunk_ids, const void* sids, const void* feat,
                  void* t_out, void* attr_out, int n_env, int T, int C,
                  int nt, int k_max, int rt, void* stream) {
  if (C <= 0 || C % 4 != 0 || T % C != 0 || rt <= 0 || k_max < 0 ||
      (uintptr_t)tri_mat % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = culled_smem(C, k_max);
  const void* kernel = culled_kernel<kRowMajor>(C);
  const int err = launch_config(kernel, smem);
  if (err) return err;
  const dim3 grid(nt * ((rt + kTileRays - 1) / kTileRays), n_env);
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

// The culled kernels' design at chunk size C and list length k_max: out =
// {rays per thread, rays per block, rays per warp, ring stages, registers
// per thread, local (spilled) bytes per thread, static shared bytes,
// dynamic shared bytes, blocks per SM}.
int raycast_culled_design(int row_major, int C, int k_max, int* out) {
  const void* kernel = row_major ? culled_kernel<true>(C) : culled_kernel<false>(C);
  const int smem = culled_smem(C, k_max);
  int err = launch_config(kernel, smem);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  if (err) return err;
  const int v[9] = {kRays, kTileRays, 32 * kRays, kStages, attr.numRegs,
                    (int)attr.localSizeBytes, (int)attr.sharedSizeBytes, smem, blocks};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
