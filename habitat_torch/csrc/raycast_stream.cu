// Closest-hit ray casting over a nearest-first list of culled chunks, one
// thread per ray, with an exact early stop, for sm_90a.
//
// Replaces the TPU kernels of habitat_tpu/ops/raycast_pallas.py:
//   C = 32        <- raycast_pallas_exactsel_t / _exactsel_kernel_t
//                    (the exact-culled 32-triangle chunklets of a 32x32-pixel
//                    tile, from select_chunklets_exact)
//   C = 128, 256  <- raycast_pallas_stream_t / _stream_kernel_t
//                    (parent chunks from select_chunks_occluded, or any
//                    nearest-first chunk list such as an all-chunks oracle)
// Both are one kernel, templated on the chunk size.
//
// What it computes, per (env, ray): the ray features F (10) = B[env]^T [d,1];
// then, for the tile's listed chunks in list order, the four Möller–Trumbore
// determinants G = M_chunk^T F of every triangle and the sign-free margin
//   min(min(p, q), aa - p - q, w - TMIN*aa, aa - EPS^2) >= 0
// with aa = detA^2, p = u*detA, q = v*detA, w = tnum*detA; a hit has
// t = tnum / detA. Strict < across chunks and lanes keeps the first minimum.
// Misses give t = 1e6, idx = -1; idx = chunk id * C + lane is a global
// triangle index.
//
// Each list slot packs (dmin_cm << 18) | chunk id: dmin is the least distance
// at which any ray from the camera can meet the chunk's bounds, floored to
// centimetres, and the list ascends in it. Once every ray of a block holds a
// hit nearer than the next slot's dmin, no later chunk can improve any of
// them and the block stops (one __syncthreads_or per chunk, which is also
// the barrier that frees the staging buffer). A warp whose 32 rays are all
// already nearer than dmin skips the chunk's arithmetic; it still helps to
// stage. Both skips leave the result as if every listed chunk were tested,
// except for a hit whose float32 t lands below its own chunk's floored dmin.
// Slots at or beyond cnt[env, tile] are padding and are not read.
//
// What bounds it on an H100: arithmetic. A ray-triangle test is 40 FMAs and
// ~15 other FP32 operations; the bytes are small beside it (160 B of
// coefficients per triangle, staged once per block and chunk into shared
// memory, mostly from L2 since neighbouring tiles list the same chunks). The
// design keeps the ray's features and winner in registers and reads the
// coefficients of four triangles at a time as one 16-byte shared-memory
// broadcast, so that a shared-memory load feeds four FMAs. Where the TPU
// kernel keeps a ring of DMA'd chunks in flight, this one lets the other
// resident blocks of the SM (four to eight at 256 threads) cover a block's
// staging latency. A block is a 256-ray slice of a tile, so the early stop
// acts on 8 pixel rows of 32.
//
// Numerics: no fast math, IEEE division. F and the margin use explicitly
// rounded multiplies and adds (no FMA contraction), as the plain PyTorch
// version computes them; the determinant dots use fmaf.
//
// Layouts (row-major, float32 unless noted):
//   tri_mat_c (S, 10, 4T)   chunk c in columns [c*4C, (c+1)*4C) as
//                           [detA(C) | tnum(C) | unum(C) | vnum(C)]
//   sids      (N,)          int32 scene per env
//   chunk_ids (N, nt, K)    int32 packed slots, survivors first
//   cnt       (N, nt)       int32 survivors per (env, tile)
//   d_t       (nt, 8, Rt)   rows 0:4 are the camera-frame [d, 1] of the tile
//   bt        (N, 16, 4)    rows 0:10 are B^T
//   t_out     (N, nt*Rt)    idx_out (N, nt*Rt) int32

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kTMax = 1e6f;
constexpr float kTMin = 1e-3f;
constexpr float kEps2 = 1e-14f;  // (1e-7)^2
constexpr int kThreads = 256;
constexpr int kIdMask = (1 << 18) - 1;

template <int C>
__global__ void __launch_bounds__(kThreads) stream_raycast_kernel(
    const float* __restrict__ tri_mat_c, const int* __restrict__ sids,
    const int* __restrict__ chunk_ids, const int* __restrict__ cnt,
    const float* __restrict__ d_t, const float* __restrict__ bt,
    float* __restrict__ t_out, int* __restrict__ idx_out,
    int t4, int nt, int k_max, int rt) {
  __shared__ __align__(16) float m_s[10 * 4 * C];
  const int env = blockIdx.y;
  const int slices = rt / kThreads;
  const int tile = blockIdx.x / slices;
  const int r = (blockIdx.x % slices) * kThreads + threadIdx.x;
  const int sid = sids[env];

  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = d_t[(size_t)(tile * 8 + k) * rt + r];
  float f[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const float* b = bt + ((size_t)env * 16 + i) * 4;
    float acc = __fmul_rn(b[0], d[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(b[k], d[k]));
    f[i] = acc;
  }

  const int et = env * nt + tile;
  const int n_list = min(cnt[et], k_max);
  const int* list = chunk_ids + (size_t)et * k_max;
  const float* m_g = tri_mat_c + (size_t)sid * 10 * t4;
  constexpr int kRow4 = C;  // float4 per matrix row of one chunk (4C / 4)
  float best_t = kTMax;
  int best_i = -1;
  for (int c = 0; c < n_list; ++c) {
    const int slot = list[c];
    const int cid = slot & kIdMask;
    const float dmin = __fmul_rn((float)(slot >> 18), 1e-2f);
    const bool open = best_t > dmin;
    // the previous chunk is fully consumed; stop when no ray is open
    if (!__syncthreads_or(open)) break;
    for (int e = threadIdx.x; e < 10 * kRow4; e += kThreads) {
      const int row = e / kRow4;
      const int col4 = e - row * kRow4;
      reinterpret_cast<float4*>(m_s)[e] = reinterpret_cast<const float4*>(
          m_g + (size_t)row * t4 + (size_t)cid * 4 * C)[col4];
    }
    __syncthreads();
    if (!__any_sync(0xffffffffu, open)) continue;
    for (int j = 0; j < C; j += 4) {
      float det[4] = {0.f, 0.f, 0.f, 0.f}, tn[4] = {0.f, 0.f, 0.f, 0.f};
      float un[4] = {0.f, 0.f, 0.f, 0.f}, vn[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        const float* row = m_s + i * 4 * C + j;
        const float4 a = *reinterpret_cast<const float4*>(row);
        const float4 b = *reinterpret_cast<const float4*>(row + C);
        const float4 u = *reinterpret_cast<const float4*>(row + 2 * C);
        const float4 v = *reinterpret_cast<const float4*>(row + 3 * C);
        const float fi = f[i];
        det[0] = fmaf(fi, a.x, det[0]);
        det[1] = fmaf(fi, a.y, det[1]);
        det[2] = fmaf(fi, a.z, det[2]);
        det[3] = fmaf(fi, a.w, det[3]);
        tn[0] = fmaf(fi, b.x, tn[0]);
        tn[1] = fmaf(fi, b.y, tn[1]);
        tn[2] = fmaf(fi, b.z, tn[2]);
        tn[3] = fmaf(fi, b.w, tn[3]);
        un[0] = fmaf(fi, u.x, un[0]);
        un[1] = fmaf(fi, u.y, un[1]);
        un[2] = fmaf(fi, u.z, un[2]);
        un[3] = fmaf(fi, u.w, un[3]);
        vn[0] = fmaf(fi, v.x, vn[0]);
        vn[1] = fmaf(fi, v.y, vn[1]);
        vn[2] = fmaf(fi, v.z, vn[2]);
        vn[3] = fmaf(fi, v.w, vn[3]);
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float aa = __fmul_rn(det[l], det[l]);
        const float p = __fmul_rn(un[l], det[l]);
        const float q = __fmul_rn(vn[l], det[l]);
        const float w = __fmul_rn(tn[l], det[l]);
        const float m = fminf(
            fminf(fminf(p, q), __fsub_rn(__fsub_rn(aa, p), q)),
            fminf(__fsub_rn(w, __fmul_rn(kTMin, aa)), __fsub_rn(aa, kEps2)));
        if (m >= 0.f) {
          const float t = tn[l] / det[l];
          if (t < best_t) {
            best_t = t;
            best_i = cid * C + j + l;
          }
        }
      }
    }
  }
  const size_t out = (size_t)env * nt * rt + (size_t)tile * rt + r;
  const bool miss = best_t >= kTMax * 0.5f;
  t_out[out] = miss ? kTMax : best_t;
  idx_out[out] = miss ? -1 : best_i;
}

template <int C>
int launch(const void* tri_mat_c, const void* sids, const void* chunk_ids,
           const void* cnt, const void* d_t, const void* bt, void* t_out,
           void* idx_out, int n_env, int t4, int nt, int k_max, int rt,
           void* stream) {
  const dim3 grid(nt * (rt / kThreads), n_env);
  stream_raycast_kernel<C><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tri_mat_c, (const int*)sids, (const int*)chunk_ids,
      (const int*)cnt, (const float*)d_t, (const float*)bt, (float*)t_out,
      (int*)idx_out, t4, nt, k_max, rt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Visits chunk_ids[env, tile, :cnt[env, tile]] nearest first; tri_chunk is
// 32 (exact-culled chunklets), 128 or 256 (parent chunks).
int raycast_stream(const void* tri_mat_c, const void* sids,
                   const void* chunk_ids, const void* cnt, const void* d_t,
                   const void* bt, void* t_out, void* idx_out, int n_env,
                   int t4, int nt, int k_max, int rt, int tri_chunk,
                   void* stream) {
  if (chunk_ids == nullptr || cnt == nullptr || rt % kThreads != 0 ||
      t4 % 4 != 0)
    return (int)cudaErrorInvalidValue;
  switch (tri_chunk) {
    case 32:
      return launch<32>(tri_mat_c, sids, chunk_ids, cnt, d_t, bt, t_out,
                        idx_out, n_env, t4, nt, k_max, rt, stream);
    case 128:
      return launch<128>(tri_mat_c, sids, chunk_ids, cnt, d_t, bt, t_out,
                         idx_out, n_env, t4, nt, k_max, rt, stream);
    case 256:
      return launch<256>(tri_mat_c, sids, chunk_ids, cnt, d_t, bt, t_out,
                         idx_out, n_env, t4, nt, k_max, rt, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
