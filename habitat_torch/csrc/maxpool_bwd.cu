// Backward of the 3x3, stride-2, "SAME" max pool of the ResNet stem, with
// every tied input credited, on (N, C, H, W) tensors, for sm_90a.
//
// Replaces the TPU kernel of habitat_tpu/ops/pool.py:
//   maxpool_bwd <- max_pool_3x3s2's VJP / _bwd_kernel (pallas_call at :123)
//
// What it computes: for even H and W, XLA's SAME padding of a 3x3/2 window
// pads one row and one column at the high end only, so window (a, b) covers
// input rows 2a..2a+2 and columns 2b..2b+2, and
//   gx[h, w] = sum over the windows covering (h, w) of dy[a, b] * (x[h, w] == y[a, b]).
// Every input equal to its window's maximum gets the window's gradient (XLA
// and torch credit one of the tied inputs only).
//
// The TPU kernel works on (H, W, C, B) with the batch in lanes, splits rows
// and columns by parity and passes two row-shifted views of (y, dy), so that
// Mosaic only ever slices leading dimensions; the transposes in and out cost
// more than the kernel saved. None of that carries over.
//
// What bounds it on an H100: bytes. x and gx cross device memory once, y and
// dy (a quarter of x each) once: at the bench update's minibatch, x (4096,
// 32, 64, 64) bf16, 1.07 + 0.27 + 0.27 + 1.07 = 2.68 GB, 0.80 ms at 3.35
// TB/s, for at most 4 compares and 4 adds per element. One thread per input
// element, as before, made 2-byte accesses (a warp moved 64 bytes per memory
// instruction) and spent five divisions on its indices: it was bound by
// issuing instructions, at a fifth of the bytes' rate.
//
// The design: one thread per 2x2 input quad (rows 2a, 2a+1, columns 2b,
// 2b+1) and 16-byte channel group (8 bf16 or 4 float32 channels), walking
// kRows window rows down its column. The quad's inputs are covered by
// exactly the windows (a-1..a) x (b-1..b): a thread makes four 16-byte loads
// of x, two each of y and dy per window row (the row above is carried in
// registers from the previous step), and four 16-byte stores of gx.
// Neighbouring threads take neighbouring channel groups and columns, so a
// warp's accesses are whole 32-byte sectors; the column b-1 a thread reads
// is its neighbour's column b, served from L1, and the first window row of
// a block's strip is the previous strip's last, served from L2. x and gx
// stream (evict-first); y and dy stay cached for that reuse. The image and
// the strip come from blockIdx.x, the column and channel group from one
// division of the thread's index by the group count.
//
// Numerics: values are compared exactly in float32 (a bf16 -> float
// conversion is exact); each input's gradient is summed in float32 in a
// fixed order (window row ascending, then window column) and rounded once to
// the working type, so the plain PyTorch version (ops/pool.py, the same
// order) agrees bit for bit. A window that does not exist (row or column -1)
// reads y as NaN, which equals nothing.
//
// Layouts (float32 or bfloat16), all four tensors channels-last, the base of
// each 16-byte aligned and C a multiple of 16 bytes' worth of channels:
//   x, gx  (N, C, H, W)      as N, H, W, C in memory
//   y, dy  (N, C, H/2, W/2)  likewise

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block: (column, channel group) pairs of one strip
constexpr int kRows = 2;       // window rows per thread, walked down its column

// 16 bytes of x, y, dy or gx: 8 bf16 or 4 float32 channels
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ float get(const uint4& v, int i) {
    return __uint_as_float((&v.x)[i]);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  // bf16 k of the 16 bytes, widened exactly: its bits are a float's high half
  static __device__ __forceinline__ float get(const uint4& v, int i) {
    const unsigned w = (&v.x)[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);  // .x low, .y high
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// y of a window that does not exist: NaN in every channel of either type
__device__ __forceinline__ uint4 nan_vec() {
  return make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
}

// acc + dy where x equals the window's maximum y, for channel i
template <typename T>
__device__ __forceinline__ float credit(float acc, float xv, const uint4& y, const uint4& dy, int i) {
  return xv == Vec<T>::get(y, i) ? __fadd_rn(acc, Vec<T>::get(dy, i)) : acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) maxpool_bwd_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ y, const uint4* __restrict__ dy,
    uint4* __restrict__ gx, unsigned groups, unsigned ho, unsigned wo, unsigned strips) {
  // all indices in units of 16 bytes; the caller keeps them below 2^32
  const unsigned j = blockIdx.y * kThreads + threadIdx.x;
  if (j >= wo * groups) return;
  const unsigned b = j / groups;
  const unsigned n = blockIdx.x / strips;
  const unsigned a0 = (blockIdx.x - n * strips) * kRows;
  const unsigned y_row = wo * groups, x_row = 2 * y_row;
  // window (a, b) of y and dy, and input (2a, 2b) of x
  unsigned yo = (n * ho + a0) * y_row + j;
  unsigned xo = (n * ho + a0) * 2 * x_row + b * groups + j;
  // windows (a-1, b-1) and (a-1, b) of the row above: [0] column b-1, [1] column b
  uint4 yu[2], du[2];
  if (a0 > 0) {
    yu[1] = __ldg(y + yo - y_row);
    du[1] = __ldg(dy + yo - y_row);
    yu[0] = b > 0 ? __ldg(y + yo - y_row - groups) : nan_vec();
    du[0] = b > 0 ? __ldg(dy + yo - y_row - groups) : du[1];
  } else {
    yu[0] = yu[1] = nan_vec();
    du[0] = du[1] = make_uint4(0, 0, 0, 0);
  }
  for (int r = 0; r < kRows && a0 + r < ho; ++r, yo += y_row, xo += 2 * x_row) {
    uint4 yc[2], dc[2];
    yc[1] = __ldg(y + yo);
    dc[1] = __ldg(dy + yo);
    yc[0] = b > 0 ? __ldg(y + yo - groups) : nan_vec();
    dc[0] = b > 0 ? __ldg(dy + yo - groups) : dc[1];
    const uint4 x00 = __ldcs(x + xo), x01 = __ldcs(x + xo + groups);
    const uint4 x10 = __ldcs(x + xo + x_row), x11 = __ldcs(x + xo + x_row + groups);
    constexpr int V = Vec<T>::n;
    float g00[V], g01[V], g10[V], g11[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      // each input's windows, row ascending then column
      const float v00 = Vec<T>::get(x00, i), v01 = Vec<T>::get(x01, i);
      const float v10 = Vec<T>::get(x10, i), v11 = Vec<T>::get(x11, i);
      float s = credit<T>(0.f, v00, yu[0], du[0], i);
      s = credit<T>(s, v00, yu[1], du[1], i);
      s = credit<T>(s, v00, yc[0], dc[0], i);
      g00[i] = credit<T>(s, v00, yc[1], dc[1], i);
      g01[i] = credit<T>(credit<T>(0.f, v01, yu[1], du[1], i), v01, yc[1], dc[1], i);
      g10[i] = credit<T>(credit<T>(0.f, v10, yc[0], dc[0], i), v10, yc[1], dc[1], i);
      g11[i] = credit<T>(0.f, v11, yc[1], dc[1], i);
    }
    __stcs(gx + xo, Vec<T>::pack(g00));
    __stcs(gx + xo + groups, Vec<T>::pack(g01));
    __stcs(gx + xo + x_row, Vec<T>::pack(g10));
    __stcs(gx + xo + x_row + groups, Vec<T>::pack(g11));
    yu[0] = yc[0], yu[1] = yc[1], du[0] = dc[0], du[1] = dc[1];
  }
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16 tensors, 0 for float32; all four tensors are laid
// out N, H, W, C in memory, 16-byte aligned, with C a multiple of 8 (bf16) or
// 4 (float32).
int maxpool_bwd(const void* x, const void* y, const void* dy, void* gx, int n,
                int c, int h, int w, int is_bf16, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  if (n <= 0 || c <= 0 || h < 2 || w < 2 || (h & 1) || (w & 1) || c % vec ||
      ((uintptr_t)x | (uintptr_t)y | (uintptr_t)dy | (uintptr_t)gx) % 16)
    return (int)cudaErrorInvalidValue;
  if ((size_t)n * c * h * w / vec + kThreads > 0xffffffffu) return (int)cudaErrorInvalidValue;
  const unsigned groups = c / vec, ho = h / 2, wo = w / 2;
  const unsigned strips = (ho + kRows - 1) / kRows;
  const dim3 grid(n * strips, (wo * groups + kThreads - 1) / kThreads);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    maxpool_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const uint4*)x, (const uint4*)y, (const uint4*)dy, (uint4*)gx, groups, ho, wo, strips);
  else
    maxpool_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        (const uint4*)x, (const uint4*)y, (const uint4*)dy, (uint4*)gx, groups, ho, wo, strips);
  return (int)cudaGetLastError();
}

// The kernel's design for bfloat16 (is_bf16 = 1) or float32: out = {channels
// per thread, window rows per thread, threads per block, registers per
// thread, local (spilled) bytes per thread, static shared bytes, blocks per
// SM}.
int maxpool_bwd_design(int is_bf16, int* out) {
  const void* kernel = is_bf16 ? (const void*)maxpool_bwd_kernel<__nv_bfloat16>
                              : (const void*)maxpool_bwd_kernel<float>;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  if (err) return err;
  const int v[7] = {is_bf16 ? 8 : 4, kRows, kThreads, attr.numRegs, (int)attr.localSizeBytes,
                    (int)attr.sharedSizeBytes, blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
