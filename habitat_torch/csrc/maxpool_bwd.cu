// Backward of the 3x3, stride-2, "SAME" max pool of the ResNet stem, with
// every tied input credited, on (N, C, H, W) tensors, for sm_90a.
//
// Replaces the TPU kernel of habitat_tpu/ops/pool.py:
//   maxpool_bwd <- max_pool_3x3s2's VJP / _bwd_kernel (pallas_call at :123)
//
// What it computes: for even H and W, XLA's SAME padding of a 3x3/2 window
// pads one row and one column at the high end only, so window (a, b) covers
// input rows 2a..2a+2 and columns 2b..2b+2. An input (h, w) lies in at most
// two window rows (h/2 - 1 when h is even and h >= 2, and h/2) and at most
// two window columns, and
//   gx[h, w] = sum over those windows of dy[a, b] * (x[h, w] == y[a, b]).
// Every input equal to its window's maximum gets the window's gradient (XLA
// and torch credit one of the tied inputs only).
//
// The TPU kernel works on (H, W, C, B) with the batch in lanes, splits rows
// and columns by parity and passes two row-shifted views of (y, dy), so that
// Mosaic only ever slices leading dimensions; the transposes in and out cost
// more than the kernel saved. None of that carries over: here one thread
// takes one input element, neighbouring threads on neighbouring addresses,
// and reads its x and the <= 4 covering (y, dy) pairs, which neighbouring
// threads share through L1 and L2. The tensors are (N, C, H, W) laid out
// channels-last (N, H, W, C in memory), which is what the policy's stem hands
// over: the encoder permutes NHWC observations into an NCHW view and the
// convolutions and GroupNorm keep that layout. Values are compared exactly in
// the working type (a bf16 -> float conversion is exact), the gradient is
// summed in float32 in a fixed order (window row ascending, then window
// column) and rounded once to the working type, so the plain PyTorch version
// (ops/pool.py, the same order) agrees bit for bit.
//
// What bounds it on an H100: bytes. It reads x and writes gx once and reads
// y and dy (a quarter of x each) once from device memory: at the bench
// update's minibatch, x (4096, 32, 64, 64) bf16, that is 1.07 + 0.27 + 0.27
// + 1.07 = 2.68 GB, 0.80 ms at 3.35 TB/s; it does at most 4 compares and 4
// adds per element.
//
// Layouts (float32 or bfloat16), all four tensors channels-last:
//   x, gx  (N, C, H, W)      as N, H, W, C in memory
//   y, dy  (N, C, H/2, W/2)  likewise

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) maxpool_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ dy,
    T* __restrict__ gx, unsigned c, unsigned h, unsigned w, unsigned total) {
  // 32-bit indices (the caller keeps total below 2^32): a division by a
  // runtime divisor costs a few instructions in 32 bits, many in 64
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const unsigned ho = h >> 1, wo = w >> 1;
  const unsigned pix = i / c;
  const unsigned col = pix % w;
  const unsigned rows = pix / w;
  const unsigned row = rows % h;
  // window (a, b) of y / dy sits at base + a * row_step + b * c
  const unsigned base = (rows / h) * ho * wo * c + (i - pix * c);
  const unsigned row_step = wo * c;
  const float xv = to_f32(x[i]);
  const unsigned a1 = row >> 1, b1 = col >> 1;
  const unsigned a0 = (row & 1) || row == 0 ? a1 : a1 - 1;
  const unsigned b0 = (col & 1) || col == 0 ? b1 : b1 - 1;
  float acc = 0.f;
  for (unsigned a = a0; a <= a1; ++a) {
    for (unsigned b = b0; b <= b1; ++b) {
      const unsigned o = base + a * row_step + b * c;
      if (to_f32(y[o]) == xv) acc = __fadd_rn(acc, to_f32(dy[o]));
    }
  }
  gx[i] = from_f32<T>(acc);
}

template <typename T>
void launch(const void* x, const void* y, const void* dy, void* gx, int c,
            int h, int w, unsigned total, cudaStream_t stream) {
  const unsigned blocks = (total + kThreads - 1) / kThreads;
  maxpool_bwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (const T*)y, (const T*)dy, (T*)gx, c, h, w, total);
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16 tensors, 0 for float32; all four tensors are
// laid out N, H, W, C in memory.
int maxpool_bwd(const void* x, const void* y, const void* dy, void* gx, int n,
                int c, int h, int w, int is_bf16, void* stream) {
  if (n <= 0 || c <= 0 || h < 2 || w < 2 || (h & 1) || (w & 1))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)n * c * h * w;
  if (total + kThreads > 0xffffffffu) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    launch<__nv_bfloat16>(x, y, dy, gx, c, h, w, (unsigned)total,
                          (cudaStream_t)stream);
  else
    launch<float>(x, y, dy, gx, c, h, w, (unsigned)total, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
