// 1-bit gradient compression with error feedback, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/onebit.py:
//   onebit_quantize   (-> pl.pallas_call, body _quant_kernel)   as K3a;
//   onebit_dequantize (-> pl.pallas_call, body _dequant_kernel) as K3b.
// Same functions on [R, C] float32 (C % 128 == 0; the codec uses C = 1024):
//   quantize:   q = g + err; scale = mean|q| per row; bit j of word w of a
//               row is q[32w + j] >= 0 (little-endian uint32 words, stored
//               here as int32 with the same bytes); new_err = q - (+-scale);
//   dequantize: out[r][32w + j] = bit ? scale[r] : -scale[r].
// The TPU kernel writes the scale lane-replicated to [R, 128], its own
// layout; here it is [R], the one column the codec puts on the wire.
//
// What bounds them on an H100: both are pure streams.  K3a reads g and err
// and writes new_err, the words and the scales, about 12.1 bytes an
// element; K3b reads the words and scales and writes the output, about 4.1
// bytes an element.  Their arithmetic is a few operations an element, so
// the bound is the bytes at 3.35 TB/s.  What the design does about it:
// every element is read from device memory once and written once, in
// 128-byte coalesced warp accesses; the sign words come from one
// __ballot_sync per warp and 32 elements (lane j of the warp is bit j of
// the word), so packing costs no shared memory and no shifts.
//
// Design.  K3a: one block of 128 threads (4 warps) per row.  The TPU kernel
// reduces a row inside one grid step; here the block does: pass 1 sums
// |g + err| over the row (warp shuffles, then the 4 warp sums in shared
// memory), pass 2 reads the row again (from L1/L2: a 1024-element row of g
// and err is 8 KB) and writes new_err and the words.  Thread t of the block
// takes elements t, t + 128, ..., so a warp's 32 lanes hold the 32 elements
// of one word.  K3b: one thread per element, a warp per word.

#include <cuda_runtime.h>

namespace {

constexpr int QT = 128;  // threads per row of K3a
constexpr int DT = 256;  // threads per block of K3b

__global__ void __launch_bounds__(QT)
    onebit_quant(const float* __restrict__ g, const float* __restrict__ err,
                 unsigned* __restrict__ packed, float* __restrict__ scale,
                 float* __restrict__ new_err, int C) {
  __shared__ float part[QT / 32];
  __shared__ float row_scale;
  const long long r = blockIdx.x;
  const float* gr = g + r * C;
  const float* er = err + r * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float s = 0.f;
  for (int e = threadIdx.x; e < C; e += QT) s += fabsf(gr[e] + er[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < QT / 32; ++w) t += part[w];
    row_scale = t / (float)C;
    scale[r] = row_scale;
  }
  __syncthreads();
  const float a = row_scale;

  float* nr = new_err + r * C;
  unsigned* pr = packed + r * (C / 32);
  for (int e = threadIdx.x; e < C; e += QT) {
    const float q = gr[e] + er[e];
    const bool pos = q >= 0.f;
    nr[e] = q - (pos ? a : -a);
    const unsigned word = __ballot_sync(0xffffffffu, pos);
    if (lane == 0) pr[e / 32] = word;
  }
}

__global__ void __launch_bounds__(DT)
    onebit_dequant(const unsigned* __restrict__ packed,
                   const float* __restrict__ scale, float* __restrict__ out,
                   long long n, int C) {
  const long long e = (long long)blockIdx.x * DT + threadIdx.x;
  if (e >= n) return;
  const long long r = e / C;
  const unsigned word = packed[e / 32];
  const float a = scale[r];
  out[e] = (word >> (e & 31)) & 1u ? a : -a;
}

}  // namespace

// C entries, bound with ctypes.  Pointers are device pointers of contiguous
// tensors.  Each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.

// K3a: g, err [R, C] f32 -> packed [R, C/32] (32-bit words), scale [R] f32,
// new_err [R, C] f32.  new_err may be err itself: a thread writes only the
// elements it has read, after the row's sum.
extern "C" int onebit_quantize_fwd(const void* g, const void* err,
                                   void* packed, void* scale, void* new_err,
                                   int R, int C, void* stream) {
  if (R <= 0 || C <= 0 || C % 128 != 0) return (int)cudaErrorInvalidValue;
  onebit_quant<<<R, QT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(err),
      static_cast<unsigned*>(packed), static_cast<float*>(scale),
      static_cast<float*>(new_err), C);
  return (int)cudaGetLastError();
}

// K3b: packed [R, C/32] words and scale [R] f32 -> out [R, C] f32.
extern "C" int onebit_dequantize_fwd(const void* packed, const void* scale,
                                     void* out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0 || C % 128 != 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * C;
  const long long blocks = (n + DT - 1) / DT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  onebit_dequant<<<(unsigned)blocks, DT, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(packed), static_cast<const float*>(scale),
      static_cast<float*>(out), n, C);
  return (int)cudaGetLastError();
}
