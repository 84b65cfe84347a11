// Causal / sliding-window GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> pl.pallas_call, body _kernel).  Same function:
// q [B,H,S,d], k/v [B,Hkv,S,d] -> o [B,H,S,d] in q's dtype; query head h
// reads kv head h / (H/Hkv); online softmax with f32 running max m, sum l
// and output accumulator; the m_safe guard for rows masked so far; a fully
// masked row writes acc / max(l, 1e-30) = 0.
//
// What bounds it on an H100 at the serving slice's shape (B=4, H=32,
// Hkv=8, S=512, d=128, bf16, causal): it reads q, k, v once and writes o
// once, 42 MB, which is 12.5 us at 3.35 TB/s; the causal half of QK^T and
// PV is 8.6 GFLOP, 8.7 us on the bf16 tensor cores.  So the bound is the
// bytes, with the operations close behind.  This first kernel does not
// reach either bound: it computes in f32 on the CUDA cores (f32 inputs
// must match their plain version to 1e-5, which tf32 or bf16 tensor-core
// products cannot), so it is bounded by its own f32 FMA rate.  What the
// design does about the bytes: every q tile is read once, k/v tiles are
// read once per q tile from device memory (L2 keeps them for the other
// q tiles of the same head group), and the [S,S] logits and
// probabilities never leave the block.  mma.sync / wgmma, TMA and warp
// specialisation are later work.
//
// Design.  One thread block per (q tile of 64 rows, query head, batch row).
// The TPU kernel's sequential innermost grid axis over kv blocks, with its
// accumulators in VMEM scratch, becomes a loop inside the block: CUDA
// blocks run in no order, so nothing can be carried between blocks.  The
// loop starts after the window and stops at the causal limit, as the TPU
// kernel's `run` predicate skips blocks.  Q, K and V tiles sit in shared
// memory as f32 (K and V share one buffer), m, l and the output
// accumulator in registers.  256 threads: thread (tx, ty), tx, ty in
// 0..15, owns score rows ty+16i and columns tx+16j (i, j in 0..3), and
// output rows ty+16i and columns tx+16c.  The 16 threads of a row are one
// half-warp, so row max and row sum are warp shuffles.  Rows of shared
// memory are padded by 4 floats so that the float4 reads of 16
// neighbouring rows fall on different banks.  The kernel masks the causal
// triangle, the window and the ragged last tile (any S) itself.  Head dims
// 32, 64, 80, 96 and 128 are built (d/16 output columns a thread; at d = 80
// the row pitch of 84 floats keeps every float4 read 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // kv rows per loop step
constexpr int NT = 256;     // threads per block
constexpr int LDP = BK + 4; // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows row0 .. row0+63 of a row-major [S, D] matrix into dst[64][D+4] as
// f32; rows at or past S are zero (so 0 * garbage never makes a NaN).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int g = row0 + r;
    dst[r * LD + c] = g < S ? to_f32(src[(long long)g * D + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
    fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int H, int Hkv, int S,
           float scale, int causal, int has_window, int window) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = iq * BQ;
  const long long qo = (long long)(b * H + h) * S * D;
  const long long ko = (long long)(b * Hkv + hk) * S * D;

  load_tile<T, D>(Qs, q + qo, q0, S);

  const int nk = (S + BK - 1) / BK;
  int kt_end = nk - 1;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK);
  int kt_begin = 0;
  if (has_window) {
    const int lo = q0 - window + 1;   // first key row q0 may see
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step's reads of KVs and Ps are done
    load_tile<T, D>(KVs, k + ko, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ka[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * LD + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const int diff = qpos - kpos;
        const bool ok = kpos < S && (!causal || diff >= 0) &&
                        (!has_window || diff < window);
        const float x = ok ? s[i][j] * scale : NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float m_safe = m_new <= NEG_INF ? 0.f : m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        s[i][j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float corr = expf(m[i] - m_safe);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    }

    __syncthreads();  // K reads done, P written
    load_tile<T, D>(KVs, v + ko, k0, S);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) vv[c] = KVs[(kk + u) * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                        : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      const float den = fmaxf(l[i], 1e-30f);
      T* orow = o + qo + (long long)r * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) store(&orow[tx + 16 * c], acc[i][c] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int Hkv, int S, float scale, int causal,
                   int has_window, int window, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int smem = (BQ * LD + BK * LD + BQ * LDP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, scale, causal,
      has_window, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int B, int H, int Hkv, int S, float scale,
                     int causal, int has_window, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, scale, causal,
                           has_window, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, scale, causal,
                           has_window, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, B, H, Hkv, S, scale, causal,
                           has_window, window, stream);
    case 96:
      return launch<T, 96>(q, k, v, o, B, H, Hkv, S, scale, causal,
                           has_window, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, scale, causal,
                            has_window, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers of contiguous
// tensors; dtype 0 is float32, 1 is bfloat16.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int S,
                                   int D, int dtype, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, o, B, H, Hkv, S, scale, causal,
                                has_window, window, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, S, scale,
                                        causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}
