// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py
// (mamba2_chunk_scan -> pl.pallas_call, body _kernel).  Same function:
// xdt [B,H,L,P], Bm, Cm [B,H,L,N] (f32 or bf16), a [B,H,L] f32 log-decays
// -> y [B,H,L,P] in xdt's dtype and the final state [B,H,P,N] in f32, the
// recurrence h_t = exp(a_t) h_{t-1} + x_t (x) B_t, y_t = h_t . C_t computed
// a tile of T rows at a time:
//
//   cs     = cumsum(a) over the tile (inclusive)
//   G[t,s] = (C_t . B_s) * exp(cs[t] - cs[s])     for s <= t, else 0
//   y      = G x + exp(cs) (.) (C S^T)            S: the state before the tile
//   S     <- exp(cs[T-1]) S + sum_s exp(cs[T-1] - cs[s]) x_s (x) B_s
//
// exp(cs[t] - cs[s]) is computed only where s <= t (a select, as the TPU
// kernel's jnp.where(tri, exp(diff), 0)): above the diagonal the
// difference is positive, may overflow to inf, and inf * 0 is NaN.
//
// The tile.  The function does not depend on the chunk size, only the
// rounding does, so this kernel walks the sequence in tiles of its own,
// T = 64 rows, whatever `chunk` the wrapper was given (the wrapper keeps
// the TPU kernel's contract: chunk = min(chunk, L), L % chunk == 0).  At
// chunk 256 and f32 the TPU kernel's working set (3 x 64 KB of x, B, C and
// 256 KB of C B^T) would not fit in 227 KB of shared memory; 64-row tiles
// of x, B, C and G in f32 are 17 KB each at P = N = 64 (rows padded by 4
// floats against bank conflicts), 87 KB with the [P,N] state, set with
// cudaFuncAttributeMaxDynamicSharedMemorySize.  A ragged last tile (any L)
// is masked here: rows past L load as x = B = C = 0 and a = 0, so they add
// nothing to y or to the state and decay nothing.
//
// Grid.  One thread block per (b, h).  The TPU kernel's sequential
// innermost grid axis over chunks, with the state in VMEM scratch, becomes
// a loop inside the block over the sequence, with the state in shared
// memory: CUDA blocks run in no order, so nothing can be carried between
// blocks.  256 threads: thread (tx, ty), tx, ty in 0..15, owns rows
// ty + 16 i of G and y, columns tx + 16 j of G and tx + 16 c of y, and the
// state entries (ty + 16 i, tx + 16 j).  The final state is written once,
// after the last tile.
//
// What bounds it on an H100 at the serving slice's shape (bf16, B=4, H=80,
// L=512, P=N=64): it reads xdt, Bm and Cm (21.0 MB each) and a (0.66 MB),
// and writes y (21.0 MB) and the state (5.2 MB): 89.8 MB, 26.8 us at
// 3.35 TB/s.  The products are 5.4 GFLOP with 64-row tiles (13.4 with the
// TPU kernel's 256-row chunks), 5.4-13.6 us on the bf16 tensor cores.  So
// bytes bound it.  This first kernel computes every product in f32 on the
// CUDA cores (f32 inputs must match their plain version to 2e-4), whose
// 67 TFLOP/s take about 80 us for 5.4 GFLOP: it should land near 3x its
// bound at best.  Tensor-core products (mma.sync / wgmma), TMA, and
// reading Bm/Cm once per group instead of repeated over heads are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;        // rows per tile
constexpr int NT = 256;      // threads per block
constexpr int LDG = T + 4;   // padded row of G

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Rows row0 .. row0+T-1 of a row-major [L, D] matrix into dst[T][D+4] as
// f32; rows at or past L are zero.
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, const E* src, int row0,
                                          int L) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < T * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int g = row0 + r;
    dst[r * LD + c] = g < L ? to_f32(src[(long long)g * D + c]) : 0.f;
  }
}

template <typename E, int P, int N>
__global__ void __launch_bounds__(NT, 2)
    ssd_scan(const E* __restrict__ xdt, const float* __restrict__ a,
             const E* __restrict__ Bm, const E* __restrict__ Cm,
             E* __restrict__ y, float* __restrict__ state, int L) {
  static_assert(P % 16 == 0 && N % 4 == 0, "tile layout");
  constexpr int LDP = P + 4, LDN = N + 4;
  constexpr int CPT = P / 16;            // y columns and state rows a thread
  constexpr int NPT = (N + 15) / 16;     // state columns a thread
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);   // [T][LDP]
  float* Bs = Xs + T * LDP;                      // [T][LDN]
  float* Cs = Bs + T * LDN;                      // [T][LDN]
  float* Gs = Cs + T * LDN;                      // [T][LDG]
  float* Ss = Gs + T * LDG;                      // [P][LDN]
  float* cs = Ss + P * LDN;                      // [T]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* ab = a + (long long)bh * L;
  const E* xb = xdt + (long long)bh * L * P;
  const E* bb = Bm + (long long)bh * L * N;
  const E* cb = Cm + (long long)bh * L * N;
  E* yb = y + (long long)bh * L * P;

  for (int idx = tid; idx < P * LDN; idx += NT) Ss[idx] = 0.f;

  const int ntiles = (L + T - 1) / T;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * T;
    __syncthreads();  // the previous tile's reads and state writes are done
    load_tile<E, P>(Xs, xb, t0, L);
    load_tile<E, N>(Bs, bb, t0, L);
    load_tile<E, N>(Cs, cb, t0, L);
    if (tid < 32) {   // inclusive cumsum of a over the tile: 2 rows a lane
      const int r = 2 * tid;
      const float a0 = t0 + r < L ? ab[t0 + r] : 0.f;
      const float a1 = t0 + r + 1 < L ? ab[t0 + r + 1] : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, s, off);
        if (tid >= off) s += u;
      }
      cs[r] = s - a1;
      cs[r + 1] = s;
    }
    __syncthreads();

    // G = (C B^T) masked by the decay, rows ty+16i, columns tx+16j
    {
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 ca[4], ba[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ca[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * LDN + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ba[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * LDN + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = g[i][j];
            v = fmaf(ca[i].x, ba[j].x, v);
            v = fmaf(ca[i].y, ba[j].y, v);
            v = fmaf(ca[i].z, ba[j].z, v);
            v = fmaf(ca[i].w, ba[j].w, v);
            g[i][j] = v;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          const float decay = s <= t ? expf(cs[t] - cs[s]) : 0.f;
          Gs[t * LDG + s] = g[i][j] * decay;
        }
      }
    }
    __syncthreads();

    // y = G x + exp(cs) (.) (C S^T), rows ty+16i, columns tx+16c
    {
      float acc[4][CPT], off[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = off[i][c] = 0.f;
#pragma unroll 2
      for (int s = 0; s < T; s += 4) {
        float4 ga[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ga[i] = *reinterpret_cast<const float4*>(&Gs[(ty + 16 * i) * LDG + s]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float xv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) xv[c] = Xs[(s + u) * LDP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float gv = u == 0 ? ga[i].x : u == 1 ? ga[i].y
                           : u == 2 ? ga[i].z : ga[i].w;
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(gv, xv[c], acc[i][c]);
          }
        }
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 ca[4], sa[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ca[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * LDN + n]);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          sa[c] = *reinterpret_cast<const float4*>(&Ss[(tx + 16 * c) * LDN + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            float v = off[i][c];
            v = fmaf(ca[i].x, sa[c].x, v);
            v = fmaf(ca[i].y, sa[c].y, v);
            v = fmaf(ca[i].z, sa[c].z, v);
            v = fmaf(ca[i].w, sa[c].w, v);
            off[i][c] = v;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t0 + t < L) {
          const float dec = expf(cs[t]);
          E* yrow = yb + (long long)(t0 + t) * P;
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            store(&yrow[tx + 16 * c], fmaf(dec, off[i][c], acc[i][c]));
        }
      }
    }
    __syncthreads();  // every read of the state before this tile is done

    // S <- exp(cs[T-1]) S + sum_s exp(cs[T-1] - cs[s]) x_s (x) B_s, entries
    // (ty+16i, tx+16j); the decay to the tile's end is folded into x here
    {
      const float last = cs[T - 1];
      float sn[CPT][NPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int j = 0; j < NPT; ++j) sn[i][j] = 0.f;
      if (tx < N) {
#pragma unroll 4
        for (int s = 0; s < T; ++s) {
          const float w = expf(last - cs[s]);
          float xv[CPT], bv[NPT];
#pragma unroll
          for (int i = 0; i < CPT; ++i) xv[i] = w * Xs[s * LDP + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            bv[j] = tx + 16 * j < N ? Bs[s * LDN + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < CPT; ++i)
#pragma unroll
            for (int j = 0; j < NPT; ++j) sn[i][j] = fmaf(xv[i], bv[j], sn[i][j]);
        }
        const float dec = expf(last);
#pragma unroll
        for (int i = 0; i < CPT; ++i)
#pragma unroll
          for (int j = 0; j < NPT; ++j) {
            const int n = tx + 16 * j;
            if (n < N) {
              float* sp = &Ss[(ty + 16 * i) * LDN + n];
              *sp = fmaf(dec, *sp, sn[i][j]);
            }
          }
      }
    }
  }
  __syncthreads();

  float* sb = state + (long long)bh * P * N;
  for (int idx = tid; idx < P * N; idx += NT) {
    const int p = idx / N;
    sb[idx] = Ss[p * LDN + idx - p * N];
  }
}

template <typename E, int P, int N>
cudaError_t launch(const void* xdt, const float* a, const void* Bm,
                   const void* Cm, void* y, float* state, int BH, int L,
                   cudaStream_t stream) {
  constexpr int LDP = P + 4, LDN = N + 4;
  const int smem =
      (T * LDP + 2 * T * LDN + T * LDG + P * LDN + T) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<E, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan<E, P, N><<<BH, NT, smem, stream>>>(
      static_cast<const E*>(xdt), a, static_cast<const E*>(Bm),
      static_cast<const E*>(Cm), static_cast<E*>(y), state, L);
  return cudaGetLastError();
}

template <typename E>
cudaError_t dispatch(int P, int N, const void* xdt, const float* a,
                     const void* Bm, const void* Cm, void* y, float* state,
                     int BH, int L, cudaStream_t stream) {
  if (P == 64 && N == 64)
    return launch<E, 64, 64>(xdt, a, Bm, Cm, y, state, BH, L, stream);
  if (P == 32 && N == 16)
    return launch<E, 32, 16>(xdt, a, Bm, Cm, y, state, BH, L, stream);
  if (P == 16 && N == 8)
    return launch<E, 16, 8>(xdt, a, Bm, Cm, y, state, BH, L, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers of contiguous
// tensors; dtype 0 is float32, 1 is bfloat16 (xdt, Bm, Cm and y; a and the
// state are float32).  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() after the launch.
extern "C" int mamba2_chunk_scan_fwd(const void* xdt, const void* a,
                                     const void* Bm, const void* Cm, void* y,
                                     void* state, int B, int H, int L, int P,
                                     int N, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return (int)dispatch<float>(P, N, xdt, af, Bm, Cm, y, sf, B * H, L, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(P, N, xdt, af, Bm, Cm, y, sf, B * H,
                                        L, st);
  return (int)cudaErrorInvalidValue;
}
