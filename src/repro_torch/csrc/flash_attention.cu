// Causal / sliding-window GQA flash attention, forward and backward, for
// Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py (flash_attention -> pl.pallas_call,
// body _kernel).  Same function:
// q [B,H,S,d], k/v [B,Hkv,S,d] -> o [B,H,S,d] in q's dtype; query head h
// reads kv head h / (H/Hkv); online softmax with f32 running max m, sum l
// and output accumulator; the m_safe guard for rows masked so far; a fully
// masked row writes acc / max(l, 1e-30) = 0.
//
// Two routes, chosen by dtype in the C entries at the end of the file.
// bfloat16, which every main path runs, goes to the tensor-core kernels
// (wgmma, section "bfloat16" below).  float32 goes to the kernels that
// follow here, which compute in f32 on the CUDA cores: f32 inputs must
// match their plain version to 1e-5, which tf32 or bf16 tensor-core
// products cannot.  At the serving slice's shape (B=4, H=32, Hkv=8,
// S=512, d=128, causal) the function reads q, k, v once and writes o
// once, 42 MB at bf16, 12.5 us at 3.35 TB/s, and its causal products are
// 8.6 GFLOP, 8.7 us on the bf16 tensor cores; the f32 kernels are bounded
// by their own FMA rate instead.  Every q tile is read once, k/v tiles
// once per q tile from device memory (L2 keeps them for the other q tiles
// of the same head group), and the [S,S] logits and probabilities never
// leave the block.
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
#include <math.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;      // query rows per block
constexpr int BK = 64;      // kv rows per loop step
constexpr int NT = 256;     // threads per block
constexpr int LDP = BK + 4; // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

// The kernels below take T = float only; bf16 has its own kernels.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
           float* __restrict__ lse, float scale, int causal, int has_window,
           int window) {
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
      // the row's log-sum-exp of the scaled, masked logits, for the backward
      if (lse != nullptr && tx == 0) {
        const float m_safe = m[i] <= NEG_INF ? 0.f : m[i];
        lse[(long long)(b * H + h) * S + r] = m_safe + logf(den);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int S, float scale,
                   int causal, int has_window, int window,
                   cudaStream_t stream) {
  constexpr int LD = D + 4;
  const int smem = (BQ * LD + BK * LD + BQ * LDP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  fa_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, lse, scale,
      causal, has_window, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int H, int Hkv, int S,
                     float scale, int causal, int has_window, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, Hkv, S, scale,
                            causal, has_window, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, Hkv, S, scale,
                            causal, has_window, window, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, lse, B, H, Hkv, S, scale,
                            causal, has_window, window, stream);
    case 96:
      return launch<T, 96>(q, k, v, o, lse, B, H, Hkv, S, scale,
                            causal, has_window, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, Hkv, S, scale,
                            causal, has_window, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward (dq, dk, dv).  The JAX package has no backward kernel: its
// training differentiates attend_chunked (src/repro/models/attention.py).
// The port attends through the forward kernel above, so its gradient is a
// kernel too.  FlashAttention-2's split, with P recomputed from the
// forward's row log-sum-exp (lse) and never stored:
//
//   P = exp(scale q k^T - lse)      (0 where masked)
//   dV = P^T dO,   dP = dO V^T,   dS = P o (dP - Delta),
//   Delta = rowsum(dO o O),   dQ = scale dS K,   dK = scale dS^T Q.
//
// Head dims 32, 64, 80, 96 and 128, as the forward.  At 80 and 96 the f32
// kernels give a thread 5 and 6 of the d/16-strided columns, as the
// forward does; the bf16 kernels' Q K^T and dO V^T read the partial second
// 64-column panel (d/16 k-steps) and their P V-shaped products run
// wgmma_rs<80> and <96> over it, as the forward's P V.
//
// Three launches: fa_bwd_delta computes Delta; fa_bwd_dkdv writes dk and
// dv, one block per (kv tile of 64 rows, kv head, batch row) looping over
// the H/Hkv query heads of its group and the q tiles the mask lets see the
// tile, so the GQA sum stays inside one block (no atomics, deterministic);
// fa_bwd_dq writes dq, one block per (q tile, head, batch row) with the
// forward's traversal of kv tiles.  The f32 route: everything in f32 on
// the CUDA cores, as in the f32 forward, with the same thread layout:
// thread (tx, ty) owns tile rows ty+16i and columns tx+16j of every 64 x
// 64 product and rows ty+16i, columns tx+16c of its accumulators.
//
// What bounds it at the training slice's shape (B=4, H=32, Hkv=8, S=512,
// d=128, bf16, causal): it reads q, k, v, o, dO and lse and writes dq, dk,
// dv, about 84 MB, 25 us at 3.35 TB/s; the causal products (q k^T and
// dO V^T recomputed, dV, dK, dQ) are about 21.5 GFLOP, 22 us on the bf16
// tensor cores, where the bf16 route runs them.  On the f32 CUDA cores
// the products alone take at least 0.32 ms.  Shared memory of the f32
// kernels at d=128: four 64 x 132 f32 tiles and one 64 x 68 tile, 153 KB,
// one block an SM.
// ---------------------------------------------------------------------------

// Delta[row] = sum_c dO[row][c] O[row][c] in f32, one warp a row.
template <typename T>
__global__ void __launch_bounds__(NT)
    fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, long long rows, int D) {
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f32(orow[c]), to_f32(drow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// acc[i][j] = sum_c A[ty+16i][c] * Bt[tx+16j][c] over two [64][D+4] tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* A,
                                         const float* Bt, int tx, int ty) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 a[4], bt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bt[j] = *reinterpret_cast<const float4*>(&Bt[(tx + 16 * j) * LD + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, bt[j].x, s);
        s = fmaf(a[i].y, bt[j].y, s);
        s = fmaf(a[i].z, bt[j].z, s);
        s = fmaf(a[i].w, bt[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][c] += sum_kk Ps[ty+16i][kk] * X[kk][tx+16c]: a [64][64] tile
// (row pitch LDP) times a [64][D+4] tile.
template <int D>
__device__ __forceinline__ void tile_acc(float acc[4][D / 16], const float* Ps,
                                         const float* X, int tx, int ty) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / 16;
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 4) {
    float4 pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LDP + kk]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float xv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) xv[c] = X[(kk + u) * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                      : u == 2 ? pa[i].z : pa[i].w;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, xv[c], acc[i][c]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int causal,
                                        int has_window, int window) {
  const int diff = qpos - kpos;
  return qpos < S && kpos < S && (!causal || diff >= 0) &&
         (!has_window || diff < window);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int S,
                float scale, int causal, int has_window, int window) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;      // P^T, then dS^T: [kv row][q row]
  float* Ls = Ps + BK * LDP;      // lse of the q tile's rows
  float* Ds = Ls + BQ;            // Delta of the q tile's rows

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = ik * BK;
  const long long ko = (long long)(b * Hkv + hk) * S * D;

  load_tile<T, D>(Ks, k + ko, k0, S);
  load_tile<T, D>(Vs, v + ko, k0, S);

  // q tiles with a row that sees a key of this tile
  const int nq = (S + BQ - 1) / BQ;
  const int qt_begin = causal ? k0 / BQ : 0;
  int qt_end = nq - 1;
  if (has_window) {
    const long long last = (long long)k0 + BK - 1 + window - 1;
    if (last / BQ < qt_end) qt_end = (int)(last / BQ);
  }

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long qo = (long long)(b * H + h) * S * D;
    const long long ro = (long long)(b * H + h) * S;
    for (int qt = qt_begin; qt <= qt_end; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous step's reads of Qs, dOs, Ps are done
      load_tile<T, D>(Qs, q + qo, q0, S);
      load_tile<T, D>(dOs, dout + qo, q0, S);
      if (threadIdx.x < BQ) {
        const int r = q0 + threadIdx.x;
        Ls[threadIdx.x] = r < S ? lse[ro + r] : 0.f;
        Ds[threadIdx.x] = r < S ? delta[ro + r] : 0.f;
      }
      __syncthreads();

      float p[4][4], ds[4][4];
      tile_dot<D>(p, Ks, Qs, tx, ty);    // S^T = K Q^T
      tile_dot<D>(ds, Vs, dOs, tx, ty);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j;
          const bool ok = visible(q0 + qr, k0 + ty + 16 * i, S, causal,
                                  has_window, window);
          const float pv = ok ? expf(p[i][j] * scale - Ls[qr]) : 0.f;
          p[i][j] = pv;
          ds[i][j] = pv * (ds[i][j] - Ds[qr]);
          Ps[(ty + 16 * i) * LDP + qr] = pv;
        }
      __syncthreads();
      tile_acc<D>(dva, Ps, dOs, tx, ty);  // dV += P^T dO
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
      __syncthreads();
      tile_acc<D>(dka, Ps, Qs, tx, ty);   // dK += dS^T Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r < S) {
      T* krow = dk + ko + (long long)r * D;
      T* vrow = dv + ko + (long long)r * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        store(&krow[tx + 16 * c], dka[i][c] * scale);
        store(&vrow[tx + 16 * c], dva[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int H, int Hkv, int S, float scale,
              int causal, int has_window, int window) {
  constexpr int LD = D + 4;
  constexpr int CPT = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;       // dS: [q row][kv row]

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = iq * BQ;
  const long long qo = (long long)(b * H + h) * S * D;
  const long long ko = (long long)(b * Hkv + hk) * S * D;
  const long long ro = (long long)(b * H + h) * S;

  load_tile<T, D>(Qs, q + qo, q0, S);
  load_tile<T, D>(dOs, dout + qo, q0, S);
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < S ? lse[ro + r] : 0.f;
    dr[i] = r < S ? delta[ro + r] : 0.f;
  }

  const int nk = (S + BK - 1) / BK;
  int kt_end = nk - 1;
  if (causal) kt_end = min(kt_end, (q0 + BQ - 1) / BK);
  int kt_begin = 0;
  if (has_window) {
    const int lo = q0 - window + 1;   // first key row q0 may see
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous step's reads of Ks, Vs, Ps are done
    load_tile<T, D>(Ks, k + ko, k0, S);
    load_tile<T, D>(Vs, v + ko, k0, S);
    __syncthreads();

    float p[4][4], ds[4][4];
    tile_dot<D>(p, Qs, Ks, tx, ty);    // S = Q K^T
    tile_dot<D>(ds, dOs, Vs, tx, ty);  // dP = dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(q0 + ty + 16 * i, k0 + tx + 16 * j, S, causal,
                                has_window, window);
        const float pv = ok ? expf(p[i][j] * scale - lr[i]) : 0.f;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = pv * (ds[i][j] - dr[i]);
      }
    __syncthreads();
    tile_acc<D>(acc, Ps, Ks, tx, ty);   // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      T* row = dq + qo + (long long)r * D;
#pragma unroll
      for (int c = 0; c < CPT; ++c) store(&row[tx + 16 * c], acc[i][c] * scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int H, int Hkv, int S, float scale, int causal,
                       int has_window, int window, cudaStream_t stream) {
  constexpr int LD = D + 4;
  const long long rows = (long long)B * H * S;
  const int nblk = (int)((rows + NT / 32 - 1) / (NT / 32));
  fa_bwd_delta<T><<<nblk, NT, 0, stream>>>(static_cast<const T*>(o),
                                           static_cast<const T*>(dout), delta,
                                           rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_kv = (4 * BK * LD + BK * LDP + 2 * BQ) * (int)sizeof(float);
  err = cudaFuncSetAttribute(fa_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((S + BK - 1) / BK, Hkv, B);
  fa_bwd_dkdv<T, D><<<grid_kv, NT, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, S, scale, causal,
      has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = (4 * BQ * LD + BQ * LDP) * (int)sizeof(float);
  err = cudaFuncSetAttribute(fa_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((S + BQ - 1) / BQ, H, B);
  fa_bwd_dq<T, D><<<grid_q, NT, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Hkv, S, scale, causal, has_window, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         void* dq, void* dk, void* dv, float* delta, int B,
                         int H, int Hkv, int S, float scale, int causal,
                         int has_window, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                               Hkv, S, scale, causal, has_window, window,
                               stream);
    case 64:
      return launch_bwd<T, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                               Hkv, S, scale, causal, has_window, window,
                               stream);
    case 80:
      return launch_bwd<T, 80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                               Hkv, S, scale, causal, has_window, window,
                               stream);
    case 96:
      return launch_bwd<T, 96>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                               Hkv, S, scale, causal, has_window, window,
                               stream);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                                H, Hkv, S, scale, causal, has_window, window,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ===========================================================================
// bfloat16: the tensor-core kernels.  Every main path runs K1 in bf16
// (compute_dtype "bf16" for qwen3-4b and zamba2-2.7b); the f32 kernels
// above stay for f32 inputs, which must match their plain version to 1e-5
// and so cannot go through bf16 or tf32 products.  flash_attention_fwd and
// flash_attention_bwd send a bf16 call here and nowhere else.
//
// Same function as the f32 kernels and as the TPU kernel they replace
// (src/repro/kernels/flash_attention.py::flash_attention): causal and
// sliding-window GQA attention, online softmax with f32 m and l, the
// m_safe guard, o = acc / max(l, 1e-30), lse = m_safe + log(l).
//
// What bounds them on an H100 at qwen3-4b's prefill shape (B=4, H=32,
// Hkv=8, S=512, d=128, causal): the forward moves 42 MB (12.5 us at 3.35
// TB/s) and does 8.6 GFLOP of causal products (8.7 us at 989 TFLOP/s of
// bf16 wgmma); the backward moves 84 MB (25 us) and does 21.5 GFLOP (22
// us).  Both sit at the ridge, so the design keeps the products on the
// tensor cores and reads every tile from device memory once per block:
//
// - Products: every one is a Hopper wgmma (m64nNk16, bf16 in, f32
//   accumulate).  Q K^T and dO V^T take both operands from shared memory
//   (K-major); P V, P^T dO, dS^T Q and dS K take the probabilities (or
//   dS), rounded to bf16 as the plain version rounds p, straight from the
//   accumulator registers as the A operand, and V, dO, Q or K from shared
//   memory in the MN-major ("transposed B") form that 16-bit types allow,
//   so no tile is ever transposed.
// - Shared memory: every tile is stored as 64-column panels of 128-byte
//   rows with the 128-byte swizzle (16-byte chunk c of row r at c ^ r%8),
//   the layout wgmma's descriptors name.  Head dims 80 and 96 take two
//   panels; the second is only partly filled and only its filled columns
//   are ever read (Q K^T runs d/16 k-steps, P V has N = d).
// - Loads: cp.async, 16 bytes a thread, double-buffered: the next K (and
//   V, or Q/dO) tile is in flight while the tensor cores work on this
//   one, one __syncthreads a step.  cp.async rather than TMA keeps the
//   ragged edge (zero-fill past S) and the swizzle in the kernel's own
//   address arithmetic, with no tensor maps to build on the host per call.
// - Softmax on the accumulator fragments: a thread holds rows r and r+8 of
//   its warp's 16, so row max and sum are two quad shuffles; exp2 with the
//   scale folded into log2(e).
// - Forward overlap: each warpgroup issues S_j = Q K_j^T and the previous
//   tile's O += P V together and runs tile j's softmax while P V is on the
//   tensor cores (FlashAttention-3's intra-warpgroup pipelining), with two
//   blocks an SM so that four warpgroups interleave.  At d=128 the 128
//   registers a thread that two blocks allow leave the overlap little
//   room; one block an SM with more registers measured slower.
// - Masking: only tiles that cross the causal diagonal, the window's edge
//   or S are masked element by element; kv tiles outside the block's mask
//   are never loaded, as the TPU kernel's `run` predicate skips them (the
//   forward's warpgroup runs its block's one tile it cannot see fully
//   masked, so that no wgmma sits in a branch).
// - The backward keeps the f32 kernels' three launches and their
//   determinism: Delta = rowsum(dO o O) (16-byte loads, D/8 lanes a row
//   padded to a power of two);
//   one block per (64-row kv tile, kv
//   head, batch row) loops over its GQA group's heads and the q tiles that
//   see it, with dK and dV in registers (no atomics, the same sums in the
//   same order on every run); a dq kernel with the forward's traversal.
//   Blocks start heaviest first: the last q tiles of the forward and dq,
//   the first kv tiles of dk/dv, under a causal mask.
// ===========================================================================

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int PANEL_ROW = 128;   // bytes of one row of a 64-column panel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the cp.async writes (generic proxy) become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler off the registers an async wgmma writes (its
// accumulator) or reads (A fragments) until the wait for it: called after
// the wait, these make the registers live and changed at that point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile at `addr`
// (1024-byte aligned but for the k-step's offset inside a row).  K-major
// (Q K^T's operands): 8-row groups 1024 bytes apart (SBO), LBO unused.
// MN-major (the B of P V and friends): SBO the same 8-row (k) groups, LBO
// the stride between 64-column panels (N > 64).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments (m64k16, one per k-step of 16 columns) of a 64 x 64
// accumulator, rounded to bf16: the accumulator of m64nN holds, for each
// 8-column group j, (row, 8j + 2t..+1) and (row + 8, ...), which is the
// A layout of two 8-column halves of a k-step.
__device__ __forceinline__ void to_a_frags(const float (&s)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// D (+)= A B, m64nNk16, A and B from shared memory, both K-major.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
// D += A B, m64nNk16, A from registers, B from shared memory MN-major.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Rows row0 .. row0+R-1 of a row-major [S, D] bf16 matrix into ceil(D/64)
// swizzled panels of R rows at `dst`, NT threads; rows at or past S are
// zero-filled.
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row0, int S) {
  constexpr int CPR = D / 8;          // 16-byte chunks a row
#pragma unroll
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = i - r * CPR;
    const int g = row0 + r;
    const bool ok = g < S;
    const uint32_t off = (c >> 3) * (R * PANEL_ROW) + r * PANEL_ROW +
                         (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off, src + (long long)(ok ? g : 0) * D + c * 8, ok);
  }
}

// Whether query row qpos sees key row kpos under the mask (both inside S).
__device__ __forceinline__ bool seen(int qpos, int kpos, int S, int causal,
                                     int has_window, int window) {
  const int diff = qpos - kpos;
  return qpos < S && kpos < S && (!causal || diff >= 0) &&
         (!has_window || diff < window);
}

// The kv tiles [first, last] of 64 rows a block of q rows [q0, q0 + rows)
// reads.
__device__ __forceinline__ void kv_range(int q0, int rows, int S, int causal,
                                         int has_window, int window,
                                         int& first, int& last) {
  last = (S + 63) / 64 - 1;
  if (causal) last = min(last, (q0 + rows - 1) / 64);
  first = 0;
  if (has_window) {
    const int lo = q0 - window + 1;   // first key row q0 may see
    first = lo > 0 ? lo / 64 : 0;
  }
}

// Whether a warpgroup's 64 q rows from qw0 see nothing of the kv tile at
// k0 (skip it), and whether they see only part of it (mask it).
__device__ __forceinline__ bool tile_hidden(int qw0, int k0, int S, int causal,
                                            int has_window, int window) {
  return qw0 >= S || (causal && k0 > qw0 + 63) ||
         (has_window && k0 + 63 <= qw0 - window);
}
__device__ __forceinline__ bool tile_partial(int qw0, int k0, int S,
                                             int causal, int has_window,
                                             int window) {
  return (causal && k0 + 63 > qw0) ||
         (has_window && qw0 + 63 - k0 >= window) || k0 + 64 > S;
}

// One step of the online softmax on a 64 x 64 score tile in registers
// (rows r0 and r0 + 8 of the thread, columns as in to_a_frags): scale into
// log2 units, mask when `part`, the new running max m (quad shuffles) and
// m_safe, p = exp2(x - m_safe) rounded to bf16 A fragments `pa`, l rescaled
// and summed (quad-partial), and `corr`, the factor the output
// accumulator is to be rescaled by.
__device__ __forceinline__ void softmax_step(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&corr)[2],
    uint32_t (&pa)[4][4], bool part, int r0, int k0, int c0, int S,
    int causal, int has_window, int window, float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = s[i] * sl2;
    if (part && !seen(r0 + ((i >> 1) & 1) * 8, k0 + (i >> 2) * 8 + c0 +
                      (i & 1), S, causal, has_window, window))
      x = -INFINITY;
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float ms[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // m_safe
    corr[r] = exp2_approx(m[r] - ms[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = exp2_approx(s[i] - ms[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
  to_a_frags(s, pa);
}

// Forward.  A block owns 128 q rows of one (head, batch row): two
// warpgroups of 64 rows, sharing K and V tiles of 64 rows, each in a ring
// of two shared-memory buffers.  Each warpgroup overlaps the softmax of
// kv tile j with the tensor cores' P V of tile j-1: per step it issues
// S_j = Q K_j^T (d/16 wgmma k-steps) and O += P_{j-1} V_{j-1} (4 k-steps,
// P from registers), waits for S_j alone, runs the softmax on S_j's
// fragments while P V runs, then waits for P V and rescales O.  So K_j
// and V_{j-1} are needed together: the step loads K_{j+1} and V_j, one
// step ahead.  Shared memory at d=128: Q 32 KB, K and V 2 x 16 KB each.
template <int D>
__global__ void __launch_bounds__(256, 2)
    attn_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   float* __restrict__ lse, int B, int H, int Hkv, int S,
                   float scale, int causal, int has_window, int window) {
  constexpr int NP = (D + 63) / 64;
  constexpr int QP = 128 * PANEL_ROW;      // a Q panel
  constexpr int KV = NP * 64 * PANEL_ROW;  // a K or V tile
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t Qs = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t Kb = Qs + NP * QP;        // K of tile kt at Kb + (kt&1) KV
  const uint32_t Vb = Kb + 2 * KV;         // V likewise

  const int BH = B * H;
  const int nq = (S + 127) / 128;
  int iq = blockIdx.x / BH;
  const int bh = blockIdx.x - iq * BH;
  if (causal) iq = nq - 1 - iq;            // the heaviest q tiles first
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = iq * 128;
  const bf16* qg = q + (long long)(b * H + h) * S * D;
  const bf16* kg = k + (long long)(b * Hkv + hk) * S * D;
  const bf16* vg = v + (long long)(b * Hkv + hk) * S * D;

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + warp * 16 + (lane >> 2);   // rows r0 and r0 + 8
  const int c0 = (lane & 3) * 2;
  int kt_begin, kt_end;
  kv_range(q0, 128, S, causal, has_window, window, kt_begin, kt_end);

  load_tile<128, D, 256>(Qs, qg, q0, S);
  load_tile<64, D, 256>(Kb + (kt_begin & 1) * KV, kg, kt_begin * 64, S);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t pa[4][4];     // P of the previous tile, not yet times its V
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = 0u;
  float s[32];

  // Every warpgroup runs every kv tile of the block, a tile it cannot see
  // fully masked (P = 0, O unchanged): no wgmma sits in a branch, which
  // would make the compiler serialize them.
  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();   // K_kt and V_{kt-1} landed; S_{kt-1}, P V_{kt-2} done
    if (kt < kt_end)
      load_tile<64, D, 256>(Kb + ((kt + 1) & 1) * KV, kg, (kt + 1) * 64, S);
    load_tile<64, D, 256>(Vb + (kt & 1) * KV, vg, kt * 64, S);
    cp_async_commit();
    const int k0 = kt * 64;
    const uint32_t Ks = Kb + (kt & 1) * KV;
    // on the first tile P is 0 and Q's (finite) tile stands in for V
    const uint32_t Vp = kt > kt_begin ? Vb + ((kt - 1) & 1) * KV : Qs;

#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * QP + wg * 64 * PANEL_ROW + (kk & 3) * 32;
      const uint32_t bo = (kk >> 2) * 64 * PANEL_ROW + (kk & 3) * 32;
      wgmma_ss<64>(s, desc(Qs + a, 16), desc(Ks + bo, 16), kk > 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, pa[kk], desc(Vp + kk * 16 * PANEL_ROW, 64 * PANEL_ROW));
    wg_commit();
    wg_wait<1>();      // S_kt; P V_{kt-1} still running
    fence_regs(s);
    float corr[2];
    uint32_t pn[4][4];
    softmax_step(s, m, l, corr, pn,
                 tile_partial(qw0, k0, S, causal, has_window, window), r0,
                 k0, c0, S, causal, has_window, window, sl2);
    wg_wait<0>();
    fence_regs(acc);
    fence_frags(pa);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pn[kk][x];
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();     // V of the last tile landed
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<D>(acc, pa[kk], desc(Vb + (kt_end & 1) * KV +
                                  kk * 16 * PANEL_ROW, 64 * PANEL_ROW));
  wg_commit();
  wg_wait<0>();
  fence_regs(acc);
  fence_frags(pa);

  bf16* og = o + (long long)(b * H + h) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / den;
    bf16* orow = og + (long long)row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0) {
      const float ms = m[r] == -INFINITY ? 0.f : m[r];
      lse[(long long)(b * H + h) * S + row] = ms * LN2 + logf(den);
    }
  }
}

// dq.  The forward's traversal: a block owns 128 q rows (two warpgroups)
// of one (head, batch row) with Q and dO in shared memory, and streams the
// K/V tiles.  Per tile: S = Q K^T and dP = dO V^T, P = exp(scale S - lse),
// dS = P (dP - Delta) rounded to bf16, dQ += dS K.  Shared memory at
// d=128: Q and dO 64 KB, K/V 2 x 32 KB; one block an SM.
template <int D>
__global__ void __launch_bounds__(256, 1)
    attn_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq,
                      int B, int H, int Hkv, int S, float scale, int causal,
                      int has_window, int window) {
  constexpr int NP = (D + 63) / 64;
  constexpr int QP = 128 * PANEL_ROW;
  constexpr int KV = NP * 64 * PANEL_ROW;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t Qs = (smem_u32(tc_smem) + 1023u) & ~1023u;
  const uint32_t dOs = Qs + NP * QP;
  const uint32_t KVs = dOs + NP * QP;

  const int BH = B * H;
  const int nq = (S + 127) / 128;
  int iq = blockIdx.x / BH;
  const int bh = blockIdx.x - iq * BH;
  if (causal) iq = nq - 1 - iq;
  const int h = bh % H, b = bh / H;
  const int hk = h / (H / Hkv);
  const int q0 = iq * 128;
  const long long qo = (long long)(b * H + h) * S * D;
  const long long ro = (long long)(b * H + h) * S;
  const bf16* kg = k + (long long)(b * Hkv + hk) * S * D;
  const bf16* vg = v + (long long)(b * Hkv + hk) * S * D;

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int qw0 = q0 + wg * 64;
  const int r0 = qw0 + warp * 16 + (lane >> 2);
  const int c0 = (lane & 3) * 2;
  int kt_begin, kt_end;
  kv_range(q0, 128, S, causal, has_window, window, kt_begin, kt_end);

  load_tile<128, D, 256>(Qs, q + qo, q0, S);
  load_tile<128, D, 256>(dOs, dout + qo, q0, S);
  load_tile<64, D, 256>(KVs, kg, kt_begin * 64, S);
  load_tile<64, D, 256>(KVs + KV, vg, kt_begin * 64, S);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    lr[r] = row < S ? lse[ro + row] * LOG2E : 0.f;
    dr[r] = row < S ? delta[ro + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int kt = kt_begin; kt <= kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (kt < kt_end) {
      const uint32_t nxt = KVs + (st ^ 1) * 2 * KV;
      load_tile<64, D, 256>(nxt, kg, (kt + 1) * 64, S);
      load_tile<64, D, 256>(nxt + KV, vg, (kt + 1) * 64, S);
    }
    cp_async_commit();
    const int k0 = kt * 64;
    if (tile_hidden(qw0, k0, S, causal, has_window, window)) continue;
    const uint32_t Ks = KVs + st * 2 * KV, Vs = Ks + KV;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk >> 2) * QP + wg * 64 * PANEL_ROW + (kk & 3) * 32;
      const uint32_t bo = (kk >> 2) * 64 * PANEL_ROW + (kk & 3) * 32;
      wgmma_ss<64>(s, desc(Qs + a, 16), desc(Ks + bo, 16), kk > 0);
      wgmma_ss<64>(dp, desc(dOs + a, 16), desc(Vs + bo, 16), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool part = tile_partial(qw0, k0, S, causal, has_window, window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(s[i] * sl2 - lr[r]);
      if (part && !seen(r0 + 8 * r, k0 + (i >> 2) * 8 + c0 + (i & 1), S,
                        causal, has_window, window))
        p = 0.f;
      s[i] = p * (dp[i] - dr[r]);
    }
    uint32_t da[4][4];
    to_a_frags(s, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(acc, da[kk], desc(Ks + kk * 16 * PANEL_ROW, 64 * PANEL_ROW));
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    fence_frags(da);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
    bf16* drow = dq + qo + (long long)row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + j * 8 + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                acc[4 * j + 2 * r + 1] * scale);
  }
}

// dk and dv.  A block (one warpgroup) owns 64 kv rows of one (kv head,
// batch row) with K and V in shared memory, and loops over the H/Hkv
// query heads of its group and the q tiles of 64 rows that see its keys,
// Q, dO, lse and Delta streaming through two stages.  Per step: S^T = K
// Q^T and dP^T = V dO^T, P^T = exp(scale S^T - lse), dS^T = P^T (dP^T -
// Delta), then dV += P^T dO and dK += dS^T Q with P^T and dS^T (bf16)
// from registers.  dK and dV stay in registers over the whole loop: the
// GQA sum needs no atomics.  Shared memory at d=128: K and V 32 KB, Q/dO 2
// x 32 KB; 2 blocks an SM.
template <int D>
__global__ void __launch_bounds__(128, 2)
    attn_bwd_dkdv_wgmma(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                        int H, int Hkv, int S, float scale, int causal,
                        int has_window, int window) {
  constexpr int NP = (D + 63) / 64;
  constexpr int T = NP * 64 * PANEL_ROW;   // a 64-row tile
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const uint32_t raw = smem_u32(tc_smem);
  const uint32_t Ks = (raw + 1023u) & ~1023u;
  const uint32_t Vs = Ks + T;
  const uint32_t QdOs = Vs + T;            // stage st: Q, then dO
  const uint32_t LDs = QdOs + 4 * T;       // stage st: lse[64], Delta[64]
  const float* LDg = reinterpret_cast<const float*>(tc_smem + (LDs - raw));

  const int BHk = B * Hkv;
  const int ik = blockIdx.x / BHk;         // kv tile 0 (the heaviest) first
  const int bhk = blockIdx.x - ik * BHk;
  const int hk = bhk % Hkv, b = bhk / Hkv;
  const int G = H / Hkv;
  const int k0 = ik * 64;
  const int nq = (S + 63) / 64;
  const int qt_begin = causal ? ik : 0;
  int qt_end = nq - 1;
  if (has_window) {
    const long long last = (long long)k0 + 63 + window - 1;
    if (last / 64 < qt_end) qt_end = (int)(last / 64);
  }
  const int nqt = qt_end - qt_begin + 1;
  const int steps = G * nqt;
  const long long ko = (long long)(b * Hkv + hk) * S * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr0 = k0 + warp * 16 + (lane >> 2);   // kv rows kr0, kr0 + 8
  const int c0 = (lane & 3) * 2;

  auto load_step = [&](int it, int st) {
    const int h = hk * G + it / nqt;
    const int qrow = (qt_begin + it % nqt) * 64;
    const long long qo = (long long)(b * H + h) * S * D;
    const long long ro = (long long)(b * H + h) * S;
    const uint32_t dst = QdOs + st * 2 * T;
    load_tile<64, D, 128>(dst, q + qo, qrow, S);
    load_tile<64, D, 128>(dst + T, dout + qo, qrow, S);
    const int i = threadIdx.x & 63;
    const bool ok = qrow + i < S;
    const float* src = (threadIdx.x < 64 ? lse : delta) + ro +
                       (ok ? qrow + i : 0);
    cp_async4(LDs + st * 512 + (threadIdx.x >> 6) * 256 + i * 4, src, ok);
  };

  load_tile<64, D, 128>(Ks, k + ko, k0, S);
  load_tile<64, D, 128>(Vs, v + ko, k0, S);
  load_step(0, 0);
  cp_async_commit();

  const float sl2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

  for (int it = 0; it < steps; ++it) {
    const int st = it & 1;
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (it + 1 < steps) load_step(it + 1, st ^ 1);
    cp_async_commit();
    const int q0 = (qt_begin + it % nqt) * 64;
    const uint32_t Qs = QdOs + st * 2 * T, dOs = Qs + T;
    const float* Lr = LDg + st * 128;      // lse of the tile's rows
    const float* Dr = Lr + 64;             // Delta

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 64 * PANEL_ROW + (kk & 3) * 32;
      wgmma_ss<64>(s, desc(Ks + off, 16), desc(Qs + off, 16), kk > 0);
      wgmma_ss<64>(dp, desc(Vs + off, 16), desc(dOs + off, 16), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // rows: kv positions; columns: q positions
    const bool part = (causal && q0 < k0 + 63) ||
                      (has_window && q0 + 63 - k0 >= window) ||
                      q0 + 64 > S || k0 + 64 > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + c0 + (i & 1);
      float p = exp2_approx(s[i] * sl2 - Lr[col] * LOG2E);
      if (part && !seen(q0 + col, kr0 + ((i >> 1) & 1) * 8, S, causal,
                        has_window, window))
        p = 0.f;
      dp[i] = p * (dp[i] - Dr[col]);
      s[i] = p;
    }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dva, pa[kk], desc(dOs + kk * 16 * PANEL_ROW, 64 * PANEL_ROW));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(dka, da[kk], desc(Qs + kk * 16 * PANEL_ROW, 64 * PANEL_ROW));
    wg_commit();
    wg_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    fence_frags(pa);
    fence_frags(da);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr0 + 8 * r;
    if (row >= S) continue;
    bf16* krow = dk + ko + (long long)row * D;
    bf16* vrow = dv + ko + (long long)row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(krow + j * 8 + c0) =
          __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale,
                                dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + j * 8 + c0) =
          __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// Delta[row] = sum_c dO[row][c] O[row][c] in f32: 16 bytes of O and of dO
// a lane, D/8 lanes a row padded to LPR, the next power of two (4, 8 or
// 16), so that a row's lanes are aligned within one warp and the xor tree
// sums exactly them (D = 80 and 96 have 10 and 12 lanes of data; the pad
// lanes add 0).
template <int D>
__global__ void __launch_bounds__(256)
    bwd_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
              float* __restrict__ delta, long long rows) {
  constexpr int LPR = D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16;
  static_assert(D / 8 <= LPR && LPR <= 16, "a row within a half-warp");
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / LPR;
  const int c = threadIdx.x % LPR;
  float s = 0.f;
  if (row < rows && c < D / 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + row * D + c * 8);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + row * D + c * 8);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(g2[i]);
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) delta[row] = s;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Hkv, int S, float scale,
                       int causal, int has_window, int window,
                       cudaStream_t stream) {
  constexpr int NP = (D + 63) / 64;
  const int smem = NP * (128 + 4 * 64) * PANEL_ROW + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = (S + 127) / 128 * H * B;
  attn_fwd_wgmma<D><<<grid, 256, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, B, H, Hkv, S,
      scale, causal, has_window, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       void* dq, void* dk, void* dv, float* delta, int B,
                       int H, int Hkv, int S, float scale, int causal,
                       int has_window, int window, cudaStream_t stream) {
  constexpr int NP = (D + 63) / 64;
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  const long long rows = (long long)B * H * S;
  constexpr int LPR = D / 8 <= 4 ? 4 : D / 8 <= 8 ? 8 : 16;
  bwd_delta<D><<<(int)((rows * LPR + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), do_, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_kv = NP * 6 * 64 * PANEL_ROW + 2 * 512 + 1024;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_kv);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_wgmma<D><<<(S + 63) / 64 * Hkv * B, 128, smem_kv, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, H, Hkv, S, scale, causal, has_window, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = NP * (2 * 128 + 4 * 64) * PANEL_ROW + 1024;
  err = cudaFuncSetAttribute(attn_bwd_dq_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma<D><<<(S + 127) / 128 * H * B, 256, smem_q, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dq), B, H, Hkv, S,
      scale, causal, has_window, window);
  return cudaGetLastError();
}

cudaError_t dispatch_fwd(int D, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int H, int Hkv, int S,
                         float scale, int causal, int has_window, int window,
                         cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_fwd<32>(q, k, v, o, lse, B, H, Hkv, S, scale, causal,
                            has_window, window, stream);
    case 64:
      return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, S, scale, causal,
                            has_window, window, stream);
    case 80:
      return launch_fwd<80>(q, k, v, o, lse, B, H, Hkv, S, scale, causal,
                            has_window, window, stream);
    case 96:
      return launch_fwd<96>(q, k, v, o, lse, B, H, Hkv, S, scale, causal,
                            has_window, window, stream);
    case 128:
      return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, S, scale, causal,
                             has_window, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bwd(int D, const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         void* dq, void* dk, void* dv, float* delta, int B,
                         int H, int Hkv, int S, float scale, int causal,
                         int has_window, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_bwd<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                            Hkv, S, scale, causal, has_window, window, stream);
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                            Hkv, S, scale, causal, has_window, window, stream);
    case 80:
      return launch_bwd<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                            Hkv, S, scale, causal, has_window, window, stream);
    case 96:
      return launch_bwd<96>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                            Hkv, S, scale, causal, has_window, window, stream);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H,
                             Hkv, S, scale, causal, has_window, window,
                             stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// C entries, bound with ctypes.  Pointers are device pointers of contiguous
// tensors; dtype 0 is float32, 1 is bfloat16.  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after its launches.

// The forward; `lse` ([B, H, S] f32, the rows' log-sum-exp for the
// backward) may be null, as it is when serving.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int H, int Hkv,
                                   int S, int D, int dtype, int causal,
                                   int has_window, int window, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, o, lse, B, H, Hkv, S, scale,
                                causal, has_window, window, st);
  if (dtype == 1)   // the tensor-core kernels, and only they
    return (int)tc::dispatch_fwd(D, q, k, v, o, lse, B, H, Hkv, S, scale,
                                 causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B, H, S, D], dk and dv [B, Hkv, S, D] in the inputs'
// dtype from q, k, v, the forward's o and lse, and dout; `delta` is [B, H,
// S] f32 scratch.  Head dims 32, 64, 80, 96 and 128, as the forward.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const float* lse, void* dq, void* dk,
                                   void* dv, float* delta, int B, int H,
                                   int Hkv, int S, int D, int dtype,
                                   int causal, int has_window, int window,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_bwd<float>(D, q, k, v, o, dout, lse, dq, dk, dv,
                                    delta, B, H, Hkv, S, scale, causal,
                                    has_window, window, st);
  if (dtype == 1)
    return (int)tc::dispatch_bwd(D, q, k, v, o, dout, lse, dq, dk, dv, delta,
                                 B, H, Hkv, S, scale, causal, has_window,
                                 window, st);
  return (int)cudaErrorInvalidValue;
}
