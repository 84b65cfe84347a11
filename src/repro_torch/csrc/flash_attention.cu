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
// Three launches: fa_bwd_delta computes Delta; fa_bwd_dkdv writes dk and
// dv, one block per (kv tile of 64 rows, kv head, batch row) looping over
// the H/Hkv query heads of its group and the q tiles the mask lets see the
// tile, so the GQA sum stays inside one block (no atomics, deterministic);
// fa_bwd_dq writes dq, one block per (q tile, head, batch row) with the
// forward's traversal of kv tiles.  Everything is f32 on the CUDA cores for
// both dtypes, as in the forward, with the same thread layout: thread (tx,
// ty) owns tile rows ty+16i and columns tx+16j of every 64 x 64 product and
// rows ty+16i, columns tx+16c of its accumulators.
//
// What bounds it at the training slice's shape (B=4, H=32, Hkv=8, S=512,
// d=128, bf16, causal): it reads q, k, v, o, dO and lse and writes dq, dk,
// dv, about 84 MB, 25 us at 3.35 TB/s; the causal products (q k^T and
// dO V^T recomputed, dV, dK, dQ) are about 21.5 GFLOP, 22 us on the bf16
// tensor cores.  On the f32 CUDA cores the products alone take at least
// 0.32 ms; tensor-core products are later work.  Shared memory at d=128:
// four 64 x 132 f32 tiles and one 64 x 68 tile, 153 KB, one block an SM.
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
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B,
                                H, Hkv, S, scale, causal, has_window, window,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

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
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv, S,
                                        scale, causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B, H, S, D], dk and dv [B, Hkv, S, D] in the inputs'
// dtype from q, k, v, the forward's o and lse, and dout; `delta` is [B, H,
// S] f32 scratch.  Head dims 32, 64 and 128.
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
    return (int)dispatch_bwd<__nv_bfloat16>(D, q, k, v, o, dout, lse, dq, dk,
                                            dv, delta, B, H, Hkv, S, scale,
                                            causal, has_window, window, st);
  return (int)cudaErrorInvalidValue;
}
