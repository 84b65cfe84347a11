// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py
// (mamba2_chunk_scan -> pl.pallas_call, body _kernel).  Same function:
// xdt [B,H,L,P], Bm, Cm [B,G,L,N] (f32 or bf16), a [B,H,L] f32 log-decays
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
// 256 KB of C B^T) would not fit in 227 KB of shared memory; ssd_scan's
// 64-row tiles of x, B, C and G in f32 are 17 KB each at P = N = 64 (rows
// padded by 4 floats against bank conflicts), 87 KB with the [P,N] state,
// set with cudaFuncAttributeMaxDynamicSharedMemorySize.  A ragged last
// tile (any L) is masked by both kernels: rows past L load as x = B = C =
// 0 and a = 0, so they add nothing to y or to the state and decay nothing.
//
// Two kernels, picked by dtype.  Both read Bm and Cm once per group:
// they are [B, G, L, N] with H % G == 0, and head h reads group
// h / (H / G), as K1's query head reads its kv head (G = H is the TPU
// kernel's own contract; zamba2-2.7b has G = 1 and 80 heads).
//
// f32: ssd_scan, every product in f32 on the CUDA cores (f32 inputs must
// match their plain version to 2e-4).  One thread block per (b, h): the
// TPU kernel's sequential innermost grid axis over chunks, with the state
// in VMEM scratch, becomes a loop inside the block over the sequence, with
// the state in shared memory (CUDA blocks run in no order, so nothing can
// be carried between blocks).  256 threads: thread (tx, ty), tx, ty in
// 0..15, owns rows ty + 16 i of G and y, columns tx + 16 j of G and
// tx + 16 c of y, and the state entries (ty + 16 i, tx + 16 j).  The final
// state is written once, after the last tile.
//
// bf16: ssd_scan_mma, on the tensor cores (below, namespace tc).
//
// What bounds them on an H100 at the serving slice's shape (bf16, B=4,
// H=80, L=512, P=N=64, G=1): xdt (21.0 MB), a (0.66 MB) and Bm, Cm once
// per group (0.26 MB each) read, y (21.0 MB) and the state (5.2 MB)
// written: 48.4 MB, 14.4 us at 3.35 TB/s.  With Bm and Cm per head (G = H)
// they are 21.0 MB each: 89.8 MB, 26.8 us.  The products are 5.4 GFLOP
// with 64-row tiles (13.4 with the TPU kernel's 256-row chunks), 5.5 us on
// the bf16 tensor cores.  So bytes bound it.  ssd_scan computes every
// product on the CUDA cores, whose 67 TFLOP/s take about 80 us for 5.4
// GFLOP; ssd_scan_mma is the bf16 route's answer (see its note).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int T = 64;        // rows per tile
constexpr int NT = 256;      // threads per block
constexpr int LDG = T + 4;   // padded row of G

// Rows row0 .. row0+T-1 of a row-major [L, D] matrix into dst[T][D+4];
// rows at or past L are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int L) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < T * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int g = row0 + r;
    dst[r * LD + c] = g < L ? src[(long long)g * D + c] : 0.f;
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NT, 2)
    ssd_scan(const float* __restrict__ xdt, const float* __restrict__ a,
             const float* __restrict__ Bm, const float* __restrict__ Cm,
             float* __restrict__ y, float* __restrict__ state, int H, int G,
             int L) {
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
  const int b = bh / H, h = bh - b * H;
  const long long grp = (long long)b * G + h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const float* ab = a + (long long)bh * L;
  const float* xb = xdt + (long long)bh * L * P;
  const float* bb = Bm + grp * L * N;
  const float* cb = Cm + grp * L * N;
  float* yb = y + (long long)bh * L * P;

  for (int idx = tid; idx < P * LDN; idx += NT) Ss[idx] = 0.f;

  const int ntiles = (L + T - 1) / T;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * T;
    __syncthreads();  // the previous tile's reads and state writes are done
    load_tile<P>(Xs, xb, t0, L);
    load_tile<N>(Bs, bb, t0, L);
    load_tile<N>(Cs, cb, t0, L);
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
          float* yrow = yb + (long long)(t0 + t) * P;
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            yrow[tx + 16 * c] = fmaf(dec, off[i][c], acc[i][c]);
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

// ===========================================================================
// bf16 on the tensor cores: ssd_scan_mma.
//
// Grid: one block of 128 threads per (b, h), as ssd_scan, and the loop
// over 64-row tiles (the sequential axis) stays in the block, with the
// state in registers in f32.  At the serve shape that is 320 blocks of
// 72.5 KB of shared memory, three to an SM: one wave on 132 SMs.  A split
// of P over blocks (32 or 16 columns a block, C B^T recomputed in each:
// 640 or 1280 blocks) was slower in throwaway builds on the H100, and so
// was a third load stage (two blocks to an SM): more, smaller blocks did
// not pay for the products they repeat.
//
// Loads: cp.async 16-byte copies of the x, B and C tiles (bf16)
// and a into a ring of two stages, so tile i+1 is in flight while tile i
// computes; one __syncthreads a tile.  Rows at or past L are zero-filled
// (x = B = C = 0, a = 0).  Every warp scans a itself (warp shuffles) and
// keeps the tile's cumsum in registers, two rows a lane, in log2 units,
// so that every exp is one ex2.approx.
//
// Products: mma.sync m16n8k16 bf16 with f32 accumulation, fragments from
// ldmatrix (.trans where the operand is stored k-major).  Warp w owns rows
// 16w..16w+15 of the tile:
//   y   = exp(cs) (.) (C S^T)  (K = N; S, the state before the tile, is
//         rounded to bf16 once a tile into shared memory)
//       + G x                  (K = s, only the 16-row blocks s <= t: G is
//         made a 16-column block at a time from C B^T, decayed and masked
//         by a select, and rounded to bf16 from the accumulator fragments,
//         as flash attention makes P)
// and the state update S <- exp(cs[T-1]) S + (x (.) w)^T B, w_s =
// exp(cs[T-1] - cs[s]), splits the [P, N] state's 16 x 8 tiles among the
// four warps; (x (.) w) is rounded to bf16.  Two state buffers in shared
// memory alternate between tiles, so the write of the new state never
// meets a read of the old one.
//
// Why mma.sync and not wgmma: the products are 64 x {16, 32, 64} x 64 and
// bytes bound the kernel (48.4 MB against 5.4 GFLOP at the serve shape);
// what it needs is loads overlapped with work and a full card, not the
// last factor of tensor-core rate.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NW = 4;           // warps a block
constexpr int NTC = 32 * NW;    // threads a block
constexpr int ST = 2;           // stages of the load ring
constexpr unsigned FULL = 0xffffffffu;

template <int P, int N>
struct Cfg {
  static constexpr int NK = N < 16 ? 16 : N;  // the state dim padded to k16
  // row pitches in bf16: an odd number of 16-byte words, so the 8 rows of
  // an ldmatrix fall in 8 different bank groups; a row of the C tile also
  // holds a row of y on its way out
  static constexpr int LDX = P + 8;
  static constexpr int LDB = (NK > P ? NK : P) + 8;
  static constexpr int XB = T * LDX * 2;      // bytes of the x tile
  static constexpr int BB = T * LDB * 2;      // of the B tile, of the C tile
  static constexpr int STAGE = XB + 2 * BB + T * 4;
  static constexpr int SB = P * LDB * 2;      // of a bf16 copy of the state
  static constexpr int SMEM = ST * STAGE + 2 * SB;
  static constexpr int PN = P / 8;            // 8-column tiles of y
  static constexpr int MT = P / 16;           // 16-row tiles of the state
  static constexpr int NTN = N / 8;           // 8-column tiles of the state
  static constexpr int SPW = (MT * NTN + NW - 1) / NW;  // state tiles a warp
  static_assert(P % 16 == 0 && N % 8 == 0 && NTN % SPW == 0, "layout");
};

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
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// a bf16 pair times (lo, hi), rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16(uint32_t v, float lo,
                                               float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16(f.x * lo, f.y * hi);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
}
// d += a b, m16n8k16, bf16 in, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Ldmatrix lane addresses (element offsets into a bf16 tile of pitch LD)
// for the four 8 x 8 matrices of a 16 x 16 block at (r0, c0):
// A of a row-major [m][k] tile: a0..a3 = (m0, k0), (m0+8, k0), (m0, k0+8),
// (m0+8, k0+8).
template <int LD>
__device__ __forceinline__ int a_off(int lane, int m0, int k0) {
  return (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8;
}
// B of two 8-column tiles n0, n0+8, stored [n][k] (k contiguous): b0, b1
// of tile n0, then of tile n0 + 8.
template <int LD>
__device__ __forceinline__ int b_off(int lane, int n0, int k0) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8;
}
// .trans: B of two 8-column tiles stored [k][n] (n contiguous), the same
// register order; with x2, the one tile at n0.
template <int LD>
__device__ __forceinline__ int bt_off(int lane, int k0, int n0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8;
}
// .trans: A stored [k][m] (m contiguous), the A register order.
template <int LD>
__device__ __forceinline__ int at_off(int lane, int k0, int m0) {
  return (k0 + (lane & 7) + (lane >> 4) * 8) * LD + m0 + ((lane >> 3) & 1) * 8;
}

// One tile's x [T][P], B and C [T][N] and a [T] into a stage.
template <int P, int N>
__device__ __forceinline__ void load_stage(uint32_t st, const bf16* xb,
                                           const float* ab, const bf16* bb,
                                           const bf16* cb, int t0, int L) {
  using C = Cfg<P, N>;
  // 16-byte words a row; B and C are loaded NK wide, the pad (N < 16)
  // zero-filled, since a row of C also carries y out
  constexpr int XC = P / 8, BC = C::NK / 8;
#pragma unroll
  for (int i = threadIdx.x; i < T * XC; i += NTC) {
    const int r = i / XC, c = i - r * XC, g = t0 + r;
    const bool ok = g < L;
    cp_async16(st + (r * C::LDX + c * 8) * 2,
               xb + (long long)(ok ? g : 0) * P + c * 8, ok);
  }
  const uint32_t bs = st + C::XB, cs = bs + C::BB;
#pragma unroll
  for (int i = threadIdx.x; i < T * BC; i += NTC) {
    const int r = i / BC, c = i - r * BC, g = t0 + r;
    const bool ok = g < L && c < N / 8;
    const long long off = (long long)(ok ? g : 0) * N + (ok ? c * 8 : 0);
    cp_async16(bs + (r * C::LDB + c * 8) * 2, bb + off, ok);
    cp_async16(cs + (r * C::LDB + c * 8) * 2, cb + off, ok);
  }
  if (threadIdx.x < T) {
    const int g = t0 + threadIdx.x;
    cp_async4(cs + C::BB + threadIdx.x * 4, ab + (g < L ? g : 0), g < L);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NTC, 3)
    ssd_scan_mma(const bf16* __restrict__ xdt, const float* __restrict__ a,
                 const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                 bf16* __restrict__ y, float* __restrict__ state, int H,
                 int G, int L) {
  using C = Cfg<P, N>;
  extern __shared__ uint4 smem_words[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_words);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const long long grp = (long long)b * G + h / (H / G);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const bf16* xb = xdt + (long long)bh * L * P;
  const float* ab = a + (long long)bh * L;
  const bf16* bb = Bm + grp * L * N;
  const bf16* cb = Cm + grp * L * N;
  bf16* yb = y + (long long)bh * L * P;
  const uint32_t ring = smem_u32(smem);
  unsigned char* sbuf = smem + ST * C::STAGE;   // two bf16 [P][LDB] states

  // zero all of it: the state starts at 0, and its pad columns (N < 16)
  // are never written
  for (int i = threadIdx.x; i < C::SMEM / 16; i += NTC)
    smem_words[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const int ntiles = (L + T - 1) / T;
  load_stage<P, N>(ring, xb, ab, bb, cb, 0, L);
  cp_async_commit();

  const int r0 = 16 * w;                        // the warp's rows of a tile
  const int q0 = w * C::SPW;                    // its first state tile
  const bool owns = q0 < C::MT * C::NTN;        // (warp-uniform)
  const int mt = q0 / C::NTN;                   // its state tiles' 16 rows
  float st[C::SPW][4] = {};                     // its state tiles, f32

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait_all();
    __syncthreads();   // tile it has landed; every read of tile it-1 is done
    if (it + 1 < ntiles)
      load_stage<P, N>(ring + ((it + 1) % ST) * C::STAGE, xb, ab, bb, cb,
                       (it + 1) * T, L);
    cp_async_commit();
    const uint32_t xs = ring + (it % ST) * C::STAGE;
    const uint32_t bs = xs + C::XB, csm = bs + C::BB;
    const float2 a2 = reinterpret_cast<const float2*>(
        smem + (it % ST) * C::STAGE + C::XB + 2 * C::BB)[lane];
    const uint32_t ss = smem_u32(sbuf + (it & 1) * C::SB);
    bf16* ss_next = reinterpret_cast<bf16*>(sbuf + ((it + 1) & 1) * C::SB);

    // inclusive cumsum of a over the tile, times log2(e): lane l holds
    // rows 2l (cs_lo) and 2l + 1 (cs_hi)
    float sum = a2.x + a2.y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, sum, off);
      if (lane >= off) sum += u;
    }
    const float cs_hi = sum * LOG2E, cs_lo = (sum - a2.y) * LOG2E;
    const int t0 = r0 + g, t1 = t0 + 8;         // this thread's two rows
    const float lo0 = __shfl_sync(FULL, cs_lo, t0 >> 1);
    const float hi0 = __shfl_sync(FULL, cs_hi, t0 >> 1);
    const float lo1 = __shfl_sync(FULL, cs_lo, t1 >> 1);
    const float hi1 = __shfl_sync(FULL, cs_hi, t1 >> 1);
    const float ct0 = (g & 1) ? hi0 : lo0, ct1 = (g & 1) ? hi1 : lo1;

    uint32_t cf[C::NK / 16][4];                 // C, rows r0.., k = state dim
#pragma unroll
    for (int kn = 0; kn < C::NK / 16; ++kn)
      ldsm_x4(cf[kn], csm + 2 * a_off<C::LDB>(lane, r0, 16 * kn));

    // y = exp(cs) (.) (C S^T) ...
    float acc[C::PN][4] = {};
#pragma unroll
    for (int kn = 0; kn < C::NK / 16; ++kn)
#pragma unroll
      for (int pp = 0; pp < C::PN / 2; ++pp) {
        uint32_t sf[4];
        ldsm_x4(sf, ss + 2 * b_off<C::LDB>(lane, 16 * pp, 16 * kn));
        mma(acc[2 * pp], cf[kn], sf[0], sf[1]);
        mma(acc[2 * pp + 1], cf[kn], sf[2], sf[3]);
      }
    const float e0 = ex2(ct0), e1 = ex2(ct1);
#pragma unroll
    for (int pn = 0; pn < C::PN; ++pn) {
      acc[pn][0] *= e0;
      acc[pn][1] *= e0;
      acc[pn][2] *= e1;
      acc[pn][3] *= e1;
    }
    // ... + G x, over the 16-column blocks of s up to the diagonal
    for (int kk = 0; kk <= w; ++kk) {
      float gacc[2][4] = {};
#pragma unroll
      for (int kn = 0; kn < C::NK / 16; ++kn) {
        uint32_t bf[4];
        ldsm_x4(bf, bs + 2 * b_off<C::LDB>(lane, 16 * kk, 16 * kn));
        mma(gacc[0], cf[kn], bf[0], bf[1]);
        mma(gacc[1], cf[kn], bf[2], bf[3]);
      }
      uint32_t ga[4];   // G's A fragment: decayed, masked, bf16
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = 16 * kk + 8 * j + 2 * c;
        const float sl = __shfl_sync(FULL, cs_lo, s >> 1);
        const float sh = __shfl_sync(FULL, cs_hi, s >> 1);
        // a select, never a product with 0: above the diagonal ex2 may be
        // inf
        const float d00 = s <= t0 ? ex2(ct0 - sl) : 0.f;
        const float d01 = s + 1 <= t0 ? ex2(ct0 - sh) : 0.f;
        const float d10 = s <= t1 ? ex2(ct1 - sl) : 0.f;
        const float d11 = s + 1 <= t1 ? ex2(ct1 - sh) : 0.f;
        ga[2 * j] = pack_bf16(gacc[j][0] * d00, gacc[j][1] * d01);
        ga[2 * j + 1] = pack_bf16(gacc[j][2] * d10, gacc[j][3] * d11);
      }
#pragma unroll
      for (int pp = 0; pp < C::PN / 2; ++pp) {
        uint32_t xf[4];
        ldsm_x4_t(xf, xs + 2 * bt_off<C::LDX>(lane, 16 * kk, 16 * pp));
        mma(acc[2 * pp], ga, xf[0], xf[1]);
        mma(acc[2 * pp + 1], ga, xf[2], xf[3]);
      }
    }
    // y leaves through the warp's own 16 rows of the C tile (in registers
    // since cf; no other warp reads them), as whole rows in 16-byte
    // stores (storing the fragments themselves writes 16 bytes of a row
    // at a time, and was slower in a throwaway build on the H100)
    bf16* ys = reinterpret_cast<bf16*>(smem + (it % ST) * C::STAGE + C::XB +
                                       C::BB) + r0 * C::LDB;
#pragma unroll
    for (int pn = 0; pn < C::PN; ++pn) {
      const int col = 8 * pn + 2 * c;
      *reinterpret_cast<uint32_t*>(ys + g * C::LDB + col) =
          pack_bf16(acc[pn][0], acc[pn][1]);
      *reinterpret_cast<uint32_t*>(ys + (g + 8) * C::LDB + col) =
          pack_bf16(acc[pn][2], acc[pn][3]);
    }
    __syncwarp();
    constexpr int YC = P / 8;                   // 16-byte words a row
#pragma unroll
    for (int i = lane; i < 16 * YC; i += 32) {
      const int r = i / YC, cw = i - r * YC, row = it * T + r0 + r;
      if (row < L)
        *reinterpret_cast<uint4*>(yb + (long long)row * P + cw * 8) =
            *reinterpret_cast<const uint4*>(ys + r * C::LDB + cw * 8);
    }

    // S <- exp(cs[T-1]) S + (x (.) w)^T B, w_s = exp(cs[T-1] - cs[s])
    const float last = __shfl_sync(FULL, cs_hi, 31);
    if (owns) {
      const float dec = ex2(last);
#pragma unroll
      for (int q = 0; q < C::SPW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[q][e] *= dec;
#pragma unroll
      for (int ks = 0; ks < T / 16; ++ks) {
        uint32_t xa[4];   // A = x^T: rows p (16 mt..), k = s
        ldsm_x4_t(xa, xs + 2 * at_off<C::LDX>(lane, 16 * ks, 16 * mt));
        const int s = 8 * ks + c;   // the lane holding rows 16 ks + 2c, +1
        const float wl = ex2(last - __shfl_sync(FULL, cs_lo, s));
        const float wh = ex2(last - __shfl_sync(FULL, cs_hi, s));
        const float wl8 = ex2(last - __shfl_sync(FULL, cs_lo, s + 4));
        const float wh8 = ex2(last - __shfl_sync(FULL, cs_hi, s + 4));
        xa[0] = scale_bf16(xa[0], wl, wh);
        xa[1] = scale_bf16(xa[1], wl, wh);
        xa[2] = scale_bf16(xa[2], wl8, wh8);
        xa[3] = scale_bf16(xa[3], wl8, wh8);
#pragma unroll
        for (int q = 0; q < C::SPW; ++q) {
          uint32_t bf[2];
          ldsm_x2_t(bf, bs + 2 * bt_off<C::LDB>(lane, 16 * ks,
                                                8 * ((q0 + q) % C::NTN)));
          mma(st[q], xa, bf[0], bf[1]);
        }
      }
      // the next tile's S, rounded to bf16 ([p][n], n contiguous)
#pragma unroll
      for (int q = 0; q < C::SPW; ++q) {
        const int n = 8 * ((q0 + q) % C::NTN) + 2 * c, p = 16 * mt + g;
        *reinterpret_cast<uint32_t*>(ss_next + p * C::LDB + n) =
            pack_bf16(st[q][0], st[q][1]);
        *reinterpret_cast<uint32_t*>(ss_next + (p + 8) * C::LDB + n) =
            pack_bf16(st[q][2], st[q][3]);
      }
    }
  }

  if (owns) {
    float* sb = state + (long long)bh * P * N;
#pragma unroll
    for (int q = 0; q < C::SPW; ++q) {
      const int n = 8 * ((q0 + q) % C::NTN) + 2 * c, p = 16 * mt + g;
      *reinterpret_cast<float2*>(sb + p * N + n) =
          make_float2(st[q][0], st[q][1]);
      *reinterpret_cast<float2*>(sb + (p + 8) * N + n) =
          make_float2(st[q][2], st[q][3]);
    }
  }
}

}  // namespace tc

// ===========================================================================
// Backward: ssd_scan_bwd and group_sum, the C entry mamba2_chunk_scan_bwd.
//
// No Pallas counterpart: the JAX package has no K2 backward, and trains
// zamba by differentiating the jnp mamba2_chunked
// (src/repro/models/ssm.py:90).  The port's forward goes through the kernel
// above, so its gradient is a kernel too.  With h_t [P, N],
//
//   forward    h_t = exp(a_t) h_{t-1} + x_t B_t^T,   y_t = h_t C_t
//   reverse    g_t = dy_t C_t^T + exp(a_{t+1}) g_{t+1}   (from dstate, or 0)
//   gradients  dx_t = g_t B_t,  dB_t = g_t^T x_t,  dC_t = h_t^T dy_t,
//              da_t = exp(a_t) <g_t, h_{t-1}>,
//
// dB and dC summed over the H/G heads of each group.  Tiled as the forward,
// T = 64 rows, with cs the inclusive cumsum of a over the tile, S0 the state
// before the tile, R the reverse state after it (the gradient reaching the
// tile's last state from later tiles, or dstate), w_t = exp(cs[T-1] -
// cs[t]), the forward's decayed products G[t,s] = (C_t . B_s) exp(cs[t] -
// cs[s]) and D[t,s] = (dy_t . x_s) exp(cs[t] - cs[s]), both for s <= t, and
// M = G o (dY X^T):
//
//   dx  = G^T dY + w (.) (B R^T)
//   dB  = D^T C  + w (.) (X R)
//   dC  = D B    + exp(cs) (.) (dY S0)
//   dcs = rowsum(M) - colsum(M) + C (.)_rows [exp(cs) (.) dY S0]
//         - X (.)_rows [w (.) B R^T], plus at the tile's last row
//         <R, S_end> = exp(cs[T-1]) <R, S0> + sum_t x_t . (w (.) B R^T)_t
//   da  = the reverse cumsum of dcs over the tile (a_t reaches every cs[k]
//         with k >= t)
//   R  <- exp(cs[T-1]) R + (exp(cs) (.) dY)^T C   (the reverse state before
//         the tile)
//
// The decay is a select on s <= t, as in the forward, never a product with
// 0.  A ragged last tile is masked as in the forward: rows past L load as
// x = B = C = dy = 0 and a = 0.
//
// Design, simple first: every product in f32 on the CUDA cores, for both
// dtypes (bf16 inputs are widened as they are loaded, every sum is f32).
// One block of 256 threads per (b, h), with the forward's thread layout;
// two passes over the sequence in the block.  Pass 1 runs the forward's
// state recurrence alone and stores the state before each tile into f32
// scratch ([B, H, tiles, P, N]); pass 2 walks the tiles in reverse with R
// in shared memory, computing every term above.  Each head's dB and dC go
// to f32 scratch ([B, H, L, N]), and group_sum adds them over each group's
// heads in head order.  No atomics anywhere: the same sums in the same order
// on every run.  Shared memory at P = N = 64: x, dy, B, C, G, D, S0 and R
// tiles of 64 x 68 f32, 141 KB: one block an SM.
//
// What bounds it on an H100 at zamba2-2.7b's train shape (bf16, B=8,
// H=80, G=1, L=512, P=N=64): xdt, dy and dx in bf16 are 42 MB each, a and
// da 1.3 MB each, B, C, dB and dC once per group 0.5 MB each: about 130 MB,
// 39 us at 3.35 TB/s.  The scratch adds 84 MB of states and 2 x 84 MB of
// per-head dB, dC, each written once and read once (mostly from L2 for
// the states: a block rereads its own 128 KB).  The products are 10 of 64 x
// 64 x 64 a tile (the forward's states again, then nine), 27 GFLOP: 0.4 ms
// at the CUDA cores' 67 TFLOP/s, 27 us on the bf16 tensor cores.  So this
// kernel is bound by its f32 products; moving them to mma.sync, as the
// forward's ssd_scan_mma did, is the redesign it awaits.

namespace bwd {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows row0 .. row0+T-1 of a row-major [L, D] matrix into dst[T][D+4] as
// f32; rows at or past L are zero.
template <typename TIn, int D>
__device__ __forceinline__ void load_rows(float* dst, const TIn* src,
                                          int row0, int L) {
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < T * D; idx += NT) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int g = row0 + r;
    dst[r * LD + c] = g < L ? to_f32(src[(long long)g * D + c]) : 0.f;
  }
}

// cs = the inclusive cumsum of a over the tile (rows past L add 0): warp 0,
// 2 rows a lane
__device__ __forceinline__ void tile_cumsum(float* cs, const float* ab,
                                            int t0, int L) {
  if (threadIdx.x < 32) {
    const int r = 2 * threadIdx.x;
    const float a0 = t0 + r < L ? ab[t0 + r] : 0.f;
    const float a1 = t0 + r + 1 < L ? ab[t0 + r + 1] : 0.f;
    float s = a0 + a1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, s, off);
      if ((int)threadIdx.x >= off) s += u;
    }
    cs[r] = s - a1;
    cs[r + 1] = s;
  }
}

// the sum over the 16 threads of a row (a half-warp); every lane calls it
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <typename TIn, int P, int N>
__global__ void __launch_bounds__(NT, 1)
    ssd_scan_bwd(const TIn* __restrict__ xdt, const float* __restrict__ a,
                 const TIn* __restrict__ Bm, const TIn* __restrict__ Cm,
                 const TIn* __restrict__ dy, const float* __restrict__ dstate,
                 TIn* __restrict__ dx, float* __restrict__ da,
                 float* __restrict__ dBh, float* __restrict__ dCh,
                 float* states, int H, int G, int L) {
  static_assert(P % 16 == 0 && N % 4 == 0, "tile layout");
  constexpr int LDP = P + 4, LDN = N + 4;
  constexpr int CPT = P / 16;            // dx columns, R rows a thread
  constexpr int NPT = (N + 15) / 16;     // dB, dC, R columns a thread
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);   // [T][LDP]
  float* Ys = Xs + T * LDP;                      // [T][LDP]  dy
  float* Bs = Ys + T * LDP;                      // [T][LDN]
  float* Cs = Bs + T * LDN;                      // [T][LDN]
  float* Gs = Cs + T * LDN;                      // [T][LDG]  G[t][s]
  float* Ds = Gs + T * LDG;                      // [T][LDG]  D[t][s]
  float* S0 = Ds + T * LDG;                      // [P][LDN]
  float* Rs = S0 + P * LDN;                      // [P][LDN]  R
  float* cs = Rs + P * LDN;                      // [T]
  float* rv = cs + T;                            // [T] rowsum - colsum of M
  float* xo = rv + T;                            // [T] x . (w (.) B R^T)
  float* co = xo + T;                            // [T] C . (exp(cs) (.) dY S0)
  float* colp = co + T;                          // [16][T] colsum partials
  float* red = colp + 16 * T;                    // [NT / 32]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const long long grp = (long long)b * G + h / (H / G);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const float* ab = a + (long long)bh * L;
  const TIn* xb = xdt + (long long)bh * L * P;
  const TIn* yb = dy + (long long)bh * L * P;
  const TIn* bb = Bm + grp * L * N;
  const TIn* cb = Cm + grp * L * N;
  const int ntiles = (L + T - 1) / T;
  float* stb = states + (long long)bh * ntiles * P * N;

  // Pass 1: the state before each tile, thread (tx, ty) owning entries
  // (ty + 16 i, tx + 16 j) in registers
  {
    float sn[CPT][NPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int j = 0; j < NPT; ++j) sn[i][j] = 0.f;
    for (int it = 0; it < ntiles; ++it) {
      const int t0 = it * T;
      float* sp = stb + (long long)it * P * N;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          if (tx + 16 * j < N) sp[(ty + 16 * i) * N + tx + 16 * j] = sn[i][j];
      __syncthreads();  // the previous tile's reads are done
      load_rows<TIn, P>(Xs, xb, t0, L);
      load_rows<TIn, N>(Bs, bb, t0, L);
      tile_cumsum(cs, ab, t0, L);
      __syncthreads();
      const float last = cs[T - 1], dec = expf(last);
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int j = 0; j < NPT; ++j) sn[i][j] *= dec;
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
    }
  }

  // Pass 2, the tiles in reverse.  R starts as dstate, or 0.
  for (int idx = tid; idx < P * N; idx += NT) {
    const int p = idx / N;
    Rs[p * LDN + idx - p * N] =
        dstate ? dstate[(long long)bh * P * N + idx] : 0.f;
  }
  for (int it = ntiles - 1; it >= 0; --it) {
    const int t0 = it * T;
    __syncthreads();  // the previous tile's reads are done, R is written
    load_rows<TIn, P>(Xs, xb, t0, L);
    load_rows<TIn, P>(Ys, yb, t0, L);
    load_rows<TIn, N>(Bs, bb, t0, L);
    load_rows<TIn, N>(Cs, cb, t0, L);
    {
      const float* sp = stb + (long long)it * P * N;
      for (int idx = tid; idx < P * N; idx += NT) {
        const int p = idx / N;
        S0[p * LDN + idx - p * N] = sp[idx];
      }
    }
    tile_cumsum(cs, ab, t0, L);
    __syncthreads();
    const float last = cs[T - 1];

    // (A) G and D, rows ty+16i, columns tx+16j; the row and column sums
    // of M = G o (dY X^T)
    {
      float cbv[4][4], dxv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cbv[i][j] = dxv[i][j] = 0.f;
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
            float v = cbv[i][j];
            v = fmaf(ca[i].x, ba[j].x, v);
            v = fmaf(ca[i].y, ba[j].y, v);
            v = fmaf(ca[i].z, ba[j].z, v);
            v = fmaf(ca[i].w, ba[j].w, v);
            cbv[i][j] = v;
          }
      }
#pragma unroll 4
      for (int p = 0; p < P; p += 4) {
        float4 ya[4], xa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ya[i] = *reinterpret_cast<const float4*>(&Ys[(ty + 16 * i) * LDP + p]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xa[j] = *reinterpret_cast<const float4*>(&Xs[(tx + 16 * j) * LDP + p]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = dxv[i][j];
            v = fmaf(ya[i].x, xa[j].x, v);
            v = fmaf(ya[i].y, xa[j].y, v);
            v = fmaf(ya[i].z, xa[j].z, v);
            v = fmaf(ya[i].w, xa[j].w, v);
            dxv[i][j] = v;
          }
      }
      float rs[4] = {0.f, 0.f, 0.f, 0.f}, cl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          // a select, never a product with 0: above the diagonal the
          // exponent is positive and may overflow
          const float decay = s <= t ? expf(cs[t] - cs[s]) : 0.f;
          const float g = cbv[i][j] * decay;
          Gs[t * LDG + s] = g;
          Ds[t * LDG + s] = dxv[i][j] * decay;
          const float m = g * dxv[i][j];
          rs[i] += m;
          cl[j] += m;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float r = row_sum(rs[i]);
        if (tx == 0) rv[ty + 16 * i] = r;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) colp[ty * T + tx + 16 * j] = cl[j];
    }
    __syncthreads();
    if (tid < T) {
      float c = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) c += colp[k * T + tid];
      rv[tid] -= c;
    }

    // (B) dx = G^T dY + w (.) (B R^T), rows ty+16i, columns tx+16c
    {
      float acc[4][CPT], off[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = off[i][c] = 0.f;
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        float gv[4], yv[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) gv[i] = Gs[s * LDG + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < CPT; ++c) yv[c] = Ys[s * LDP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(gv[i], yv[c], acc[i][c]);
      }
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 ba[4], ra[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ba[i] = *reinterpret_cast<const float4*>(&Bs[(ty + 16 * i) * LDN + n]);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          ra[c] = *reinterpret_cast<const float4*>(&Rs[(tx + 16 * c) * LDN + n]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            float v = off[i][c];
            v = fmaf(ba[i].x, ra[c].x, v);
            v = fmaf(ba[i].y, ra[c].y, v);
            v = fmaf(ba[i].z, ra[c].z, v);
            v = fmaf(ba[i].w, ra[c].w, v);
            off[i][c] = v;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float w = expf(last - cs[t]);
        float xd = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float o = w * off[i][c];
          xd = fmaf(Xs[t * LDP + tx + 16 * c], o, xd);
          if (t0 + t < L)
            store(&dx[((long long)bh * L + t0 + t) * P + tx + 16 * c],
                  acc[i][c] + o);
        }
        xd = row_sum(xd);
        if (tx == 0) xo[t] = xd;
      }
    }

    // (C) this head's dB = D^T C + w (.) (X R), rows ty+16i, columns tx+16j
    {
      float acc[4][NPT], off[4][NPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NPT; ++j) acc[i][j] = off[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        float dv[4], cv[NPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = Ds[s * LDG + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          cv[j] = tx + 16 * j < N ? Cs[s * LDN + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NPT; ++j) acc[i][j] = fmaf(dv[i], cv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float xv[4], rv2[NPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xs[(ty + 16 * i) * LDP + p];
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          rv2[j] = tx + 16 * j < N ? Rs[p * LDN + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NPT; ++j) off[i][j] = fmaf(xv[i], rv2[j], off[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float w = expf(last - cs[t]);
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int n = tx + 16 * j;
          if (n < N && t0 + t < L)
            dBh[((long long)bh * L + t0 + t) * N + n] =
                fmaf(w, off[i][j], acc[i][j]);
        }
      }
    }

    // (D) this head's dC = D B + exp(cs) (.) (dY S0), rows ty+16i,
    // columns tx+16j
    {
      float acc[4][NPT], off[4][NPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NPT; ++j) acc[i][j] = off[i][j] = 0.f;
#pragma unroll 2
      for (int s = 0; s < T; s += 4) {
        float4 da4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          da4[i] = *reinterpret_cast<const float4*>(&Ds[(ty + 16 * i) * LDG + s]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float bv[NPT];
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            bv[j] = tx + 16 * j < N ? Bs[(s + u) * LDN + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float dv = u == 0 ? da4[i].x : u == 1 ? da4[i].y
                           : u == 2 ? da4[i].z : da4[i].w;
#pragma unroll
            for (int j = 0; j < NPT; ++j) acc[i][j] = fmaf(dv, bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll 2
      for (int p = 0; p < P; p += 4) {
        float4 ya[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ya[i] = *reinterpret_cast<const float4*>(&Ys[(ty + 16 * i) * LDP + p]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float sv[NPT];
#pragma unroll
          for (int j = 0; j < NPT; ++j)
            sv[j] = tx + 16 * j < N ? S0[(p + u) * LDN + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float yv = u == 0 ? ya[i].x : u == 1 ? ya[i].y
                           : u == 2 ? ya[i].z : ya[i].w;
#pragma unroll
            for (int j = 0; j < NPT; ++j) off[i][j] = fmaf(yv, sv[j], off[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float e = expf(cs[t]);
        float cd = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int n = tx + 16 * j;
          const float o = e * off[i][j];
          if (n < N) {
            cd = fmaf(Cs[t * LDN + n], o, cd);
            if (t0 + t < L)
              dCh[((long long)bh * L + t0 + t) * N + n] = acc[i][j] + o;
          }
        }
        cd = row_sum(cd);
        if (tx == 0) co[t] = cd;
      }
    }

    // (E) R before this tile, R' = exp(cs[T-1]) R + (exp(cs) (.) dY)^T C,
    // entries (ty+16i, tx+16j), and <R, S0>
    float rn[CPT][NPT];
    {
      const float dec = expf(last);
      float gs = 0.f;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          const float r = n < N ? Rs[p * LDN + n] : 0.f;
          if (n < N) gs = fmaf(r, S0[p * LDN + n], gs);
          rn[i][j] = dec * r;
        }
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        const float e = expf(cs[s]);
        float yv[CPT], cv[NPT];
#pragma unroll
        for (int i = 0; i < CPT; ++i) yv[i] = e * Ys[s * LDP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NPT; ++j)
          cv[j] = tx + 16 * j < N ? Cs[s * LDN + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < CPT; ++i)
#pragma unroll
          for (int j = 0; j < NPT; ++j) rn[i][j] = fmaf(yv[i], cv[j], rn[i][j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        gs += __shfl_xor_sync(FULL, gs, off);
      if (lane == 0) red[warp] = gs;
    }
    __syncthreads();  // every read of R is done; rv, xo, co, red are written
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = tx + 16 * j;
        if (n < N) Rs[(ty + 16 * i) * LDN + n] = rn[i][j];
      }

    // da = the reverse cumsum of dcs over the tile: warp 0, rows 2 lane and
    // 2 lane + 1
    if (warp == 0) {
      float rs0 = 0.f;
#pragma unroll
      for (int k = 0; k < NT / 32; ++k) rs0 += red[k];   // <R, S0>
      const int r = 2 * lane;
      const float d0 = co[r] + rv[r] - xo[r];
      float d1 = co[r + 1] + rv[r + 1] - xo[r + 1];
      float xs = xo[r] + xo[r + 1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) xs += __shfl_xor_sync(FULL, xs, off);
      if (lane == 31) d1 += fmaf(expf(last), rs0, xs);   // <R, S_end>
      // suffix sums over the lanes: s = sum of d0 + d1 over lanes >= lane
      float sfx = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_down_sync(FULL, sfx, off);
        if (lane + off < 32) sfx += u;
      }
      float nxt = __shfl_down_sync(FULL, sfx, 1);
      if (lane == 31) nxt = 0.f;
      const float da1 = d1 + nxt, da0 = d0 + da1;
      float* dab = da + (long long)bh * L + t0;
      if (t0 + r < L) dab[r] = da0;
      if (t0 + r + 1 < L) dab[r + 1] = da1;
    }
  }
}

// dB, dC [B, G, L, N] in the inputs' dtype: the per-head f32 partials
// [B, H, L, N] summed over each group's H/G heads in head order (grid y: 0
// for dB, 1 for dC).
template <typename TOut>
__global__ void __launch_bounds__(256)
    group_sum(const float* __restrict__ dBh, const float* __restrict__ dCh,
              TOut* __restrict__ dB, TOut* __restrict__ dC, int H, int G,
              long long per, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const float* src = blockIdx.y ? dCh : dBh;
  TOut* dst = blockIdx.y ? dC : dB;
  const long long bg = i / per, e = i - bg * per;
  const long long b = bg / G, g = bg - b * G;
  const int rep = H / G;
  const float* s = src + (b * H + g * rep) * per + e;
  float acc = 0.f;
  for (int r = 0; r < rep; ++r) acc += s[r * per];
  store(dst + i, acc);
}

template <typename TIn, int P, int N>
cudaError_t launch(const void* xdt, const float* a, const void* Bm,
                   const void* Cm, const void* dy, const float* dstate,
                   void* dx, float* da, void* dB, void* dC, float* states,
                   float* dBh, float* dCh, int B, int H, int G, int L,
                   cudaStream_t stream) {
  constexpr int LDP = P + 4, LDN = N + 4;
  const int smem = (2 * T * LDP + 2 * T * LDN + 2 * T * LDG + 2 * P * LDN +
                    4 * T + 16 * T + NT / 32) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bwd<TIn, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_scan_bwd<TIn, P, N><<<B * H, NT, smem, stream>>>(
      static_cast<const TIn*>(xdt), a, static_cast<const TIn*>(Bm),
      static_cast<const TIn*>(Cm), static_cast<const TIn*>(dy), dstate,
      static_cast<TIn*>(dx), da, dBh, dCh, states, H, G, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per = (long long)L * N, total = (long long)B * G * per;
  group_sum<TIn><<<dim3((unsigned)((total + 255) / 256), 2), 256, 0,
                   stream>>>(dBh, dCh, static_cast<TIn*>(dB),
                             static_cast<TIn*>(dC), H, G, per, total);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t by_dtype(int dtype, const void* xdt, const float* a,
                     const void* Bm, const void* Cm, const void* dy,
                     const float* dstate, void* dx, float* da, void* dB,
                     void* dC, float* states, float* dBh, float* dCh, int B,
                     int H, int G, int L, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, P, N>(xdt, a, Bm, Cm, dy, dstate, dx, da, dB, dC,
                               states, dBh, dCh, B, H, G, L, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, P, N>(xdt, a, Bm, Cm, dy, dstate, dx, da,
                                       dB, dC, states, dBh, dCh, B, H, G, L,
                                       stream);
  return cudaErrorInvalidValue;
}

}  // namespace bwd

template <int P, int N>
cudaError_t launch(const void* xdt, const float* a, const void* Bm,
                   const void* Cm, void* y, float* state, int B, int H,
                   int G, int L, cudaStream_t stream) {
  constexpr int LDP = P + 4, LDN = N + 4;
  const int smem =
      (T * LDP + 2 * T * LDN + T * LDG + P * LDN + T) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan<P, N><<<B * H, NT, smem, stream>>>(
      static_cast<const float*>(xdt), a, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y), state, H, G,
      L);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch_mma(const void* xdt, const float* a, const void* Bm,
                       const void* Cm, void* y, float* state, int B, int H,
                       int G, int L, cudaStream_t stream) {
  using C = tc::Cfg<P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      tc::ssd_scan_mma<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (err != cudaSuccess) return err;
  tc::ssd_scan_mma<P, N><<<B * H, tc::NTC, C::SMEM,
                           stream>>>(
      static_cast<const tc::bf16*>(xdt), a,
      static_cast<const tc::bf16*>(Bm), static_cast<const tc::bf16*>(Cm),
      static_cast<tc::bf16*>(y), state, H, G, L);
  return cudaGetLastError();
}

// f32 to ssd_scan, bf16 to ssd_scan_mma
template <int P, int N>
cudaError_t by_dtype(int dtype, const void* xdt, const float* a,
                     const void* Bm, const void* Cm, void* y, float* state,
                     int B, int H, int G, int L, cudaStream_t stream) {
  if (dtype == 0)
    return launch<P, N>(xdt, a, Bm, Cm, y, state, B, H, G, L, stream);
  if (dtype == 1)
    return launch_mma<P, N>(xdt, a, Bm, Cm, y, state, B, H, G, L, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry, bound with ctypes.  Pointers are device pointers of contiguous
// tensors (bf16 ones on a 16-byte boundary): xdt [B,H,L,P], a [B,H,L],
// Bm, Cm [B,G,L,N] with H % G == 0, y [B,H,L,P], state [B,H,P,N].  dtype 0
// is float32, 1 is bfloat16 (xdt, Bm, Cm and y; a and the state are
// float32).  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int mamba2_chunk_scan_fwd(const void* xdt, const void* a,
                                     const void* Bm, const void* Cm, void* y,
                                     void* state, int B, int H, int G, int L,
                                     int P, int N, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  float* sf = static_cast<float*>(state);
  if (P == 64 && N == 64)
    return (int)by_dtype<64, 64>(dtype, xdt, af, Bm, Cm, y, sf, B, H, G, L,
                                 st);
  if (P == 32 && N == 16)
    return (int)by_dtype<32, 16>(dtype, xdt, af, Bm, Cm, y, sf, B, H, G, L,
                                 st);
  if (P == 16 && N == 8)
    return (int)by_dtype<16, 8>(dtype, xdt, af, Bm, Cm, y, sf, B, H, G, L,
                                st);
  return (int)cudaErrorInvalidValue;
}

// The backward.  dy [B,H,L,P] in xdt's dtype and dstate [B,H,P,N] f32 (null:
// the final state has no gradient) -> dx [B,H,L,P] in xdt's dtype, da
// [B,H,L] f32, dB, dC [B,G,L,N] in Bm's dtype.  Scratch, f32: states
// [B, H, ceil(L/64), P, N], dBh and dCh [B, H, L, N].  Two launches
// (ssd_scan_bwd, group_sum) on `stream`; returns cudaGetLastError() after
// them.
extern "C" int mamba2_chunk_scan_bwd(const void* xdt, const void* a,
                                     const void* Bm, const void* Cm,
                                     const void* dy, const void* dstate,
                                     void* dx, void* da, void* dB, void* dC,
                                     void* states, void* dBh, void* dCh,
                                     int B, int H, int G, int L, int P, int N,
                                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* dsf = static_cast<const float*>(dstate);
  float* daf = static_cast<float*>(da);
  float* sf = static_cast<float*>(states);
  float* bh = static_cast<float*>(dBh);
  float* ch = static_cast<float*>(dCh);
  if (P == 64 && N == 64)
    return (int)bwd::by_dtype<64, 64>(dtype, xdt, af, Bm, Cm, dy, dsf, dx,
                                      daf, dB, dC, sf, bh, ch, B, H, G, L, st);
  if (P == 32 && N == 16)
    return (int)bwd::by_dtype<32, 16>(dtype, xdt, af, Bm, Cm, dy, dsf, dx,
                                      daf, dB, dC, sf, bh, ch, B, H, G, L, st);
  if (P == 16 && N == 8)
    return (int)bwd::by_dtype<16, 8>(dtype, xdt, af, Bm, Cm, dy, dsf, dx,
                                     daf, dB, dC, sf, bh, ch, B, H, G, L, st);
  return (int)cudaErrorInvalidValue;
}
