// Backward of scaled dot-product attention, softmax(q k^T * scale) v, head
// dim 64 or 32: dq, dk and dv from q, k, v, the output's cotangent dO and the
// forward's per-row logsumexp (sdpa.cu writes it when a gradient is wanted).
//
// Replaces the backward of the TPU kernel
// spann3r_tpu/ops/pallas_attention.py:_sdpa_pallas (fused_sdpa's _bwd,
// which re-derives the gradients through the jnp VJP of _sdpa_jnp). The
// numerics are that VJP's: with P = exp(s - lse) the fp32 softmax of the
// scaled logits s and dP = dO v^T,
//     dv = round(P)^T dO          (P rounded to v's dtype, as the forward
//                                  multiplies it with v)
//     D  = sum_j P_ij dP_ij       (the softmax VJP's row term; not dO . O,
//                                  which differs once O is rounded to bf16)
//     dS = P (dP - D) * scale
//     dq = round(dS) k,   dk = round(dS)^T q
// with fp32 sums, each result rounded once to q's dtype. dS is rounded to
// the input dtype as the A operand of the dq and dk products (a no-op in
// fp32): the tensor cores take bf16 operands, as FlashAttention's backward
// and an fp32 product at the TPU's default precision do
// (attention.sdpa_backward_plain rounds at the same places).
//
// What bounds it on the card. The function does five N x M x 64 products
// per head (10 N M 64 flops) against ~7 N x 64 elements moved. At the
// 512x384 encoder (N = M = 768, 256 heads) that is operation-bound
// (~0.1 ms at the bf16 peak); at the training shapes (N = M = 196, 24-160
// heads) the bound is bytes, a few microseconds, and what the kernel takes
// is latency: each block's serial chain of 4 tiles of 64 (196 = 3 * 64 + 4)
// and the launches.
//
// Two paths, one per dtype:
//   - bf16 (training): Hopper's warpgroup tensor-core products (wgmma,
//     sm_90a), every product m64n64k16 with fp32 accumulators in
//     registers, one warpgroup per block of 64 rows. Two launches:
//       1. the row term: one block per (batch*head, 64 query rows) sweeps
//          the key tiles with S = q k^T and dP = dO v^T (wgmma, both
//          operands in shared memory), P = exp2 of the logits in log2
//          units minus lse * log2(e) (as the forward forms p), and D_i =
//          sum_j P dP in registers, written to the drow scratch (B, H, N).
//       2. dq and dk/dv side by side in one grid: blocks [0, N/64) own 64
//          query rows and sweep the key tiles (S, dP; dS rounded to bf16
//          and repacked from the accumulator into the A fragment of
//          dq += dS k, k read from shared memory as an MN-major operand);
//          blocks [N/64, N/64 + M/64) own 64 key rows and sweep the query
//          tiles (S^T = k q^T, dP^T = v dO^T; dv += round(P^T) dO and dk
//          += round(dS^T) q from registers), with the tiles' lse and D
//          staged beside them. The key-owned sweep overlaps the math: P^T
//          is formed while dP^T is still on the tensor cores, and dS^T
//          while dv's product runs.
//     Nine products per (query tile, key tile) against the function's
//     five: S and dP are formed three times (row term, dq, dk/dv), the
//     price of giving every output one owner without atomics. The
//     streamed tiles run through a three-stage ring of 16-byte cp.async
//     copies into 128-byte-swizzled tiles (as the forward's: strided
//     views, no tensor map), so the copies of the next two tiles overlap
//     the math on this one, and three blocks share an SM. At 196 tokens
//     the second launch has twice the blocks of each pass of a two-pass
//     design (192 at the decoder's 24 heads, on 132 SMs: one wave), each a
//     chain of 4 tiles; measured there (PERF.md), a block's fixed cost
//     (its own tiles in, its outputs out) is ~4.5 us and each tile ~2 us,
//     so the chain, not the card, sets the time. At 768 tokens the 6144
//     blocks of 12 tiles keep the card full and the products bound it, at
//     ~245 TFLOP/s on the nine (a quarter of the peak). Interleaving the
//     k steps of the two independent products of a stage, and overlapping
//     one tile's dv/dk products with the next tile's S/dP, were both
//     slower; staging the outputs for 16-byte stores gained ~2% (PERF.md).
//   - fp32: the CUDA cores (the tensor cores would round fp32 inputs to
//     tf32); it serves only the parity runs. Two passes of the fp32
//     forward's shape (256 threads as a 16 x 16 grid, tiles through padded
//     shared memory): pass 1, one block per (batch*head, 64 query rows),
//     sweeps the key tiles (32 keys) once for D and again for dq; pass 2,
//     one block per (batch*head, 64 key rows), sweeps the query tiles for
//     dv and dk.
// Head dim 32 (the CroCo decoder's) takes the same kernels at DH = 32, as
// the forward does (sdpa.cu): the fp32 path's rows are DH + 1 floats and a
// thread owns DH / 16 output columns; the bf16 path keeps the 64-wide
// swizzled tiles with columns DH..63 loaded as zeros (the loads masked by
// column), runs S = q k^T and dP = dO v^T over the DH / 16 k-steps that
// hold data, and stores only the accumulator columns below DH of dq, dk
// and dv, whose products (64 wide) do twice the work they need.
// No atomics: every output element has one owner, so two launches give
// the same bits. Any N, M >= 1 (ragged tiles are masked); q, k, v, dO and
// the three outputs are read and written through their batch, head and
// row strides with unit stride in Dh.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace spann3r {
namespace {

constexpr int NT = 256;       // threads per block
constexpr int TR = 64;        // rows a block owns (queries, then keys)
constexpr int TC = 32;        // rows a sweep streams per tile
constexpr int CP = TC + 1;    // padded row of a P / dS tile

struct Strides {
  long long b, h, n;
};

// --- fp32 path: CUDA cores -------------------------------------------------
using T = float;

template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long sn, int row0, int rows,
                                          int limit) {
  constexpr int RP = DH + 1;   // padded row of a q/k/v/dO tile
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    const int gr = row0 + r;
    dst[r * RP + d] = gr < limit ? to_f(src[gr * sn + d]) : 0.f;
  }
}

// out[a][c] = a_rows[ty + 16a] . b_rows[tx + 16c] over Dh
template <int DH>
__device__ __forceinline__ void dots(const float* a_rows, const float* b_rows,
                                     int ty, int tx, float out[4][2]) {
  constexpr int RP = DH + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a) out[a][0] = out[a][1] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[2];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = a_rows[(ty + 16 * a) * RP + d];
#pragma unroll
    for (int c = 0; c < 2; ++c) bv[c] = b_rows[(tx + 16 * c) * RP + d];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      out[a][0] = fmaf(av[a], bv[0], out[a][0]);
      out[a][1] = fmaf(av[a], bv[1], out[a][1]);
    }
  }
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int DH>
constexpr size_t kDqSmem =
    sizeof(float) * (2 * TR * (DH + 1) + 2 * TC * (DH + 1) + TR * CP);
template <int DH>
constexpr size_t kDkvSmem = sizeof(float) * (2 * TR * (DH + 1) +
                                             2 * TC * (DH + 1) + 2 * TR * CP +
                                             2 * TC);

// pass 1: D and dq for 64 query rows of one (batch, head)
template <int DH>
__global__ void __launch_bounds__(NT)
sdpa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ drow,
                   T* __restrict__ dq, int H, int N, int M, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   float scale) {
  constexpr int RP = DH + 1;
  constexpr int DC = DH / 16;    // output columns a thread owns
  extern __shared__ float smem[];
  float* qs = smem;              // TR x RP
  float* dos = qs + TR * RP;     // TR x RP
  float* ks = dos + TR * RP;     // TC x RP
  float* vs = ks + TC * RP;      // TC x RP
  float* dss = vs + TC * RP;     // TR x CP

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TR;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  T* dqb = dq + b * sdq.b + h * sdq.h;

  load_rows<DH>(qs, qb, sq.n, q0, TR, N);
  load_rows<DH>(dos, dob, sdo.n, q0, TR, N);
  float l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    l[a] = r < N ? lse[(long long)bh * N + r] : 0.f;
  }
  const int ntiles = (M + TC - 1) / TC;

  // sweep 1: D_i = sum_j P_ij dP_ij
  float dsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TC;
    __syncthreads();
    load_rows<DH>(ks, kb, sk.n, k0, TC, M);
    load_rows<DH>(vs, vb, sv.n, k0, TC, M);
    __syncthreads();
    float s[4][2], dp[4][2];
    dots<DH>(qs, ks, ty, tx, s);
    dots<DH>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = k0 + tx + 16 * c < M;
        const float p = valid ? expf(s[a][c] * scale - l[a]) : 0.f;
        dsum[a] = fmaf(p, dp[a][c], dsum[a]);
      }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) dsum[a] = row_sum16(dsum[a]);

  // sweep 2: dS = P (dP - D) * scale, dq += dS k
  float acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TC;
    __syncthreads();
    load_rows<DH>(ks, kb, sk.n, k0, TC, M);
    load_rows<DH>(vs, vb, sv.n, k0, TC, M);
    __syncthreads();
    float s[4][2], dp[4][2];
    dots<DH>(qs, ks, ty, tx, s);
    dots<DH>(dos, vs, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool valid = k0 + tx + 16 * c < M;
        const float p = valid ? expf(s[a][c] * scale - l[a]) : 0.f;
        dss[(ty + 16 * a) * CP + tx + 16 * c] = p * (dp[a][c] - dsum[a]) * scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TC; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = ks[j * RP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dss[(ty + 16 * a) * CP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(ds, kv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= N) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[r * sdq.n + tx + 16 * c] = from_f<T>(acc[a][c]);
    if (tx == 0) drow[(long long)bh * N + r] = dsum[a];
  }
}

// pass 2: dk and dv for 64 key rows of one (batch, head)
template <int DH>
__global__ void __launch_bounds__(NT)
sdpa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ drow, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int N, int M, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdk,
                    Strides sdv, float scale) {
  constexpr int RP = DH + 1;
  constexpr int DC = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;              // TR x RP: the block's keys
  float* vs = ks + TR * RP;      // TR x RP
  float* qs = vs + TR * RP;      // TC x RP: a query tile
  float* dos = qs + TC * RP;     // TC x RP
  float* ps = dos + TC * RP;     // TR x CP: P^T rounded to v's dtype
  float* dss = ps + TR * CP;     // TR x CP: dS^T
  float* ls = dss + TR * CP;     // TC: the tile's lse
  float* drs = ls + TC;          // TC: the tile's D

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TR;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;

  load_rows<DH>(ks, kb, sk.n, k0, TR, M);
  load_rows<DH>(vs, vb, sv.n, k0, TR, M);
  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[a][c] = adv[a][c] = 0.f;

  const int ntiles = (N + TC - 1) / TC;
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * TC;
    __syncthreads();
    load_rows<DH>(qs, qb, sq.n, n0, TC, N);
    load_rows<DH>(dos, dob, sdo.n, n0, TC, N);
    if (tid < TC) {
      const int r = n0 + tid;
      ls[tid] = r < N ? lse[(long long)bh * N + r] : 0.f;
      drs[tid] = r < N ? drow[(long long)bh * N + r] : 0.f;
    }
    __syncthreads();
    float s[4][2], dp[4][2];
    dots<DH>(ks, qs, ty, tx, s);   // s[a][c]: key ty + 16a, query tx + 16c
    dots<DH>(vs, dos, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tx + 16 * c;
        const bool valid = n0 + col < N;
        const float p = valid ? expf(s[a][c] * scale - ls[col]) : 0.f;
        ps[(ty + 16 * a) * CP + col] = to_f(from_f<T>(p));
        dss[(ty + 16 * a) * CP + col] = p * (dp[a][c] - drs[col]) * scale;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TC; ++j) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = dos[j * RP + tx + 16 * c];
        qv[c] = qs[j * RP + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = ps[(ty + 16 * a) * CP + j];
        const float ds = dss[(ty + 16 * a) * CP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          adv[a][c] = fmaf(p, dov[c], adv[a][c]);
          adk[a][c] = fmaf(ds, qv[c], adk[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = k0 + ty + 16 * a;
    if (r >= M) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[r * sdk.n + tx + 16 * c] = from_f<T>(adk[a][c]);
      dvb[r * sdv.n + tx + 16 * c] = from_f<T>(adv[a][c]);
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, float* drow,
                       void* dq, void* dk, void* dv, int B, int H, int N,
                       int M, Strides sq, Strides sk, Strides sv, Strides sdo,
                       Strides sdq, Strides sdk, Strides sdv, float scale,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_bwd_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmem<DH>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sdpa_bwd_dkv_kernel<DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kDkvSmem<DH>);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  sdpa_bwd_dq_kernel<DH><<<dim3((N + TR - 1) / TR, B * H), NT, kDqSmem<DH>,
                           stream>>>(
      qt, kt, vt, dot, lse, drow, static_cast<T*>(dq), H, N, M, sq, sk, sv,
      sdo, sdq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sdpa_bwd_dkv_kernel<DH><<<dim3((M + TR - 1) / TR, B * H), NT, kDkvSmem<DH>,
                            stream>>>(qt, kt, vt, dot, lse, drow,
                                  static_cast<T*>(dk), static_cast<T*>(dv), H,
                                  N, M, sq, sk, sv, sdo, sdk, sdv, scale);
  return cudaSuccess;
}

// --- bf16 path: wgmma tensor cores ---------------------------------------
using hopper::bf16;
constexpr int STAGES = 3;       // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;
// 1024 bytes of slack to align the tiles, the block's two own tiles, a ring
// of two streamed tiles per stage, then each stage's 64 lse and 64 D values
// (the key-owned blocks' streamed query rows)
constexpr size_t kWgmmaSmem = 1024 + hopper::kTileBytes * (2 + 2 * STAGES) +
                              STAGES * 2 * 64 * sizeof(float);

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float* lse;
  float* drow;
  bf16 *dq, *dk, *dv;
  int H, N, M;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  float scale;
  bool vq, vk, vv, vdo;   // rows 16-byte aligned: cp.async
};

// the accumulator's columns below DH, rows below `limit`
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, int row0,
                                          int limit, const float (&acc)[32],
                                          int t) {
  using namespace hopper;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 4)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + acc_row(t, 0) + 8 * hr;
      if (row < limit)
        *reinterpret_cast<uint32_t*>(dst + row * ld + acc_col(t, i)) =
            pack_bf16(acc[i + 2 * hr], acc[i + 2 * hr + 1]);
    }
}

// d = a b^T over the first DH columns of two K-major tiles (wgmma, both
// operands in shared memory), committed as one group
template <int DH>
__device__ __forceinline__ void product_nt(float (&d)[32],
                                           const unsigned char* a,
                                           const unsigned char* b) {
  using namespace hopper;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss<0>(d, desc(a, kk * 32), desc(b, kk * 32), kk);
  wgmma_commit();
}

// d += a b with a (64 x 64 bf16) from registers and b a tile whose rows are
// the contraction (MN-major), committed as one group
__device__ __forceinline__ void product_rn(float (&d)[32],
                                           const uint32_t (&a)[4][4],
                                           const unsigned char* b) {
  using namespace hopper;
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(d, a[kk], desc(b, kk * 2048), 1);
  wgmma_commit();
}

// the accumulator's columns 16 kk .. 16 kk + 15, rounded to bf16, as the A
// fragment kk of a product (the layout the forward's PV takes)
__device__ __forceinline__ void to_frag(uint32_t (&a)[4][4],
                                        const float (&x)[32]) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// ROW_TERM: grid (N/64, B*H), D for 64 query rows into drow. Otherwise
// grid (N/64 + M/64, B*H): dq for 64 query rows (x < N/64) or dk and dv
// for 64 key rows. A block keeps its own two tiles ((q, dO) or (k, v)) and
// streams the other side's two ((k, v) or (q, dO)) through the ring. Three
// blocks share an SM (at most 168 registers a thread; 68 KB of shared
// memory each).
template <bool ROW_TERM, int DH>
__global__ void __launch_bounds__(128, 3)
    sdpa_bwd_wgmma_kernel(const Args a) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* own = align1024(smem_raw);
  unsigned char* ring = own + 2 * kTileBytes;
  float* stats = reinterpret_cast<float*>(ring + STAGES * 2 * kTileBytes);

  const int t = threadIdx.x & 127;   // < 128: the tile loops unroll fully
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int nqt = (a.N + 63) / 64;
  const bool key_owned = !ROW_TERM && (int)blockIdx.x >= nqt;
  const int row0 = (key_owned ? blockIdx.x - nqt : blockIdx.x) * 64;
  const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* dob = a.dout + b * a.sdo.b + h * a.sdo.h;
  const float* lseb = a.lse + (long long)bh * a.N;
  float* drb = a.drow + (long long)bh * a.N;
  const float sl2 = a.scale * kLog2e;   // logits in log2 units

  // own tiles (x, y) and the streamed pair (u, w): S = x u^T, dP = y w^T
  const bf16 *ox = qb, *oy = dob, *su = kb, *sw = vb;
  long long lox = a.sq.n, loy = a.sdo.n, lsu = a.sk.n, lsw = a.sv.n;
  bool vox = a.vq, voy = a.vdo, vsu = a.vk, vsw = a.vv;
  int own_rows = a.N, streamed_rows = a.M;
  if (key_owned) {
    ox = kb, oy = vb, su = qb, sw = dob;
    lox = a.sk.n, loy = a.sv.n, lsu = a.sq.n, lsw = a.sdo.n;
    vox = a.vk, voy = a.vv, vsu = a.vq, vsw = a.vdo;
    own_rows = a.M, streamed_rows = a.N;
  }
  const int steps = (streamed_rows + 63) / 64;
  auto prefetch = [&](int j) {
    if (j < steps) {
      unsigned char* st = ring + (j % STAGES) * 2 * kTileBytes;
      load_tile(st, su, lsu, j * 64, streamed_rows, vsu, t, 128, 0, DH);
      load_tile(st + kTileBytes, sw, lsw, j * 64, streamed_rows, vsw, t, 128,
                0, DH);
      if (key_owned) {   // the streamed query rows' lse (t < 64) and D
        const int row = j * 64 + (t & 63);
        const bool ok = row < a.N;
        const float* src = t < 64 ? lseb : drb;
        cp_async4(stats + (j % STAGES) * 128 + t, ok ? src + row : src, ok);
      }
    }
    cp_async_commit();
  };

  load_tile(own, ox, lox, row0, own_rows, vox, t, 128, 0, DH);
  load_tile(own + kTileBytes, oy, loy, row0, own_rows, voy, t, 128, 0, DH);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);

  // a query-owned block's rows r0 (accumulator elements with (i / 2) % 2
  // == 0) and r0 + 8: their lse in log2 units and (dq blocks) D
  const int r0 = acc_row(t, 0);
  float l2[2] = {0.f, 0.f}, drw[2] = {0.f, 0.f};
  if (!key_owned) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + r0 + 8 * hr;
      if (row < a.N) {
        l2[hr] = lseb[row] * kLog2e;
        if (!ROW_TERM) drw[hr] = drb[row];
      }
    }
  }

  float s[32], dp[32], acc[32], acc_v[32];   // acc: D, dq or dk; acc_v: dv
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = acc_v[i] = 0.f;
  uint32_t pf[4][4], sf[4][4];   // round(P^T), round(dS) fragments

  for (int j = 0; j < steps; ++j) {
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    prefetch(j + STAGES - 1);
    const unsigned char* u = ring + (j % STAGES) * 2 * kTileBytes;
    const unsigned char* w = u + kTileBytes;
    const float* st = stats + (j % STAGES) * 128;
    const int c0 = j * 64;
    const bool ragged = c0 + 64 > streamed_rows;

    product_nt<DH>(s, own, u);
    product_nt<DH>(dp, own + kTileBytes, w);
    wgmma_wait<1>();
    fence_regs(s);
    // P, 0 past the streamed side's last row
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = acc_col(t, i);
      const float lse2 = key_owned ? st[col] * kLog2e : l2[(i >> 1) & 1];
      s[i] = ragged && c0 + col >= streamed_rows
                 ? 0.f
                 : exp2f(fmaf(s[i], sl2, -lse2));
    }
    if (key_owned) {   // dv += round(P^T) dO while dP^T finishes
      to_frag(pf, s);
      product_rn(acc_v, pf, w);
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(dp);
    if constexpr (ROW_TERM) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(s[i], dp[i], acc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float d = key_owned ? st[64 + acc_col(t, i)] : drw[(i >> 1) & 1];
        dp[i] = s[i] * (dp[i] - d) * a.scale;
      }
      to_frag(sf, dp);
      product_rn(acc, sf, u);   // dq += dS k, or dk += dS^T q
      wgmma_wait<0>();
      if (key_owned) fence_frag(pf);
      fence_frag(sf);
      fence_regs(acc);
      fence_regs(acc_v);
    }
  }
  cp_async_wait<0>();

  if constexpr (ROW_TERM) {   // D: the row's 16 columns, then its 4 lanes
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hr) sum += acc[i];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = row0 + r0 + 8 * hr;
      if ((t & 3) == 0 && row < a.N) drb[row] = sum;
    }
  } else if (key_owned) {
    store_rows<DH>(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.n, row0, a.M, acc,
                   t);
    store_rows<DH>(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.n, row0, a.M,
                   acc_v, t);
  } else {
    store_rows<DH>(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.n, row0, a.N, acc, t);
  }
}

__host__ __device__ inline bool rows_aligned16(const void* p, Strides st) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.n % 8 == 0;
}

template <int DH>
cudaError_t launch_bf16(const Args& a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_bwd_wgmma_kernel<true, DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWgmmaSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sdpa_bwd_wgmma_kernel<false, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kWgmmaSmem);
  if (err != cudaSuccess) return err;
  const int nqt = (a.N + 63) / 64, nkt = (a.M + 63) / 64;
  sdpa_bwd_wgmma_kernel<true, DH><<<dim3(nqt, B * a.H), 128, kWgmmaSmem,
                                    stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sdpa_bwd_wgmma_kernel<false, DH><<<dim3(nqt + nkt, B * a.H), 128,
                                     kWgmmaSmem, stream>>>(a);
  return cudaSuccess;
}

}  // namespace
}  // namespace spann3r

// q, dO, dq: (B, H, N, D); k, v, dk, dv: (B, H, M, D); each with element
// strides (batch, head, row) and unit stride in D. D must be 64 or 32. lse: the
// forward's fp32 (B, H, N) contiguous logsumexp; drow: fp32 (B, H, N)
// contiguous scratch that receives the row term D.
extern "C" int spann3r_sdpa_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* drow, void* dq, void* dk, void* dv, int dtype,
    int B, int H, int N, int M, int D, long long qsb, long long qsh,
    long long qsn, long long ksb, long long ksh, long long ksn, long long vsb,
    long long vsh, long long vsn, long long dosb, long long dosh,
    long long dosn, long long dqsb, long long dqsh, long long dqsn,
    long long dksb, long long dksh, long long dksn, long long dvsb,
    long long dvsh, long long dvsn, float scale, void* stream) {
  using namespace spann3r;
  if ((D != 64 && D != 32) || N < 1 || M < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsh, qsn}, sk{ksb, ksh, ksn}, sv{vsb, vsh, vsn},
      sdo{dosb, dosh, dosn}, sdq{dqsb, dqsh, dqsn}, sdk{dksb, dksh, dksn},
      sdv{dvsb, dvsh, dvsn};
  const float* l = static_cast<const float*>(lse);
  float* dr = static_cast<float*>(drow);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = D == 64 ? launch_f32<64>(q, k, v, dout, l, dr, dq, dk, dv, B, H, N,
                                   M, sq, sk, sv, sdo, sdq, sdk, sdv, scale, s)
                  : launch_f32<32>(q, k, v, dout, l, dr, dq, dk, dv, B, H, N,
                                   M, sq, sk, sv, sdo, sdq, sdk, sdv, scale, s);
  } else if (dtype == kBFloat16) {
    const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                 l, dr, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                 static_cast<bf16*>(dv), H, N, M, sq, sk, sv, sdo, sdq, sdk,
                 sdv, scale, rows_aligned16(q, sq), rows_aligned16(k, sk),
                 rows_aligned16(v, sv), rows_aligned16(dout, sdo)};
    err = D == 64 ? launch_bf16<64>(a, B, s) : launch_bf16<32>(a, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
