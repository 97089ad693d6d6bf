// Spatial-memory readout: thresholded, renormalised single-head attention
// of P queries over a C-slot token bank, plus per-slot column sums.
//
// Replaces the TPU kernels spann3r_tpu/ops/pallas_memory.py:_pass1_kernel,
// _pass2_kernel and _pass3_kernel (launched by memory_read_attention).
// For query p and slot c < size:
//     s[p, c] = q[p] . k[c] / sqrt(D)          (-1e30 for c >= size)
//     a[p, c] = exp(s - max_c s) / sum_c exp(s - max_c s)
// with attn_thresh > 0:
//     a = (a < attn_thresh ? 0 : a) / (sum_c of that + 1e-12)
// out[p] = sum_c a[p, c] v[c] (written in q's dtype) and
// asum[c] = sum_p a[p, c] (fp32), the statistic the prune ranks slots by.
//
// What bounds it on the card: at 512x384 (P = 768, C = 8704, D = 1024) the
// two products q k^T and a v are 13.7 GFLOP each against ~36 MB of bank,
// so the products should run on the tensor cores. The threshold needs
// each row's final max and sum before any weight can be kept or dropped,
// so the TPU kernel swept the bank three times; here the scores are
// computed once into a P x C fp32 scratch (27 MB, which stays in the 50 MB
// L2) and the other kernels read it:
//   1. scores  - tiled q k^T, masked at size (tiles past size only write
//                the mask value);
//   2. weights - one block per query row: max, sum-exp and kept mass, then
//                the final weights a written over the row's scores;
//   3. readout - tiled a v (tiles past size are skipped: their a is
//                exactly 0);
//   4. colsum  - one block per 32 slots, summing a over all P queries in a
//                fixed order.
// bf16 banks (the serving path) run 1 and 3 on the tensor cores through
// the warp-level WMMA API with fp32 accumulators. The weights a stay fp32
// as in the TPU kernel: for the tensor cores each a is split into a bf16
// high part and a bf16 remainder (a = hi + lo to ~2^-16 relative), and
// both are multiplied by v. fp32 banks run on the CUDA cores (WMMA would
// round fp32 inputs to tf32).
// No float atomics anywhere: the column sums feed the prune's top-k, and a
// run-to-run change in their last bits could flip a prune decision.
// `size` is read from device memory, so the caller never waits on the
// device to learn it.

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace spann3r {
namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int NT = 256;
constexpr float kMask = -1e30f;
constexpr float kRenormEps = 1e-12f;

// tensor-core tiles: 4 warps, 64 x 64 outputs per block, 16 rows per warp
constexpr int WT = 128;
constexpr int WTILE = 64;
constexpr int BLD = WTILE + 8;   // bf16 row stride in shared memory
constexpr int FLD = WTILE + 4;   // fp32 staging row stride

// rows [row0, row0 + 64) x cols [col0, col0 + 64) of a row-major (rows x
// cols) bf16 matrix into shared memory, zero outside; 16-byte loads when
// the rows are 16-byte aligned (`vec`)
__device__ __forceinline__ void load_bf16_tile(bf16* dst, const bf16* src,
                                               int rows, int cols, int row0,
                                               int col0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < WTILE * (WTILE / 8); e += WT) {
      const int r = e / (WTILE / 8), c = (e % (WTILE / 8)) * 8;
      const int gr = row0 + r, gc = col0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && gc < cols)
        val = *reinterpret_cast<const uint4*>(src + (long long)gr * cols + gc);
      *reinterpret_cast<uint4*>(dst + r * BLD + c) = val;
    }
    return;
  }
  for (int e = threadIdx.x; e < WTILE * WTILE; e += WT) {
    const int r = e / WTILE, c = e % WTILE;
    const int gr = row0 + r, gc = col0 + c;
    dst[r * BLD + c] = (gr < rows && gc < cols)
                           ? src[(long long)gr * cols + gc]
                           : __float2bfloat16_rn(0.f);
  }
}

// --- 1. scores: S[p, c] = scale * q[p] . k[c], masked at size -------------
constexpr int ST = 64;   // output tile (rows and columns), CUDA-core path
constexpr int SD = 32;   // depth step
constexpr int SP = SD + 1;

__device__ __forceinline__ void write_mask_tile(float* S, int P, int C,
                                                int p0, int c0, int nthreads) {
  for (int e = threadIdx.x; e < ST * ST; e += nthreads) {
    const int r = e / ST, c = e % ST;
    if (p0 + r < P && c0 + c < C) S[(long long)(p0 + r) * C + c0 + c] = kMask;
  }
}

__global__ void __launch_bounds__(NT)
scores_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const int* __restrict__ size_ptr, float* __restrict__ S,
                  int P, int C, int D, float scale) {
  __shared__ float qs[ST * SP];
  __shared__ float ks[ST * SP];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * ST, p0 = blockIdx.y * ST;
  const int size = *size_ptr;
  if (c0 >= size) {  // whole tile past the valid slots
    write_mask_tile(S, P, C, p0, c0, NT);
    return;
  }

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int d0 = 0; d0 < D; d0 += SD) {
    __syncthreads();
    for (int e = tid; e < ST * SD; e += NT) {
      const int r = e / SD, d = e % SD;
      const int gd = d0 + d;
      const int gp = p0 + r, gc = c0 + r;
      qs[r * SP + d] = (gp < P && gd < D) ? q[(long long)gp * D + gd] : 0.f;
      ks[r * SP + d] = (gc < C && gd < D) ? k[(long long)gc * D + gd] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < SD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = qs[(ty + 16 * a) * SP + d];
#pragma unroll
      for (int b = 0; b < 4; ++b) kv[b] = ks[(tx + 16 * b) * SP + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qv[a], kv[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gp = p0 + ty + 16 * a;
    if (gp >= P) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gc = c0 + tx + 16 * b;
      if (gc < C) S[(long long)gp * C + gc] = gc < size ? acc[a][b] * scale : kMask;
    }
  }
}

__global__ void __launch_bounds__(WT)
scores_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const int* __restrict__ size_ptr, float* __restrict__ S,
                   int P, int C, int D, float scale, bool vec) {
  __shared__ __align__(128) bf16 qsm[WTILE * BLD];
  __shared__ __align__(128) bf16 ksm[WTILE * BLD];
  __shared__ __align__(128) float stage[4 * 16 * FLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * WTILE, p0 = blockIdx.y * WTILE;
  const int size = *size_ptr;
  if (c0 >= size) {
    write_mask_tile(S, P, C, p0, c0, WT);
    return;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WTILE / 16];
#pragma unroll
  for (int n = 0; n < WTILE / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int d0 = 0; d0 < D; d0 += WTILE) {
    __syncthreads();
    load_bf16_tile(qsm, q, P, D, p0, d0, vec);
    load_bf16_tile(ksm, k, C, D, c0, d0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WTILE / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf;
      wmma::load_matrix_sync(qf, qsm + warp * 16 * BLD + kk * 16, BLD);
#pragma unroll
      for (int n = 0; n < WTILE / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ksm + n * 16 * BLD + kk * 16, BLD);
        wmma::mma_sync(acc[n], qf, kf, acc[n]);
      }
    }
  }

  float* sw = stage + warp * 16 * FLD;
#pragma unroll
  for (int n = 0; n < WTILE / 16; ++n)
    wmma::store_matrix_sync(sw + n * 16, acc[n], FLD, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, half = lane & 1;
  const int gp = p0 + warp * 16 + row;
  if (gp < P) {
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = 2 * c + half, gc = c0 + col;
      if (gc < C)
        S[(long long)gp * C + gc] = gc < size ? sw[row * FLD + col] * scale : kMask;
    }
  }
}

// --- 2. weights: row statistics, then a written over the scores ---------
__device__ float block_reduce(float v, bool is_max) {
  __shared__ float part[NT / 32];
  __shared__ float result;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = part[0];
    for (int w = 1; w < NT / 32; ++w) r = is_max ? fmaxf(r, part[w]) : r + part[w];
    result = r;
  }
  __syncthreads();
  const float r = result;
  __syncthreads();  // part/result may be reused by the next call
  return r;
}

__global__ void __launch_bounds__(NT)
weights_kernel(float* __restrict__ S, int C, float attn_thresh) {
  float* row = S + (long long)blockIdx.x * C;
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < C; c += NT) mx = fmaxf(mx, row[c]);
  const float m = block_reduce(mx, true);
  float sm = 0.f;
  for (int c = threadIdx.x; c < C; c += NT) sm += expf(row[c] - m);
  const float z = block_reduce(sm, false);
  if (attn_thresh > 0.f) {
    float kp = 0.f;
    for (int c = threadIdx.x; c < C; c += NT) {
      const float a = expf(row[c] - m) / z;
      kp += a < attn_thresh ? 0.f : a;
    }
    const float denom = block_reduce(kp, false) + kRenormEps;
    for (int c = threadIdx.x; c < C; c += NT) {
      const float a = expf(row[c] - m) / z;
      row[c] = (a < attn_thresh ? 0.f : a) / denom;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += NT) row[c] = expf(row[c] - m) / z;
  }
}

// --- 3. readout: out[p] = sum_c a[p, c] v[c] -------------------------------
constexpr int RT = 64;   // query rows and value columns per block
constexpr int RC = 32;   // slots per step
constexpr int RAP = RC + 1;
constexpr int RVP = RT + 1;

__device__ __forceinline__ int valid_end(const int* size_ptr, int C) {
  // slots at or past size have a == 0 exactly, unless the bank is empty
  const int size = *size_ptr;
  return size > 0 ? min(size, C) : C;
}

__global__ void __launch_bounds__(NT)
readout_f32_kernel(const float* __restrict__ A, const float* __restrict__ v,
                   const int* __restrict__ size_ptr, float* __restrict__ out,
                   int P, int C, int D) {
  __shared__ float as[RT * RAP];
  __shared__ float vs[RC * RVP];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d0 = blockIdx.x * RT, p0 = blockIdx.y * RT;
  const int cend = valid_end(size_ptr, C);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int c0 = 0; c0 < cend; c0 += RC) {
    __syncthreads();
    for (int e = tid; e < RT * RC; e += NT) {
      const int r = e / RC, c = e % RC;
      const int gp = p0 + r, gc = c0 + c;
      as[r * RAP + c] = (gp < P && gc < C) ? A[(long long)gp * C + gc] : 0.f;
    }
    for (int e = tid; e < RC * RT; e += NT) {
      const int r = e / RT, d = e % RT;
      const int gc = c0 + r, gd = d0 + d;
      vs[r * RVP + d] = (gc < C && gd < D) ? v[(long long)gc * D + gd] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < RC; ++j) {
      float vv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) vv[b] = vs[j * RVP + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float w = as[(ty + 16 * a) * RAP + j];
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(w, vv[b], acc[a][b]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gp = p0 + ty + 16 * a;
    if (gp >= P) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int gd = d0 + tx + 16 * b;
      if (gd < D) out[(long long)gp * D + gd] = acc[a][b];
    }
  }
}

__global__ void __launch_bounds__(WT)
readout_bf16_kernel(const float* __restrict__ A, const bf16* __restrict__ v,
                    const int* __restrict__ size_ptr, bf16* __restrict__ out,
                    int P, int C, int D, bool vec) {
  __shared__ __align__(128) bf16 ahi[WTILE * BLD];
  __shared__ __align__(128) bf16 alo[WTILE * BLD];
  __shared__ __align__(128) bf16 vsm[WTILE * BLD];
  __shared__ __align__(128) float stage[4 * 16 * FLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = blockIdx.x * WTILE, p0 = blockIdx.y * WTILE;
  const int cend = valid_end(size_ptr, C);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[WTILE / 16];
#pragma unroll
  for (int n = 0; n < WTILE / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int c0 = 0; c0 < cend; c0 += WTILE) {
    __syncthreads();
    for (int e = threadIdx.x; e < WTILE * WTILE; e += WT) {
      const int r = e / WTILE, c = e % WTILE;
      const int gp = p0 + r, gc = c0 + c;
      const float a = (gp < P && gc < C) ? A[(long long)gp * C + gc] : 0.f;
      const bf16 hi = __float2bfloat16_rn(a);
      ahi[r * BLD + c] = hi;
      alo[r * BLD + c] = __float2bfloat16_rn(a - __bfloat162float(hi));
    }
    load_bf16_tile(vsm, v, C, D, c0, d0, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WTILE / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fh, fl;
      wmma::load_matrix_sync(fh, ahi + warp * 16 * BLD + kk * 16, BLD);
      wmma::load_matrix_sync(fl, alo + warp * 16 * BLD + kk * 16, BLD);
#pragma unroll
      for (int n = 0; n < WTILE / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vsm + kk * 16 * BLD + n * 16, BLD);
        wmma::mma_sync(acc[n], fh, vf, acc[n]);
        wmma::mma_sync(acc[n], fl, vf, acc[n]);
      }
    }
  }

  float* sw = stage + warp * 16 * FLD;
#pragma unroll
  for (int n = 0; n < WTILE / 16; ++n)
    wmma::store_matrix_sync(sw + n * 16, acc[n], FLD, wmma::mem_row_major);
  __syncwarp();
  const int row = lane >> 1, half = lane & 1;
  const int gp = p0 + warp * 16 + row;
  if (gp < P) {
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int col = 2 * c + half, gd = d0 + col;
      if (gd < D)
        out[(long long)gp * D + gd] = __float2bfloat16_rn(sw[row * FLD + col]);
    }
  }
}

// --- 4. colsum: asum[c] = sum_p a[p, c], fixed summation order -------------
constexpr int CC = 32;          // slots per block
constexpr int CR = NT / CC;     // row groups per block

__global__ void __launch_bounds__(NT)
colsum_kernel(const float* __restrict__ A, float* __restrict__ asum, int P,
              int C) {
  __shared__ float part[CR][CC];
  const int cx = threadIdx.x % CC, ry = threadIdx.x / CC;
  const int gc = blockIdx.x * CC + cx;
  float acc = 0.f;
  if (gc < C) {
    for (int p = ry; p < P; p += CR) acc += A[(long long)p * C + gc];
  }
  part[ry][cx] = acc;
  __syncthreads();
  if (ry == 0 && gc < C) {
    float total = 0.f;
    for (int r = 0; r < CR; ++r) total += part[r][cx];
    asum[gc] = total;
  }
}

bool rows_aligned16(const void* p, int cols) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && cols % 8 == 0;
}

}  // namespace
}  // namespace spann3r

// q: contiguous (P, D); k, v: contiguous (C, D), all of one dtype;
// size: one int32 in device memory; out: contiguous (P, D) in q's dtype;
// asum: (C,) fp32; scores: (P, C) fp32 scratch.
extern "C" int spann3r_memory_read(const void* q, const void* k,
                                   const void* v, const void* size, void* out,
                                   void* asum, void* scores, int dtype, int P,
                                   int C, int D, float scale,
                                   float attn_thresh, void* stream) {
  using namespace spann3r;
  if (P < 1 || C < 1 || D < 1 || P > 65535 * ST || D > 65535 * RT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(size);
  float* S = static_cast<float*>(scores);
  const dim3 tiles_pc((C + ST - 1) / ST, (P + ST - 1) / ST);
  const dim3 tiles_pd((D + RT - 1) / RT, (P + RT - 1) / RT);
  if (dtype == kFloat32) {
    scores_f32_kernel<<<tiles_pc, NT, 0, s>>>(static_cast<const float*>(q),
                                             static_cast<const float*>(k), sz,
                                             S, P, C, D, scale);
  } else if (dtype == kBFloat16) {
    scores_bf16_kernel<<<tiles_pc, WT, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), sz, S, P, C,
        D, scale, rows_aligned16(q, D) && rows_aligned16(k, D));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  weights_kernel<<<P, NT, 0, s>>>(S, C, attn_thresh);
  if (dtype == kFloat32) {
    readout_f32_kernel<<<tiles_pd, NT, 0, s>>>(S, static_cast<const float*>(v),
                                               sz, static_cast<float*>(out), P,
                                               C, D);
  } else {
    readout_bf16_kernel<<<tiles_pd, WT, 0, s>>>(
        S, static_cast<const bf16*>(v), sz, static_cast<bf16*>(out), P, C, D,
        rows_aligned16(v, D));
  }
  colsum_kernel<<<(C + CC - 1) / CC, NT, 0, s>>>(S, static_cast<float*>(asum),
                                                  P, C);
  return (int)cudaGetLastError();
}
