// Scaled dot-product attention, softmax(q k^T * scale) v, head dim 64.
//
// Replaces the TPU kernel spann3r_tpu/ops/pallas_attention.py:_sdpa_kernel
// (launched by _sdpa_pallas, public fused_sdpa). Numerics follow it and
// the plain version: fp32 logits and softmax, the *normalised*
// probabilities rounded to v's dtype, PV accumulated in fp32, the output
// written in v's dtype.
//
// What bounds it on the card: at the slice's shapes (N = M = 768, Dh = 64)
// attention does ~4*N*M*Dh flops per head against ~4*(N+M)*Dh bytes, i.e.
// it is compute-bound in principle; this first version never writes the
// N x M score matrix to device memory, and it is limited by shared-memory
// traffic (scores and probabilities pass through shared memory) and the
// exp/divide work per score rather than by tensor-core throughput. A flash
// kernel's online softmax rescales *unnormalised* partial PV sums, which
// rounds differently from "normalise, round to v's dtype, then PV"; to
// match that exactly the kernel takes two sweeps over the keys: the first
// gets each row's max and sum-exp (online), the second forms p / z, rounds
// it to v's dtype and accumulates PV. The price is computing q k^T twice.
// wgmma/TMA pipelines and keeping scores in registers are later work.
//
// Two paths, one per dtype, with the same two sweeps and the same rounding
// of p to v's dtype:
//   - bf16 (the serving path): tensor cores through the warp-level WMMA API
//     (16x16x16 bf16 products, fp32 accumulators). One block of 4 warps per
//     (batch*head, 64-row query tile); each warp owns 16 query rows. Keys
//     and values go in 64-row tiles through shared memory; each warp writes
//     its 16 x 64 score tile to shared memory, where pairs of lanes take a
//     row each for the softmax statistics and the rounded probabilities,
//     which feed the PV product from shared memory.
//   - fp32: the CUDA cores (WMMA would round fp32 inputs to tf32). One block
//     per (batch*head, 64-row query tile), 256 threads as a 16 x 16 grid;
//     thread (ty, tx) owns query rows ty + 16a (a < 4); keys go in tiles of
//     32 through shared memory (rows padded against bank conflicts).
//     Measured on the card, this path is bound by shared-memory loads, not
//     by occupancy: a 16-row layout with four times the blocks ran the
//     one-frame decoder shape (12 heads) in the same time.
// Any N and M >= 1 (ragged edges are masked); every operand is read through
// its batch, head and row strides with unit stride in Dh.

#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace spann3r {
namespace {

constexpr int DH = 64;        // head dim
constexpr int TK = 32;        // keys per tile
constexpr int NT = 256;       // threads per block
constexpr int RP = DH + 1;    // padded q/k/v row
constexpr int PP = TK + 1;    // padded probability row
constexpr int R = 4;          // query rows per thread
constexpr int TQ = 16 * R;    // query rows per block

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long sn, int row0, int rows,
                                          int limit) {
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    const int gr = row0 + r;
    dst[r * RP + d] = gr < limit ? src[gr * sn + d] : 0.f;
  }
}

// s[a][c] = scale * q[ty + 16a] . k[tx + 16c], masked to -inf past M
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks,
                                            int ty, int tx, int k0, int M,
                                            float scale, float s[R][2]) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
    s[a][0] = 0.f;
    s[a][1] = 0.f;
  }
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float qv[R], kv[2];
#pragma unroll
    for (int a = 0; a < R; ++a) qv[a] = qs[(ty + 16 * a) * RP + d];
#pragma unroll
    for (int c = 0; c < 2; ++c) kv[c] = ks[(tx + 16 * c) * RP + d];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      s[a][0] = fmaf(qv[a], kv[0], s[a][0]);
      s[a][1] = fmaf(qv[a], kv[1], s[a][1]);
    }
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = k0 + tx + 16 * c;
      s[a][c] = col < M ? s[a][c] * scale : -INFINITY;
    }
  }
}

// reduce over the 16 lanes that share a query row (tx = lane & 15)
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(NT)
sdpa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int H,
                int N, int M, Strides qs_, Strides ks_, Strides vs_,
                Strides os_, float scale) {
  __shared__ float qs[TQ * RP];
  __shared__ float kv[TK * RP];
  __shared__ float ps[TQ * PP];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TQ;
  const float* qb = q + b * qs_.b + h * qs_.h;
  const float* kb = k + b * ks_.b + h * ks_.h;
  const float* vb = v + b * vs_.b + h * vs_.h;
  float* ob = o + b * os_.b + h * os_.h;

  load_rows(qs, qb, qs_.n, q0, TQ, N);
  const int ntiles = (M + TK - 1) / TK;

  // sweep 1: online row max and sum-exp
  float m_run[R], z_run[R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    m_run[a] = -INFINITY;
    z_run[a] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TK;
    __syncthreads();
    load_rows(kv, kb, ks_.n, k0, TK, M);
    __syncthreads();
    float s[R][2];
    tile_scores(qs, kv, ty, tx, k0, M, scale, s);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float m_new = fmaxf(m_run[a], row_max16(fmaxf(s[a][0], s[a][1])));
      const float part = row_sum16(expf(s[a][0] - m_new) + expf(s[a][1] - m_new));
      z_run[a] = z_run[a] * expf(m_run[a] - m_new) + part;
      m_run[a] = m_new;
    }
  }

  // sweep 2: normalised probabilities times v
  float acc[R][4];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TK;
    __syncthreads();
    load_rows(kv, kb, ks_.n, k0, TK, M);
    __syncthreads();
    float s[R][2];
    tile_scores(qs, kv, ty, tx, k0, M, scale, s);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[a][c] - m_run[a]) / z_run[a];
        ps[(ty + 16 * a) * PP + tx + 16 * c] = p;
      }
    __syncthreads();
    load_rows(kv, vb, vs_.n, k0, TK, M);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float vv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = kv[j * RP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const float p = ps[(ty + 16 * a) * PP + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) ob[r * os_.n + tx + 16 * c] = acc[a][c];
  }
}

// --- bf16 tensor-core path -------------------------------------------------
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int WT = 128;        // threads (4 warps)
constexpr int WQ = 64;         // query rows per block, 16 per warp
constexpr int WKT = 64;        // keys per tile
constexpr int BLD = DH + 8;    // bf16 row stride in shared memory (elements)
constexpr int FLD = WKT + 4;   // fp32 score row stride (elements)
constexpr size_t kWmmaSmem =
    sizeof(bf16) * (3 * 64 * BLD + 4 * 16 * BLD) + sizeof(float) * 4 * 16 * FLD;

// 64 rows into shared memory; 16-byte loads when the rows are 16-byte
// aligned (`vec`), element loads otherwise
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long sn, int row0,
                                               int limit, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < 64 * (DH / 8); e += WT) {
      const int r = e / (DH / 8), d = (e % (DH / 8)) * 8;
      const int gr = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < limit) val = *reinterpret_cast<const uint4*>(src + gr * sn + d);
      *reinterpret_cast<uint4*>(dst + r * BLD + d) = val;
    }
    return;
  }
  for (int e = threadIdx.x; e < 64 * DH; e += WT) {
    const int r = e / DH, d = e % DH;
    const int gr = row0 + r;
    dst[r * BLD + d] = gr < limit ? src[gr * sn + d] : __float2bfloat16_rn(0.f);
  }
}

__host__ __device__ inline bool rows_aligned16(const void* p, Strides st) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.n % 8 == 0;
}

// this warp's 16 x 64 score tile q k^T (unscaled) into shared memory
__device__ __forceinline__ void warp_scores(
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>* qf,
    const bf16* ks, float* sw) {
#pragma unroll
  for (int n = 0; n < WKT / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, ks + n * 16 * BLD + kk * 16, BLD);
      wmma::mma_sync(sf, qf[kk], kf, sf);
    }
    wmma::store_matrix_sync(sw + n * 16, sf, FLD, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(WT)
sdpa_wmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int N, int M, Strides qs_, Strides ks_, Strides vs_,
                 Strides os_, float scale, bool vq, bool vk, bool vv) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qsm = reinterpret_cast<bf16*>(smem);          // [64][BLD]
  bf16* ksm = qsm + 64 * BLD;                          // [64][BLD]
  bf16* vsm = ksm + 64 * BLD;                          // [64][BLD]
  bf16* psm = vsm + 64 * BLD;                          // [4][16][BLD]
  float* ssm = reinterpret_cast<float*>(psm + 4 * 16 * BLD);  // [4][16][FLD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * WQ;
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;
  bf16* ob = o + b * os_.b + h * os_.h;
  float* sw = ssm + warp * 16 * FLD;
  bf16* pw = psm + warp * 16 * BLD;
  // lanes 2r and 2r+1 share row r of the warp's tile, taking alternate
  // columns (c = 2i + c0) so that the pair hits different banks
  const int row = lane >> 1, c0 = lane & 1;

  load_tile_bf16(qsm, qb, qs_.n, q0, N, vq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DH / 16];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qsm + warp * 16 * BLD + kk * 16, BLD);

  const int ntiles = (M + WKT - 1) / WKT;

  // sweep 1: online row max and sum-exp
  float m_run = -INFINITY, z_run = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * WKT;
    __syncthreads();
    load_tile_bf16(ksm, kb, ks_.n, k0, M, vk);
    __syncthreads();
    warp_scores(qf, ksm, sw);
    __syncwarp();
    float s[32];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 2 * c + c0;
      s[c] = k0 + col < M ? sw[row * FLD + col] * scale : -INFINITY;
      mx = fmaxf(mx, s[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) part += expf(s[c] - m_new);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    z_run = z_run * expf(m_run - m_new) + part;
    m_run = m_new;
    __syncwarp();
  }

  // sweep 2: p / z rounded to bf16, times v
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DH / 16];
#pragma unroll
  for (int nb = 0; nb < DH / 16; ++nb) wmma::fill_fragment(acc[nb], 0.f);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * WKT;
    __syncthreads();
    load_tile_bf16(ksm, kb, ks_.n, k0, M, vk);
    load_tile_bf16(vsm, vb, vs_.n, k0, M, vv);
    __syncthreads();
    warp_scores(qf, ksm, sw);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 2 * c + c0;
      const float sc = sw[row * FLD + col] * scale;
      const float p = k0 + col < M ? expf(sc - m_run) / z_run : 0.f;
      pw[row * BLD + col] = __float2bfloat16_rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < WKT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, pw + kk * 16, BLD);
#pragma unroll
      for (int nb = 0; nb < DH / 16; ++nb) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vsm + kk * 16 * BLD + nb * 16, BLD);
        wmma::mma_sync(acc[nb], pf, vf, acc[nb]);
      }
    }
  }

  __syncwarp();
#pragma unroll
  for (int nb = 0; nb < DH / 16; ++nb)
    wmma::store_matrix_sync(sw + nb * 16, acc[nb], FLD, wmma::mem_row_major);
  __syncwarp();
  const int r = q0 + warp * 16 + row;
  if (r < N) {
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 2 * c + c0;
      ob[r * os_.n + col] = __float2bfloat16_rn(sw[row * FLD + col]);
    }
  }
}

void launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                int H, int N, int M, Strides sq, Strides sk, Strides sv,
                Strides so, float scale, cudaStream_t stream) {
  dim3 grid((N + TQ - 1) / TQ, B * H);
  sdpa_f32_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, N, M, sq, sk,
      sv, so, scale);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int N, int M, Strides sq, Strides sk,
                        Strides sv, Strides so, float scale,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sdpa_wmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWmmaSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + WQ - 1) / WQ, B * H);
  sdpa_wmma_kernel<<<grid, WT, kWmmaSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, N, M, sq, sk, sv,
      so, scale, rows_aligned16(q, sq), rows_aligned16(k, sk),
      rows_aligned16(v, sv));
  return cudaSuccess;
}

}  // namespace
}  // namespace spann3r

// q: (B, H, N, D), k and v: (B, H, M, D), out: (B, H, N, D); each with
// element strides (batch, head, row) and unit stride in D. D must be 64.
extern "C" int spann3r_sdpa(const void* q, const void* k, const void* v,
                            void* out, int dtype, int B, int H, int N, int M,
                            int D, long long qsb, long long qsh,
                            long long qsn, long long ksb, long long ksh,
                            long long ksn, long long vsb, long long vsh,
                            long long vsn, long long osb, long long osh,
                            long long osn, float scale, void* stream) {
  using namespace spann3r;
  if (D != DH || N < 1 || M < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsh, qsn}, sk{ksb, ksh, ksn}, sv{vsb, vsh, vsn},
      so{osb, osh, osn};
  if (dtype == kFloat32) {
    launch_f32(q, k, v, out, B, H, N, M, sq, sk, sv, so, scale, s);
  } else if (dtype == kBFloat16) {
    const cudaError_t err =
        launch_bf16(q, k, v, out, B, H, N, M, sq, sk, sv, so, scale, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
