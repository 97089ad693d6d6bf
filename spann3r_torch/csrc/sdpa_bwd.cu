// Backward of scaled dot-product attention, softmax(q k^T * scale) v, head
// dim 64: dq, dk and dv from q, k, v, the output's cotangent dO and the
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
//     dq = dS k,   dk = dS^T q
// all in fp32, each result rounded once to q's dtype.
//
// What bounds it on the card: at the training shapes (N = M = 196,
// Dh = 64) the backward does five N x M x 64 products per head against
// ~7 N x 64 elements moved, so the tensor cores would bound it; this first
// design computes on the CUDA cores in fp32 (bf16 and fp32 inputs alike)
// and recomputes s and dP once more than a fused kernel would, so it runs
// well above that bound. Two passes, both of the fp32 forward's shape
// (256 threads as a 16 x 16 grid, tiles through padded shared memory):
//   - pass 1, one block per (batch*head, 64 query rows): a sweep over the
//     key tiles (32 keys) accumulates each row's D; a second sweep forms dS
//     and accumulates dq in registers. D goes to a (B, H, N) scratch.
//   - pass 2, one block per (batch*head, 64 key rows): a sweep over the
//     query tiles (32 queries) recomputes P and dP from lse and D,
//     accumulates dv and dk in registers.
// No atomics: every output element has one owner, so the result does not
// depend on the order blocks run in. wgmma, TMA and a fused single pass are
// later work. Any N, M >= 1 (ragged tiles are masked); q, k, v, dO and the
// three outputs are read and written through their batch, head and row
// strides with unit stride in Dh.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace spann3r {
namespace {

constexpr int DH = 64;        // head dim
constexpr int NT = 256;       // threads per block
constexpr int RP = DH + 1;    // padded row of a q/k/v/dO tile
constexpr int TR = 64;        // rows a block owns (queries, then keys)
constexpr int TC = 32;        // rows a sweep streams per tile
constexpr int CP = TC + 1;    // padded row of a P / dS tile

struct Strides {
  long long b, h, n;
};

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long sn, int row0, int rows,
                                          int limit) {
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    const int gr = row0 + r;
    dst[r * RP + d] = gr < limit ? to_f(src[gr * sn + d]) : 0.f;
  }
}

// out[a][c] = a_rows[ty + 16a] . b_rows[tx + 16c] over Dh
__device__ __forceinline__ void dots(const float* a_rows, const float* b_rows,
                                     int ty, int tx, float out[4][2]) {
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

constexpr size_t kDqSmem = sizeof(float) * (2 * TR * RP + 2 * TC * RP + TR * CP);
constexpr size_t kDkvSmem =
    sizeof(float) * (2 * TR * RP + 2 * TC * RP + 2 * TR * CP + 2 * TC);

// pass 1: D and dq for 64 query rows of one (batch, head)
template <typename T>
__global__ void __launch_bounds__(NT)
sdpa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ drow,
                   T* __restrict__ dq, int H, int N, int M, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   float scale) {
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

  load_rows(qs, qb, sq.n, q0, TR, N);
  load_rows(dos, dob, sdo.n, q0, TR, N);
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
    load_rows(ks, kb, sk.n, k0, TC, M);
    load_rows(vs, vb, sv.n, k0, TC, M);
    __syncthreads();
    float s[4][2], dp[4][2];
    dots(qs, ks, ty, tx, s);
    dots(dos, vs, ty, tx, dp);
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
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TC;
    __syncthreads();
    load_rows(ks, kb, sk.n, k0, TC, M);
    load_rows(vs, vb, sv.n, k0, TC, M);
    __syncthreads();
    float s[4][2], dp[4][2];
    dots(qs, ks, ty, tx, s);
    dots(dos, vs, ty, tx, dp);
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
      float kv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[j * RP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ds = dss[(ty + 16 * a) * CP + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(ds, kv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dqb[r * sdq.n + tx + 16 * c] = from_f<T>(acc[a][c]);
    if (tx == 0) drow[(long long)bh * N + r] = dsum[a];
  }
}

// pass 2: dk and dv for 64 key rows of one (batch, head)
template <typename T>
__global__ void __launch_bounds__(NT)
sdpa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ drow, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int N, int M, Strides sq,
                    Strides sk, Strides sv, Strides sdo, Strides sdk,
                    Strides sdv, float scale) {
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

  load_rows(ks, kb, sk.n, k0, TR, M);
  load_rows(vs, vb, sv.n, k0, TR, M);
  float adk[4][4], adv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) adk[a][c] = adv[a][c] = 0.f;

  const int ntiles = (N + TC - 1) / TC;
  for (int t = 0; t < ntiles; ++t) {
    const int n0 = t * TC;
    __syncthreads();
    load_rows(qs, qb, sq.n, n0, TC, N);
    load_rows(dos, dob, sdo.n, n0, TC, N);
    if (tid < TC) {
      const int r = n0 + tid;
      ls[tid] = r < N ? lse[(long long)bh * N + r] : 0.f;
      drs[tid] = r < N ? drow[(long long)bh * N + r] : 0.f;
    }
    __syncthreads();
    float s[4][2], dp[4][2];
    dots(ks, qs, ty, tx, s);     // s[a][c]: key ty + 16a, query tx + 16c
    dots(vs, dos, ty, tx, dp);
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
      float dov[4], qv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dov[c] = dos[j * RP + tx + 16 * c];
        qv[c] = qs[j * RP + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p = ps[(ty + 16 * a) * CP + j];
        const float ds = dss[(ty + 16 * a) * CP + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
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
    for (int c = 0; c < 4; ++c) {
      dkb[r * sdk.n + tx + 16 * c] = from_f<T>(adk[a][c]);
      dvb[r * sdv.n + tx + 16 * c] = from_f<T>(adv[a][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, float* drow, void* dq,
                   void* dk, void* dv, int B, int H, int N, int M, Strides sq,
                   Strides sk, Strides sv, Strides sdo, Strides sdq,
                   Strides sdk, Strides sdv, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sdpa_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvSmem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  sdpa_bwd_dq_kernel<T><<<dim3((N + TR - 1) / TR, B * H), NT, kDqSmem,
                          stream>>>(qt, kt, vt, dot, lse, drow,
                                    static_cast<T*>(dq), H, N, M, sq, sk, sv,
                                    sdo, sdq, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sdpa_bwd_dkv_kernel<T><<<dim3((M + TR - 1) / TR, B * H), NT, kDkvSmem,
                           stream>>>(qt, kt, vt, dot, lse, drow,
                                     static_cast<T*>(dk), static_cast<T*>(dv),
                                     H, N, M, sq, sk, sv, sdo, sdk, sdv,
                                     scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spann3r

// q, dO, dq: (B, H, N, D); k, v, dk, dv: (B, H, M, D); each with element
// strides (batch, head, row) and unit stride in D. D must be 64. lse: the
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
  if (D != DH || N < 1 || M < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsh, qsn}, sk{ksb, ksh, ksn}, sv{vsb, vsh, vsn},
      sdo{dosb, dosh, dosn}, sdq{dqsb, dqsh, dqsn}, sdk{dksb, dksh, dksn},
      sdv{dvsb, dvsh, dvsn};
  const float* l = static_cast<const float*>(lse);
  float* dr = static_cast<float*>(drow);
  cudaError_t err;
  if (dtype == kFloat32) {
    err = launch<float>(q, k, v, dout, l, dr, dq, dk, dv, B, H, N, M, sq, sk,
                        sv, sdo, sdq, sdk, sdv, scale, s);
  } else if (dtype == kBFloat16) {
    err = launch<__nv_bfloat16>(q, k, v, dout, l, dr, dq, dk, dv, B, H, N, M,
                                sq, sk, sv, sdo, sdq, sdk, sdv, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
