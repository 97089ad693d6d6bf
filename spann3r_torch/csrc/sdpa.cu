// Scaled dot-product attention, softmax(q k^T * scale) v, head dim 64 or
// 32.
//
// Replaces the TPU kernel spann3r_tpu/ops/pallas_attention.py:_sdpa_kernel
// (launched by _sdpa_pallas, public fused_sdpa). Numerics follow it and
// the plain version: fp32 logits and softmax, the *normalised*
// probabilities rounded to v's dtype, PV accumulated in fp32, the output
// written in v's dtype.
//
// What bounds it on the card: at the slice's shapes (N = M = 768, Dh = 64)
// attention does 4*N*M*Dh flops per head against 2*(N+M)*Dh*2 bytes, so
// it is bound by the tensor cores at full occupancy; the one-frame calls
// (decoder, value encoder: 12 or 16 heads) make too few blocks to fill
// the card and are bound by each block's serial chain of key tiles. A
// flash kernel's online softmax rescales *unnormalised* partial PV sums,
// which rounds differently from "normalise, round to v's dtype, then PV";
// to keep the reference's order the kernel takes two sweeps over the keys: the
// first gets each row's max and sum-exp (online), the second forms p / z,
// rounds it to v's dtype and accumulates PV. The price is computing q k^T
// twice.
//
// Two paths, one per dtype, with the same two sweeps and the same rounding
// of p to v's dtype:
//   - bf16 (the serving path): Hopper's warpgroup tensor-core products
//     (wgmma, sm_90a). q k^T and PV run as m64n64k16 wgmma with fp32
//     accumulators in registers; the softmax statistics and p never leave
//     the registers (p becomes the A operand of the PV wgmma directly). K
//     and V tiles arrive by 16-byte cp.async into a two-stage ring of
//     128-byte-swizzled tiles, so the copy of the next tile overlaps the
//     math on this one. cp.async rather than TMA: q, k and v are strided
//     views of the projections (row stride 3C or C), and cp.async reads
//     them through the strides the wrapper passes, with no tensor map to
//     encode and cache on the host per pointer and stride. One warpgroup
//     per block of 64 query rows: the one-frame grids (12 or 16 heads x
//     12 row tiles) give each of the 132 SMs about one block; splitting a
//     block's key tiles over two warpgroups gained 2% there (PERF.md) and
//     was dropped. p = exp(s - max) / sum is formed as exp2f of the
//     logits in log2 units times 1 / sum: its fp32 value may differ from
//     expf(s - max) / sum in the last bits, and so the bf16 p from the
//     reference's by up to one bf16 ulp where it lies next to a rounding
//     boundary. expf and a true divide made the kernel 1.6-1.9x slower
//     (PERF.md).
//   - fp32: the CUDA cores (the tensor cores would round fp32 inputs to
//     tf32). One block per (batch*head, 64-row query tile), 256 threads as
//     a 16 x 16 grid; thread (ty, tx) owns query rows ty + 16a (a < 4);
//     keys go in tiles of 32 through shared memory (rows padded against
//     bank conflicts). This path serves only the fp32 parity runs.
// Any N and M >= 1 (ragged edges are masked); every operand is read through
// its batch, head and row strides with unit stride in Dh.
//
// Head dim 32 (the CroCo decoder's 512 / 16 heads) takes the same kernels,
// instantiated at DH = 32. The fp32 path's rows are DH + 1 floats and each
// thread owns DH / 16 output columns. The bf16 path keeps the 64-wide
// swizzled tile (128-byte rows, the 128-byte swizzle of hopper.cuh): each
// q, k and v tile is loaded with its columns DH..63 zero-filled (the loads
// are masked by column, since those columns of a strided view hold the next
// head), q k^T runs only the DH / 16 k-steps that hold data, and PV's
// accumulator columns DH..63, zero, are never stored. So PV does twice the
// products it needs; a 64-byte-swizzle tile with m64n32k16 would not
// (PERF.md).
//
// For training, the forward also writes each row's logsumexp of the scaled
// logits, fp32, natural-log units, (B, H, N) contiguous, which the backward
// (sdpa_bwd.cu) reads to recompute the probabilities. A null lse pointer
// writes none; the lse store comes after the output's arithmetic and
// changes none of its bits.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace spann3r {
namespace {

constexpr int TK = 32;        // keys per tile
constexpr int NT = 256;       // threads per block
constexpr int PP = TK + 1;    // padded probability row
constexpr int R = 4;          // query rows per thread
constexpr int TQ = 16 * R;    // query rows per block

struct Strides {
  long long b, h, n;
};

template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long sn, int row0, int rows,
                                          int limit) {
  constexpr int RP = DH + 1;   // padded q/k/v row
  for (int e = threadIdx.x; e < rows * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    const int gr = row0 + r;
    dst[r * RP + d] = gr < limit ? src[gr * sn + d] : 0.f;
  }
}

// s[a][c] = scale * q[ty + 16a] . k[tx + 16c], masked to -inf past M
template <int DH>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks,
                                            int ty, int tx, int k0, int M,
                                            float scale, float s[R][2]) {
  constexpr int RP = DH + 1;   // padded q/k/v row
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

template <int DH>
__global__ void __launch_bounds__(NT)
sdpa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int H, int N, int M, Strides qs_,
                Strides ks_, Strides vs_, Strides os_, float scale) {
  constexpr int RP = DH + 1;   // padded q/k/v row
  constexpr int DC = DH / 16;   // output columns a thread owns
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

  load_rows<DH>(qs, qb, qs_.n, q0, TQ, N);
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
    load_rows<DH>(kv, kb, ks_.n, k0, TK, M);
    __syncthreads();
    float s[R][2];
    tile_scores<DH>(qs, kv, ty, tx, k0, M, scale, s);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float m_new = fmaxf(m_run[a], row_max16(fmaxf(s[a][0], s[a][1])));
      const float part = row_sum16(expf(s[a][0] - m_new) + expf(s[a][1] - m_new));
      z_run[a] = z_run[a] * expf(m_run[a] - m_new) + part;
      m_run[a] = m_new;
    }
  }

  // sweep 2: normalised probabilities times v
  float acc[R][DC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * TK;
    __syncthreads();
    load_rows<DH>(kv, kb, ks_.n, k0, TK, M);
    __syncthreads();
    float s[R][2];
    tile_scores<DH>(qs, kv, ty, tx, k0, M, scale, s);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[a][c] - m_run[a]) / z_run[a];
        ps[(ty + 16 * a) * PP + tx + 16 * c] = p;
      }
    __syncthreads();
    load_rows<DH>(kv, vb, vs_.n, k0, TK, M);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = kv[j * RP + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const float p = ps[(ty + 16 * a) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(p, vv[c], acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= N) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) ob[r * os_.n + tx + 16 * c] = acc[a][c];
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * N + r] = m_run[a] + logf(z_run[a]);
  }
}

// --- bf16 path: wgmma tensor cores ---------------------------------------
using hopper::bf16;
constexpr int KT = 64;          // keys per tile
constexpr int STAGES = 2;       // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;
// 1024 bytes of slack to align the tiles, the q tile, then a ring of (K, V)
// tile pairs
constexpr size_t kWgmmaSmem = 1024 + hopper::kTileBytes * (1 + 2 * STAGES);

// One warpgroup per block owns 64 query rows of one (batch, head) and
// sweeps the key tiles twice through its cp.async ring (the copy of the
// next tile runs during the math on this one). Sweep 1: S = q k^T on wgmma
// into registers; each row's max and sum-exp stay in registers (the 4
// lanes that share a row combine by shuffles). Sweep 2: S again; p =
// exp(s - max) / sum (as exp2f of the logits in log2 units, times 1 / sum),
// rounded to bf16 in registers, is repacked from the
// accumulator layout into the A fragment of the PV wgmma (A from
// registers, V from shared memory), O in fp32 registers.
template <int DH>
__global__ void __launch_bounds__(128)
sdpa_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int H, int N, int M, Strides qs_,
                  Strides ks_, Strides vs_, Strides os_, float scale, bool vq,
                  bool vk, bool vv) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qsm = align1024(smem_raw);
  unsigned char* ring = qsm + kTileBytes;

  const int t = threadIdx.x & 127;   // < 128: the tile loops unroll fully
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64;
  const bf16* qb = q + b * qs_.b + h * qs_.h;
  const bf16* kb = k + b * ks_.b + h * ks_.h;
  const bf16* vb = v + b * vs_.b + h * vs_.h;
  bf16* ob = o + b * os_.b + h * os_.h;
  const float sl2 = scale * kLog2e;   // logits in log2 units

  const int ntiles = (M + KT - 1) / KT;
  const int steps = 2 * ntiles;   // sweep 1: K tiles; sweep 2: K and V tiles
  auto first_key = [&](int j) { return (j < ntiles ? j : j - ntiles) * KT; };
  auto prefetch = [&](int j) {
    if (j < steps) {
      unsigned char* st = ring + (j % STAGES) * 2 * kTileBytes;
      load_tile(st, kb, ks_.n, first_key(j), M, vk, t, 128, 0, DH);
      if (j >= ntiles)
        load_tile(st + kTileBytes, vb, vs_.n, first_key(j), M, vv, t, 128, 0,
                  DH);
    }
    cp_async_commit();
  };

  load_tile(qsm, qb, qs_.n, q0, N, vq, t, 128, 0, DH);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) prefetch(j);
  cp_async_wait<STAGES - 1>();   // the q tile
  fence_async_smem();
  __syncthreads();

  // this thread's rows: r0 (accumulator elements with (i / 2) % 2 == 0)
  // and r0 + 8
  const int r0 = acc_row(t, 0);
  float m_run[2] = {-INFINITY, -INFINITY}, z_run[2] = {0.f, 0.f};
  float s[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  // S = (q k^T) * scale * log2(e) for step j, masked to -inf past M
  auto scores = [&](int j) {
    cp_async_wait<STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    prefetch(j + STAGES - 1);
    const unsigned char* st = ring + (j % STAGES) * 2 * kTileBytes;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)   // the k-steps that hold data
      wgmma_ss<0>(s, desc(qsm, kk * 32), desc(st, kk * 32), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const int k0 = first_key(j);
    const bool ragged = k0 + KT > M;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] *= sl2;
      if (ragged && k0 + acc_col(t, i) >= M) s[i] = -INFINITY;
    }
    return st;
  };

  for (int j = 0; j < ntiles; ++j) {   // sweep 1: online max and sum-exp
    scores(j);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hr) mx = fmaxf(mx, s[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hr) part += exp2f(s[i] - m_new);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      z_run[hr] = z_run[hr] * exp2f(m_run[hr] - m_new) + part;
      m_run[hr] = m_new;
    }
  }

  const float inv_z[2] = {1.f / z_run[0], 1.f / z_run[1]};
  for (int j = ntiles; j < steps; ++j) {   // sweep 2: p rounded to bf16, PV
    const unsigned char* st = scores(j);
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, hr = r & 1;
        pa[kk][r] = pack_bf16(exp2f(s[i] - m_run[hr]) * inv_z[hr],
                              exp2f(s[i + 1] - m_run[hr]) * inv_z[hr]);
      }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(acc, pa[kk], desc(st + kTileBytes, kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < DH / 2; i += 4) {   // columns < DH
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r0 + 8 * hr;
      if (row < N)
        *reinterpret_cast<uint32_t*>(ob + row * os_.n + acc_col(t, i)) =
            pack_bf16(acc[i + 2 * hr], acc[i + 2 * hr + 1]);
    }
  }
  // the 4 lanes of a row hold the same statistics; m_run is in log2 units
  if (lse != nullptr && (t & 3) == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = q0 + r0 + 8 * hr;
      if (row < N)
        lse[(long long)bh * N + row] =
            (m_run[hr] + log2f(z_run[hr])) * 0.6931471805599453f;
    }
  }
}

__host__ __device__ inline bool rows_aligned16(const void* p, Strides st) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.h % 8 == 0 && st.n % 8 == 0;
}

template <int DH>
void launch_f32(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int N, int M, Strides sq, Strides sk,
                Strides sv, Strides so, float scale, cudaStream_t stream) {
  dim3 grid((N + TQ - 1) / TQ, B * H);
  sdpa_f32_kernel<DH><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, N, M, sq,
      sk, sv, so, scale);
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int N, int M, Strides sq,
                        Strides sk, Strides sv, Strides so, float scale,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      sdpa_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWgmmaSmem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 63) / 64, B * H);
  sdpa_wgmma_kernel<DH><<<grid, 128, kWgmmaSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, N, M, sq, sk,
      sv, so, scale, rows_aligned16(q, sq), rows_aligned16(k, sk),
      rows_aligned16(v, sv));
  return cudaSuccess;
}

template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int B, int H, int N, int M,
                   Strides sq, Strides sk, Strides sv, Strides so, float scale,
                   cudaStream_t stream) {
  if (dtype == kFloat32) {
    launch_f32<DH>(q, k, v, o, lse, B, H, N, M, sq, sk, sv, so, scale, stream);
    return cudaSuccess;
  }
  if (dtype == kBFloat16)
    return launch_bf16<DH>(q, k, v, o, lse, B, H, N, M, sq, sk, sv, so, scale,
                           stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace spann3r

// q: (B, H, N, D), k and v: (B, H, M, D), out: (B, H, N, D); each with
// element strides (batch, head, row) and unit stride in D. D must be 64 or
// 32.
// lse: null, or fp32 (B, H, N) contiguous for each row's logsumexp.
extern "C" int spann3r_sdpa(const void* q, const void* k, const void* v,
                            void* out, void* lse, int dtype, int B, int H,
                            int N, int M,
                            int D, long long qsb, long long qsh,
                            long long qsn, long long ksb, long long ksh,
                            long long ksn, long long vsb, long long vsh,
                            long long vsn, long long osb, long long osh,
                            long long osn, float scale, void* stream) {
  using namespace spann3r;
  if ((D != 64 && D != 32) || N < 1 || M < 1 || B * H < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides sq{qsb, qsh, qsn}, sk{ksb, ksh, ksn}, sv{vsb, vsh, vsn},
      so{osb, osh, osn};
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      D == 64 ? launch<64>(dtype, q, k, v, out, l, B, H, N, M, sq, sk, sv, so,
                           scale, s)
              : launch<32>(dtype, q, k, v, out, l, B, H, N, M, sq, sk, sv, so,
                           scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
