// Spatial-memory readout: thresholded, renormalised single-head attention
// of P queries over a C-slot token bank, plus per-slot column sums, for B
// streams, each with its own bank and its own count of valid slots.
//
// Replaces the TPU kernels spann3r_tpu/ops/pallas_memory.py:_pass1_kernel,
// _pass2_kernel and _pass3_kernel (launched by memory_read_attention).
// For stream b, query p and slot c < n (n = size[b]; for an empty bank
// every score is the mask value, so n = C and the softmax is uniform):
//     s[p, c] = q[p] . k[c] / sqrt(D)
//     a[p, c] = exp(s - max_c s) / sum_c exp(s - max_c s)
// with attn_thresh > 0:
//     a = (a < attn_thresh ? 0 : a) / (sum_c of that + 1e-12)
// out[p] = sum_c a[p, c] v[c] (written in q's dtype) and
// asum[c] = sum_p a[p, c] (fp32), the statistic the prune ranks slots by.
// Slots at or past n have a == 0 exactly (their masked score underflows
// exp), so no stage reads or computes them, and asum there is 0.
//
// What bounds it on the card: at 512x384 (P = 768, C = 8704, D = 1024) the
// two products q k^T and a v are 13.7 GFLOP each at a full bank against
// ~36 MB of bank, so they belong on the tensor cores (28 us at the bf16
// peak). The threshold needs each row's final max and sum before any
// weight can be kept or dropped, so the work goes in stages:
//   1. scores  - S = q k^T * scale into a fp32 scratch (P x L per stream,
//                L = C, rounded up to 128 for bf16; it stays in the 50 MB
//                L2);
//   2. weights - one block per query row: its max, sum-exp and kept mass
//                from one read of its scores, then its final weights,
//                written as fp32 over the scores;
//   3. readout - a v, split over the slot axis into NSPLIT ranges so that
//                the card fills at any n (a 768-slot bank makes as many
//                blocks as a full one); fp32 partial readouts;
//   4. finish  - the partial readouts added up in a fixed order, and the
//                column sums of the fp32 weights, each over the P rows in
//                a fixed order.
// bf16 banks (the serving path) run 1 and 3 on Hopper's warpgroup tensor
// cores (wgmma, sm_90a) with fp32 accumulators in registers. Operand tiles
// arrive by 16-byte cp.async into a ring of 128-byte-swizzled shared-memory
// tiles, so the copy of the next tile overlaps the products on this one.
// cp.async rather than TMA: every tile needs masking at P, n or D, which
// cp.async's zero fill gives per 16 bytes, and there is no tensor map to
// encode and cache on the host for each pointer. The weights a stay fp32 as
// in the TPU kernel (fp32 a times v): stage 2 also writes each a once as a
// bf16 high part and a bf16 remainder (a = hi + lo to ~2^-17 relative), and
// the readout multiplies both by the same v tile. fp32 banks run 1 and 3 on
// the CUDA cores (the tensor cores would round fp32 inputs to tf32), the
// readout reading the fp32 weights; their kernels take one stream and are
// launched once per stream (this path serves the fp32 parity runs only).
// No float atomics anywhere: the column sums feed the prune's top-k, and a
// run-to-run change in their last bits could flip a prune decision.
// `size` is read from device memory, so the caller never waits on the
// device to learn it.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace spann3r {
namespace {

using hopper::bf16;
using hopper::kTileBytes;

constexpr int NT = 256;
constexpr float kMask = -1e30f;
constexpr float kRenormEps = 1e-12f;
constexpr int NSPLIT = 4;    // slot ranges of the bf16 readout

// slots the weights cover: the valid ones, or all of an empty bank
__device__ __forceinline__ int live_slots(int size, int C) {
  return size > 0 ? min(size, C) : C;
}

// row stride (elements) of the score and weight scratch: C rounded up to
// the 128-slot blocks of the tensor-core scores, C on the CUDA-core path
inline int scratch_ld(int dtype, int C) {
  return dtype == kBFloat16 ? (C + 127) / 128 * 128 : C;
}

// slot range [x, y) of readout split s over n live slots, in whole 64-slot
// tiles (the weights past n up to the tile's end are written as 0)
__device__ __forceinline__ int2 split_range(int n, int s) {
  const int tiles = (n + 63) / 64;
  const int per = (tiles + NSPLIT - 1) / NSPLIT;
  return make_int2(64 * min(tiles, s * per), 64 * min(tiles, (s + 1) * per));
}

// --- 1. scores: S[p, c] = scale * q[p] . k[c] for c < n --------------------
constexpr int ST = 64;   // output tile (rows and columns), CUDA-core path
constexpr int SD = 32;   // depth step
constexpr int SP = SD + 1;

// fp32 (CUDA cores): one stream per launch; tiles past size hold the mask
// value
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

constexpr int SN = 128;       // slots per wgmma scores block (two tiles)
constexpr int KSTAGES = 3;    // cp.async ring depth of the scores block

constexpr size_t scores_smem_bytes() {
  // 1024 bytes of slack to align the tiles; per stage a q tile and two k
  // tiles of 64 rows x 64 depth
  return 1024 + (size_t)kTileBytes * 3 * KSTAGES;
}

// One warpgroup per block: 64 query rows x 128 slots, the depth D in steps
// of 64 through the cp.async ring; two m64n64 accumulators in registers.
__global__ void __launch_bounds__(128)
scores_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const int* __restrict__ size_ptr, float* __restrict__ S,
                    int P, int C, int D, int L, float scale, bool vec) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int c0 = blockIdx.x * SN, p0 = blockIdx.y * 64, b = blockIdx.z;
  const int size = size_ptr[b];
  if (size <= 0 || c0 >= min(size, C)) return;   // the weights never read it
  const int n = min(size, C), t = threadIdx.x;
  const bf16* qb = q + (long long)b * P * D;
  const bf16* kb = k + (long long)b * C * D;
  const int steps = (D + 63) / 64;
  auto prefetch = [&](int j) {
    if (j < steps) {
      unsigned char* st = ring + (j % KSTAGES) * 3 * kTileBytes;
      load_tile(st, qb, D, p0, P, vec, t, 128, 64 * j, D);
      load_tile(st + kTileBytes, kb, D, c0, n, vec, t, 128, 64 * j, D);
      load_tile(st + 2 * kTileBytes, kb, D, c0 + 64, n, vec, t, 128, 64 * j, D);
    }
    cp_async_commit();
  };

  float s0[32], s1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.f;
#pragma unroll
  for (int j = 0; j < KSTAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<KSTAGES - 2>();
    fence_async_smem();
    __syncthreads();
    prefetch(j + KSTAGES - 1);
    const unsigned char* st = ring + (j % KSTAGES) * 3 * kTileBytes;
    fence_regs(s0);
    fence_regs(s1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dq = desc(st, kk * 32);
      wgmma_ss<0>(s0, dq, desc(st + kTileBytes, kk * 32), 1);
      wgmma_ss<0>(s1, dq, desc(st + 2 * kTileBytes, kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s0);
    fence_regs(s1);
  }
  cp_async_wait<0>();

  float* Sb = S + (long long)b * P * L;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = p0 + acc_row(t, i), col = c0 + acc_col(t, i);
    if (row < P) {
      float* dst = Sb + (long long)row * L + col;
      *reinterpret_cast<float2*>(dst) = make_float2(s0[i] * scale, s0[i + 1] * scale);
      *reinterpret_cast<float2*>(dst + 64) =
          make_float2(s1[i] * scale, s1[i + 1] * scale);
    }
  }
}

// --- 2. weights: row statistics and final weights --------------------------
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

// Block (p, b) takes query row p of stream b. Dynamic shared memory: L
// floats, the row's exps; thread x only ever touches entries c = x + NT * j,
// so they need no barrier. The row's scores are read once; exp is taken
// once per weight. The weights go out as fp32 over the scores, and with
// `ahi` also as bf16 high and low parts, up to n rounded up to 64 (0 past
// n; the readouts read whole tiles) or the row's end.
__global__ void __launch_bounds__(NT)
weights_kernel(float* __restrict__ S, bf16* __restrict__ ahi,
               bf16* __restrict__ alo, const int* __restrict__ size_ptr,
               int P, int C, int L, float attn_thresh) {
  extern __shared__ float row[];
  const int p = blockIdx.x, b = blockIdx.y;
  const int size = size_ptr[b];
  const int n = live_slots(size, C);
  const int nw = min((n + 63) / 64 * 64, L);
  const long long off = ((long long)b * P + p) * L;
  float mx = -INFINITY;
  for (int c = threadIdx.x; c < n; c += NT) {
    const float x = size > 0 ? S[off + c] : 0.f;
    row[c] = x;
    mx = fmaxf(mx, x);
  }
  const float m = block_reduce(mx, true);
  float sm = 0.f;
  for (int c = threadIdx.x; c < n; c += NT) {
    const float e = expf(row[c] - m);
    row[c] = e;
    sm += e;
  }
  const float z = block_reduce(sm, false);
  float denom = 1.f;
  if (attn_thresh > 0.f) {
    float kp = 0.f;
    for (int c = threadIdx.x; c < n; c += NT) {
      const float a = row[c] / z;
      kp += a < attn_thresh ? 0.f : a;
    }
    denom = block_reduce(kp, false) + kRenormEps;
  }
  for (int c = threadIdx.x; c < nw; c += NT) {
    float a = 0.f;
    if (c < n) {
      a = row[c] / z;
      if (attn_thresh > 0.f) a = (a < attn_thresh ? 0.f : a) / denom;
    }
    S[off + c] = a;
    if (ahi) {
      const bf16 hi = __float2bfloat16_rn(a);
      ahi[off + c] = hi;
      alo[off + c] = __float2bfloat16_rn(a - __bfloat162float(hi));
    }
  }
}

// --- 3. readout: out[p] = sum_c a[p, c] v[c] -------------------------------
constexpr int RT = 64;   // query rows and value columns per block
constexpr int RC = 32;   // slots per step
constexpr int RAP = RC + 1;
constexpr int RVP = RT + 1;

// fp32 (CUDA cores): one stream per launch, the weights with row stride C
__global__ void __launch_bounds__(NT)
readout_f32_kernel(const float* __restrict__ A, const float* __restrict__ v,
                   const int* __restrict__ size_ptr, float* __restrict__ out,
                   int P, int C, int D) {
  __shared__ float as[RT * RAP];
  __shared__ float vs[RC * RVP];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int d0 = blockIdx.x * RT, p0 = blockIdx.y * RT;
  const int cend = live_slots(*size_ptr, C);

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

constexpr int RSTAGES = 2;    // cp.async ring depth of the readout block

constexpr size_t readout_smem_bytes() {
  // slack, then per stage the hi and lo weight tiles (64 rows x 64 slots)
  // and two v tiles (64 slots x 64 value columns)
  return 1024 + (size_t)kTileBytes * 4 * RSTAGES;
}

// One warpgroup per block: 64 query rows x 128 value columns over the
// block's slot range (split blockIdx.z % NSPLIT of stream blockIdx.z /
// NSPLIT), 64 slots a step; per step and 16-slot slice, hi * v and lo * v
// for each of the two 64-column halves. The fp32 result goes to
// part[b][split] for the finish kernel.
__global__ void __launch_bounds__(128)
readout_wgmma_kernel(const bf16* __restrict__ ahi, const bf16* __restrict__ alo,
                     const bf16* __restrict__ v, const int* __restrict__ size_ptr,
                     float* __restrict__ part, int P, int C, int D, int L,
                     bool vec) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int d0 = blockIdx.x * 128, p0 = blockIdx.y * 64;
  const int b = blockIdx.z / NSPLIT, sp = blockIdx.z % NSPLIT;
  const int n = live_slots(size_ptr[b], C);
  const int2 range = split_range(n, sp);
  if (range.x >= range.y) return;
  const int t = threadIdx.x;
  const bf16* hb = ahi + (long long)b * P * L;
  const bf16* lb = alo + (long long)b * P * L;
  const bf16* vb = v + (long long)b * C * D;
  const int steps = (range.y - range.x) / 64;
  auto prefetch = [&](int j) {
    if (j < steps) {
      unsigned char* st = ring + (j % RSTAGES) * 4 * kTileBytes;
      const int c = range.x + 64 * j;
      load_tile(st, hb, L, p0, P, true, t, 128, c, L);
      load_tile(st + kTileBytes, lb, L, p0, P, true, t, 128, c, L);
      load_tile(st + 2 * kTileBytes, vb, D, c, n, vec, t, 128, d0, D);
      load_tile(st + 3 * kTileBytes, vb, D, c, n, vec, t, 128, d0 + 64, D);
    }
    cp_async_commit();
  };

  float o0[32], o1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = o1[i] = 0.f;
#pragma unroll
  for (int j = 0; j < RSTAGES - 1; ++j) prefetch(j);
  for (int j = 0; j < steps; ++j) {
    cp_async_wait<RSTAGES - 2>();
    fence_async_smem();
    __syncthreads();
    prefetch(j + RSTAGES - 1);
    const unsigned char* st = ring + (j % RSTAGES) * 4 * kTileBytes;
    fence_regs(o0);
    fence_regs(o1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = desc(st, kk * 32), dl = desc(st + kTileBytes, kk * 32);
      const uint64_t v0 = desc(st + 2 * kTileBytes, kk * 2048);
      const uint64_t v1 = desc(st + 3 * kTileBytes, kk * 2048);
      wgmma_ss<1>(o0, dh, v0, 1);
      wgmma_ss<1>(o0, dl, v0, 1);
      wgmma_ss<1>(o1, dh, v1, 1);
      wgmma_ss<1>(o1, dl, v1, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
  }
  cp_async_wait<0>();

  float* pb = part + (long long)(b * NSPLIT + sp) * P * D;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = p0 + acc_row(t, i);
    if (row >= P) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = d0 + 64 * half + acc_col(t, i);
      const float x0 = half ? o1[i] : o0[i], x1 = half ? o1[i + 1] : o0[i + 1];
      float* dst = pb + (long long)row * D + col;
      if ((D & 1) == 0) {   // col is even, so col < D covers col + 1
        if (col < D) *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
      } else {
        if (col < D) dst[0] = x0;
        if (col + 1 < D) dst[1] = x1;
      }
    }
  }
}

// --- 4. finish: partial readouts and column sums, in order ----------------
__global__ void __launch_bounds__(NT)
finish_out_kernel(const float* __restrict__ part,
                  const int* __restrict__ size_ptr, bf16* __restrict__ out,
                  int P, int C, int D) {
  const int b = blockIdx.y;
  const long long pd = (long long)P * D;
  const long long e = (long long)blockIdx.x * NT + threadIdx.x;
  if (e >= pd) return;
  const int n = live_slots(size_ptr[b], C);
  const float* pb = part + (long long)b * NSPLIT * pd + e;
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < NSPLIT; ++s) {
    const int2 r = split_range(n, s);
    if (r.x < r.y) acc += pb[s * pd];
  }
  out[b * pd + e] = __float2bfloat16_rn(acc);
}

constexpr int CC = 32;          // slots per column-sum block
constexpr int CR = NT / CC;     // row-group lanes per column-sum block

// asum[b][c] = sum_p A[b][p][c] for c < n (0 past n): lane ry of the block
// sums rows ry, ry + CR, ... in order, then the CR lane sums add in order.
__global__ void __launch_bounds__(NT)
colsum_kernel(const float* __restrict__ A, const int* __restrict__ size_ptr,
              float* __restrict__ asum, int P, int C, int L) {
  __shared__ float part[CR][CC];
  const int cx = threadIdx.x % CC, ry = threadIdx.x / CC;
  const int b = blockIdx.y, gc = blockIdx.x * CC + cx;
  const int n = live_slots(size_ptr[b], C);
  float acc = 0.f;
  if (gc < n) {
    const float* pb = A + (long long)b * P * L + gc;
    for (int p = ry; p < P; p += CR) acc += pb[(long long)p * L];
  }
  part[ry][cx] = acc;
  __syncthreads();
  if (ry == 0 && gc < C) {
    float total = 0.f;
    for (int r = 0; r < CR; ++r) total += part[r][cx];
    asum[(long long)b * C + gc] = total;
  }
}

bool rows_aligned16(const void* p, int cols) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && cols % 8 == 0;
}

// Byte offsets of the scratch regions in the caller's workspace.
struct Workspace {
  size_t scores, ahi, alo, part, total;
};

Workspace workspace_layout(int dtype, int B, int P, int C, int D) {
  auto up = [](size_t x) { return (x + 255) / 256 * 256; };
  const size_t L = scratch_ld(dtype, C);
  Workspace w{};
  size_t o = 0;
  w.scores = o;
  o += up((size_t)B * P * L * 4);
  if (dtype == kBFloat16) {
    w.ahi = o;
    o += up((size_t)B * P * L * 2);
    w.alo = o;
    o += up((size_t)B * P * L * 2);
    w.part = o;
    o += up((size_t)B * NSPLIT * P * D * 4);
  }
  w.total = o;
  return w;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
}  // namespace spann3r

// Bytes of device scratch that spann3r_memory_read needs for these shapes.
extern "C" long long spann3r_memory_read_workspace(int dtype, int B, int P,
                                                   int C, int D) {
  return (long long)spann3r::workspace_layout(dtype, B, P, C, D).total;
}

// q: contiguous (B, P, D); k, v: contiguous (B, C, D), all of one dtype;
// size: B int32 in device memory; out: contiguous (B, P, D) in q's dtype;
// asum: (B, C) fp32; workspace: spann3r_memory_read_workspace bytes,
// 256-byte aligned.
extern "C" int spann3r_memory_read(const void* q, const void* k,
                                   const void* v, const void* size, void* out,
                                   void* asum, void* workspace, int dtype,
                                   int B, int P, int C, int D, float scale,
                                   float attn_thresh, void* stream) {
  using namespace spann3r;
  const int L = scratch_ld(dtype, C);
  const size_t wsmem = (size_t)L * sizeof(float);
  if (B < 1 || P < 1 || C < 1 || D < 1 || B * NSPLIT > 65535 ||
      (P + 63) / 64 > 65535 || wsmem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (dtype != kFloat32 && dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sz = static_cast<const int*>(size);
  const Workspace w = workspace_layout(dtype, B, P, C, D);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  float* S = reinterpret_cast<float*>(ws + w.scores);
  cudaError_t err = allow_smem((const void*)weights_kernel, wsmem);
  if (err != cudaSuccess) return (int)err;

  if (dtype == kFloat32) {   // L == C
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    const long long pc = (long long)P * C, pd = (long long)P * D,
                    cd = (long long)C * D;
    for (int b = 0; b < B; ++b)
      scores_f32_kernel<<<dim3((C + ST - 1) / ST, (P + ST - 1) / ST), NT, 0,
                          s>>>(qf + b * pd, kf + b * cd, sz + b, S + b * pc, P,
                               C, D, scale);
    weights_kernel<<<dim3(P, B), NT, wsmem, s>>>(S, nullptr, nullptr, sz, P, C,
                                                 L, attn_thresh);
    for (int b = 0; b < B; ++b)
      readout_f32_kernel<<<dim3((D + RT - 1) / RT, (P + RT - 1) / RT), NT, 0,
                           s>>>(S + b * pc, vf + b * cd, sz + b, of + b * pd, P,
                                C, D);
  } else {
    bf16* ahi = reinterpret_cast<bf16*>(ws + w.ahi);
    bf16* alo = reinterpret_cast<bf16*>(ws + w.alo);
    float* part = reinterpret_cast<float*>(ws + w.part);
    if ((err = allow_smem((const void*)scores_wgmma_kernel,
                          scores_smem_bytes())) != cudaSuccess ||
        (err = allow_smem((const void*)readout_wgmma_kernel,
                          readout_smem_bytes())) != cudaSuccess)
      return (int)err;
    scores_wgmma_kernel<<<dim3(L / SN, (P + 63) / 64, B), 128,
                          scores_smem_bytes(), s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), sz, S, P, C,
        D, L, scale, rows_aligned16(q, D) && rows_aligned16(k, D));
    weights_kernel<<<dim3(P, B), NT, wsmem, s>>>(S, ahi, alo, sz, P, C, L,
                                                 attn_thresh);
    readout_wgmma_kernel<<<dim3((D + 127) / 128, (P + 63) / 64, B * NSPLIT),
                           128, readout_smem_bytes(), s>>>(
        ahi, alo, static_cast<const bf16*>(v), sz, part, P, C, D, L,
        rows_aligned16(v, D));
    const long long pd = (long long)P * D;
    finish_out_kernel<<<dim3((unsigned)((pd + NT - 1) / NT), B), NT, 0, s>>>(
        part, sz, static_cast<bf16*>(out), P, C, D);
  }
  colsum_kernel<<<dim3((C + CC - 1) / CC, B), NT, 0, s>>>(
      S, sz, static_cast<float*>(asum), P, C, L);
  return (int)cudaGetLastError();
}
