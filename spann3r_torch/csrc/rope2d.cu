// 2D rotary position embedding (RoPE2D), forward and inverse, on the q and
// k of one attention in one launch.
//
// Replaces the TPU kernel spann3r_tpu/ops/pallas_rope.py:_rope_kernel
// (launched by _rope_pallas_raw). Head dim D is split into quarters
// [u_Y | v_Y | u_X | v_X] of Q = D/4; for the Y pair with angle
// a = pos_y * base^(-i/Q) (and likewise X with pos_x):
//     u' = u cos(a) - sign * v sin(a)
//     v' = v cos(a) + sign * u sin(a)
// sign = -1 applies the inverse rotation (the backward pass). The angles
// and the rotation are fp32; the result is rounded once to the output type.
//
// What bounds it on the card: memory. Each element is read and written
// once (2 x 2 bytes in bf16) against ~6 flops, far below the ~295 flop/byte
// the H100 needs before compute matters; at the decoder's shape (2 x 1.2 MB)
// the fixed cost of a launch is of the order of the bound as well. So:
//  - one launch rotates up to two operands (the q and k of one attention),
//    each with its own pointer, strides, positions and token count. The
//    positions are read through their strides (a batch stride of 0, the
//    model's expanded patch grid, is read in place);
//  - a block owns a tile of tokens of one batch item. Operands that share
//    their positions (self-attention) share the block; others have blocks
//    of their own (grid z). The block computes the fp32 cos and sign * sin
//    of its tokens once into shared memory (1 / powf(base, i / Q), accurate
//    sinf / cosf: positions reach ~64 radians, where the __sinf / __cosf
//    intrinsics lose digits) and then streams every head of its operands
//    over those tokens, so the trig is done once per token, not once per
//    head and tensor;
//  - each unit of work is V consecutive frequencies of one pair of one
//    (operand, token, head) row: V elements of u and V of v, loaded and
//    stored as one vector each (16 bytes for V = 8 bf16 or 4 fp32; the
//    wrapper picks a narrower V where Q, a stride or a pointer does not
//    allow 16 bytes). A thread issues the loads of kUnroll units before it
//    uses any, and the first batch is loaded before the angles are
//    computed, so the trig runs under the load latency. Consecutive threads
//    take consecutive units (heads of one token next to each other, which
//    the q/k slices of a qkv projection keep contiguous);
//  - 32-bit index arithmetic; 64-bit only for the element offsets.
// The output is written to new tensors through their strides.

#include <cstdint>

#include "common.cuh"

namespace spann3r {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxOperands = 2;

struct Operand {
  const void* x;
  void* out;
  const int* pos;
  long long sb, sh, sn;  // element strides of x (B, H, N, D); unit in D
  long long ob, oh, on;  // of out
  long long pb, pn, pc;  // of pos (B, N, 2)
  int n_tokens;
};

struct Group {  // operands [first, first + count) share their positions
  int first, count;
};

struct Params {
  Operand op[kMaxOperands];
  Group group[kMaxOperands];
  int H, D, tile;
  float base, sign;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    rope2d_kernel(const __grid_constant__ Params p) {
  extern __shared__ float2 cs[];  // [token][axis][Q]: (cos, sign * sin)
  const Group& g = p.group[blockIdx.z];
  const Operand& lead = p.op[g.first];
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * p.tile;
  if (n0 >= lead.n_tokens) return;
  const int nt = min(p.tile, lead.n_tokens - n0);
  const int Q = p.D / 4;
  const int per_axis = Q / V;
  const int per_row = 2 * per_axis;
  const int units = g.count * nt * p.H * per_row;

  for (int u0 = 0; u0 < units; u0 += kThreads * kUnroll) {
    Pack<T, V> pu[kUnroll], pv[kUnroll];
    T* dst[kUnroll];
    int ci[kUnroll];
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const int u = u0 + s * kThreads + threadIdx.x;
      if (u < units) {
        // u = ((o * nt + t) * H + h) * per_row + j
        const int j = u % per_row;
        int r = u / per_row;
        const int h = r % p.H;
        r /= p.H;
        const int t = r % nt;
        const int o = r / nt;
        const Operand& op = p.op[g.first + o];
        const int n = n0 + t;
        const int axis = j / per_axis;
        const int f = (j - axis * per_axis) * V;
        const int off = axis * 2 * Q + f;
        const T* src = static_cast<const T*>(op.x) + b * op.sb + h * op.sh +
                       n * op.sn + off;
        pu[s] = *reinterpret_cast<const Pack<T, V>*>(src);
        pv[s] = *reinterpret_cast<const Pack<T, V>*>(src + Q);
        dst[s] = static_cast<T*>(op.out) + b * op.ob + h * op.oh + n * op.on +
                 off;
        ci[s] = (t * 2 + axis) * Q + f;
      }
    }
    if (u0 == 0) {  // uniform over the block
      for (int e = threadIdx.x; e < nt * 2 * Q; e += kThreads) {
        const int i = e % Q;
        const int axis = (e / Q) & 1;
        const int n = n0 + e / (2 * Q);
        const float inv_freq = 1.0f / powf(p.base, (float)i / (float)Q);
        const float a =
            (float)lead.pos[b * lead.pb + n * lead.pn + axis * lead.pc] *
            inv_freq;
        cs[e] = make_float2(cosf(a), sinf(a) * p.sign);
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      if (u0 + s * kThreads + (int)threadIdx.x < units) {
        Pack<T, V> ru, rv;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float2 a = cs[ci[s] + k];
          const float u = to_f(pu[s].v[k]), v = to_f(pv[s].v[k]);
          ru.v[k] = from_f<T>(u * a.x - v * a.y);
          rv.v[k] = from_f<T>(v * a.x + u * a.y);
        }
        *reinterpret_cast<Pack<T, V>*>(dst[s]) = ru;
        *reinterpret_cast<Pack<T, V>*>(dst[s] + Q) = rv;
      }
    }
  }
}

template <typename T, int V>
void launch(const Params& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = (size_t)p.tile * 2 * (p.D / 4) * sizeof(float2);
  rope2d_kernel<T, V><<<grid, kThreads, smem, stream>>>(p);
}

template <typename T>
int dispatch(int vec, const Params& p, dim3 grid, cudaStream_t s) {
  switch (vec) {
    case 1: launch<T, 1>(p, grid, s); break;
    case 2: launch<T, 2>(p, grid, s); break;
    case 4: launch<T, 4>(p, grid, s); break;
    case 8:  // 16 bytes of bf16; no 32-byte access for fp32
      if constexpr (sizeof(T) == 2) {
        launch<T, 8>(p, grid, s);
        break;
      }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* ptr, const long long* strides, int n, int bytes,
             int esize) {
  if (reinterpret_cast<uintptr_t>(ptr) % bytes) return false;
  for (int i = 0; i < n; ++i)
    if ((strides[i] * esize) % bytes) return false;
  return true;
}

}  // namespace
}  // namespace spann3r

// n_ops (1 or 2) operands sharing B, H, D and the dtype. Operand i takes
// ptrs[3i .. 3i+2] = x, out, pos; strides[9i .. 9i+8] = x (sb, sh, sn),
// out (ob, oh, on), pos (pb, pn, pc), in elements; n_tokens[i] = N.
// x: (B, H, N, D) with unit stride in D; out: (B, H, N, D) through its
// strides, unit stride in D; pos: (B, N, 2) int32 (y, x). vec: elements per
// vector access, dividing D / 4, with every x and out pointer and stride
// aligned to vec elements. shared: the two operands share their positions
// (the same pos pointer and strides, and the same N), so one block rotates
// both. tile: tokens per block.
extern "C" int spann3r_rope2d(int n_ops, void* const* ptrs,
                              const long long* strides, const int* n_tokens,
                              int shared, int dtype, int B, int H, int D,
                              int vec, int tile, float base, float sign,
                              void* stream) {
  using namespace spann3r;
  if (n_ops < 1 || n_ops > kMaxOperands || B < 1 || B > 65535 || H < 1 ||
      D < 4 || D % 4 != 0 || vec < 1 || (D / 4) % vec != 0 || tile < 1)
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == kFloat32 ? 4 : dtype == kBFloat16 ? 2 : 0;
  if (esize == 0) return (int)cudaErrorInvalidValue;
  // shared memory: 8 bytes for each (token, axis, frequency)
  tile = tile < 49152 / (4 * D) ? tile : 49152 / (4 * D);
  if (tile < 1) return (int)cudaErrorInvalidValue;
  Params p{};
  int max_n = 0;
  for (int i = 0; i < n_ops; ++i) {
    const long long* st = strides + 9 * i;
    Operand& op = p.op[i];
    op.x = ptrs[3 * i];
    op.out = ptrs[3 * i + 1];
    op.pos = static_cast<const int*>(ptrs[3 * i + 2]);
    op.sb = st[0]; op.sh = st[1]; op.sn = st[2];
    op.ob = st[3]; op.oh = st[4]; op.on = st[5];
    op.pb = st[6]; op.pn = st[7]; op.pc = st[8];
    op.n_tokens = n_tokens[i];
    if (op.n_tokens < 1 || !aligned(op.x, st, 3, vec * esize, esize) ||
        !aligned(op.out, st + 3, 3, vec * esize, esize))
      return (int)cudaErrorInvalidValue;
    max_n = op.n_tokens > max_n ? op.n_tokens : max_n;
  }
  int n_groups = n_ops;
  if (shared) {
    if (n_ops != 2 || p.op[0].pos != p.op[1].pos ||
        p.op[0].pb != p.op[1].pb || p.op[0].pn != p.op[1].pn ||
        p.op[0].pc != p.op[1].pc || p.op[0].n_tokens != p.op[1].n_tokens)
      return (int)cudaErrorInvalidValue;
    n_groups = 1;
    p.group[0] = {0, 2};
  } else {
    for (int i = 0; i < n_ops; ++i) p.group[i] = {i, 1};
  }
  p.H = H;
  p.D = D;
  p.tile = tile;
  p.base = base;
  p.sign = sign;
  const dim3 grid((max_n + tile - 1) / tile, B, n_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == kFloat32 ? dispatch<float>(vec, p, grid, s)
                           : dispatch<__nv_bfloat16>(vec, p, grid, s);
}
