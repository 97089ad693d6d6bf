// 2D rotary position embedding (RoPE2D), forward and inverse.
//
// Replaces the TPU kernel spann3r_tpu/ops/pallas_rope.py:_rope_kernel
// (launched by _rope_pallas_raw). Head dim D is split into quarters
// [u_Y | v_Y | u_X | v_X] of Q = D/4; for the Y pair with angle
// a = pos_y * base^(-i/Q) (and likewise X with pos_x):
//     u' = u cos(a) - sign * v sin(a)
//     v' = v cos(a) + sign * u sin(a)
// sign = -1 applies the inverse rotation (the backward pass).
//
// What bounds it on the card: memory. Each element is read and written
// once (2 x 2 bytes in bf16) against ~6 flops, far below the ~295 flop/byte
// the H100 needs before compute matters. The design therefore keeps the
// traffic at one read and one write: one thread per (token, frequency
// index i) rotates both of its pairs, builds inv_freq and the angles in
// fp32 in registers (no cos/sin table in memory), and reads the input
// through its strides, so the strided q/k views that come out of the qkv
// split are consumed without a copy. The output is written contiguous.
// Accurate sinf/cosf (no fast math): positions reach ~64 radians, where
// the __sinf/__cosf intrinsics lose digits.

#include "common.cuh"

namespace spann3r {
namespace {

template <typename T>
__global__ void rope2d_kernel(const T* __restrict__ x, T* __restrict__ out,
                              const int* __restrict__ pos, int B, int H,
                              int N, int D, long long sb, long long sh,
                              long long sn, float base, float sign) {
  const int Q = D / 4;
  const long long total = (long long)B * H * N * Q;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int i = (int)(t % Q);
  const long long tok = t / Q;  // (b, h, n) flattened
  const int n = (int)(tok % N);
  const int h = (int)((tok / N) % H);
  const int b = (int)(tok / ((long long)N * H));

  const float inv_freq = 1.0f / powf(base, (float)i / (float)Q);
  const float ang_y = (float)pos[((long long)b * N + n) * 2 + 0] * inv_freq;
  const float ang_x = (float)pos[((long long)b * N + n) * 2 + 1] * inv_freq;
  const float cy = cosf(ang_y), sy = sinf(ang_y) * sign;
  const float cx = cosf(ang_x), sx = sinf(ang_x) * sign;

  const T* src = x + b * sb + h * sh + n * sn;
  T* dst = out + tok * D;
  const float uy = to_f(src[i]), vy = to_f(src[Q + i]);
  const float ux = to_f(src[2 * Q + i]), vx = to_f(src[3 * Q + i]);
  dst[i] = from_f<T>(uy * cy - vy * sy);
  dst[Q + i] = from_f<T>(vy * cy + uy * sy);
  dst[2 * Q + i] = from_f<T>(ux * cx - vx * sx);
  dst[3 * Q + i] = from_f<T>(vx * cx + ux * sx);
}

template <typename T>
void launch(const void* x, void* out, const void* pos, int B, int H, int N,
            int D, long long sb, long long sh, long long sn, float base,
            float sign, cudaStream_t stream) {
  const long long total = (long long)B * H * N * (D / 4);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  rope2d_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const int*>(pos), B, H, N, D, sb, sh, sn, base, sign);
}

}  // namespace
}  // namespace spann3r

// x: (B, H, N, D) with element strides sb, sh, sn and unit stride in D;
// out: contiguous (B, H, N, D); pos: contiguous (B, N, 2) int32 (y, x).
extern "C" int spann3r_rope2d(const void* x, void* out, const void* pos,
                              int dtype, int B, int H, int N, int D,
                              long long sb, long long sh, long long sn,
                              float base, float sign, void* stream) {
  using namespace spann3r;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || B * H * N == 0) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    launch<float>(x, out, pos, B, H, N, D, sb, sh, sn, base, sign, s);
  } else if (dtype == kBFloat16) {
    launch<__nv_bfloat16>(x, out, pos, B, H, N, D, sb, sh, sn, base, sign, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
