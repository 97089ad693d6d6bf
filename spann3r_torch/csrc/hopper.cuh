// Hopper (sm_90a) building blocks shared by the tensor-core kernels:
// 16-byte cp.async into a 128-byte-swizzled shared-memory tile (and 4-byte
// cp.async for per-row statistics), wgmma
// shared-memory descriptors, the m64n64k16 bf16 wgmma (A from shared memory
// or from registers), and named barriers for one warpgroup.
//
// Tile layout: a 64 x 64 bf16 tile is 64 rows of 128 bytes; the 16-byte
// chunk c of row r is stored at chunk c ^ (r % 8) of that row (the layout
// TMA writes for CU_TENSOR_MAP_SWIZZLE_128B). Tiles start on a 1024-byte
// boundary, so the swizzle the tensor cores apply to the address agrees
// with the one the stores applied. The same tile serves as a K-major
// operand (rows are M or N, the 64 columns are K) and as an MN-major one
// (rows are K, columns N), for which wgmma transposes it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace spann3r {
namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;
constexpr int kTileBytes = kTileRows * 128;   // 64 x 64 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (swizzled tiles start there;
// the dynamic shared memory holding them has 1024 bytes of slack)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// byte offset of element (r, c) in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1);
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) made visible
// to the tensor cores' (async-proxy) reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + 64) x columns [col0, col0 + 64) of a bf16 matrix with
// row stride `ld` (elements, unit stride along the row) into a swizzled
// tile, with `tpb` threads (thread t of [0, tpb)); rows at or past `limit`
// and columns at or past `cols` are zero. `vec`: the rows are 16-byte
// aligned and `cols` is a multiple of 8 (cp.async); otherwise element loads
// and stores.
__device__ __forceinline__ void load_tile(unsigned char* tile, const bf16* src,
                                          long long ld, int row0, int limit,
                                          bool vec, int t, int tpb,
                                          int col0 = 0, int cols = 64) {
  if (vec) {
    for (int e = t; e < kTileRows * 8; e += tpb) {
      const int r = e >> 3, c = e & 7;
      const bool ok = row0 + r < limit && col0 + c * 8 < cols;
      const bf16* g = ok ? src + (long long)(row0 + r) * ld + col0 + c * 8 : src;
      cp_async16(tile + r * 128 + ((c ^ (r & 7)) << 4), g, ok);
    }
    return;
  }
  for (int e = t; e < kTileRows * 64; e += tpb) {
    const int r = e >> 6, c = e & 63;
    const bf16 x = row0 + r < limit && col0 + c < cols
                       ? src[(long long)(row0 + r) * ld + col0 + c]
                       : __float2bfloat16_rn(0.f);
    *reinterpret_cast<bf16*>(tile + swz(r, c)) = x;
  }
}

// wgmma shared-memory descriptor of a swizzled tile, `byte_off` bytes into
// it (a K step of 16 elements is +32 bytes for a K-major operand, +2048 for
// an MN-major one). Both strides are 1024 bytes, the distance between
// 8-row groups; for the 64-wide tiles here the other stride of either
// major-ness is never used.
__device__ __forceinline__ uint64_t desc(const unsigned char* tile,
                                         int byte_off) {
  const uint32_t a = smem_addr(tile) + byte_off;
  uint64_t d = (uint64_t)((a & 0x3FFFF) >> 4);
  d |= (uint64_t)(1024 >> 4) << 16;   // leading byte offset
  d |= (uint64_t)(1024 >> 4) << 32;   // stride byte offset
  d |= (uint64_t)1 << 62;             // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across wgmma calls
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments in registers: keeps a fragment that an
// in-flight wgmma reads alive (and unmoved) until after the wait
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define SPANN3R_D32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

// d (64 x 64 fp32, in registers) = [d +] A B, A 64 x 16 K-major from shared
// memory, B 16 x 64 from shared memory (K-major unless TRANS_B)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : SPANN3R_D32
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// the same with A from registers: a[0..3] hold the 64 x 16 bf16 fragment
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : SPANN3R_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

#undef SPANN3R_D32

// Accumulator layout of an m64nN wgmma: thread t of the warpgroup holds
// d[i] at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ int acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace hopper
}  // namespace spann3r
