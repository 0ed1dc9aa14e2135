// Hopper (sm_90a) machinery shared by the tensor-core kernels of
// flash_fwd.cu and flash_bwd.cu: TMA loads into shared memory counted on
// mbarriers, the wgmma descriptors of 128-byte-swizzled tiles, the wgmma
// products themselves, the per-element mask, the tile-skip bounds and the
// launch order, and the host side's tensor maps. One copy: both sources
// include it, and ops/_build.py hashes it with each source, so an edit here
// rebuilds both.
//
// Tiles: a tile of R rows and D columns (bf16) sits in shared memory as
// D / 64 halves of R x 128 bytes, each as TMA writes a 64-column box with
// the 128-byte swizzle (8-row atoms of 1024 bytes). Kernels run 384
// threads: consumer warpgroups 0 and 1, and a producer warpgroup 2 of which
// one warp issues the loads.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// Query row qi (at position off + qi) and key kp of one (b, h) row.
__device__ __forceinline__ bool live(int qi, int kp, int S, int off,
                                     int causal, int window) {
  bool keep = qi < S && kp < S;
  if (causal) {
    const int qp = off + qi;
    keep = keep && qp >= kp;
    if (window > 0) keep = keep && qp - kp < window;
  }
  return keep;
}

namespace tc {

constexpr int BQ = 128;        // query rows a CTA, 64 per consumer warpgroup
constexpr int BT = 64;         // rows of a streamed tile and of a dkv key tile
constexpr int THREADS = 384;   // warpgroups 0 and 1 consume, 2 produces
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map at coordinates (d, head, row, batch) into
// shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d),
      "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// The wgmma descriptor of a 128-byte-swizzled operand: start address,
// leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// K-major operand (rows x K, K contiguous), k-step kk of 16 columns: the
// column half, then 32 bytes a step inside the swizzled 128-byte row.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int half_bytes,
                                            int kk) {
  return sw128(tile + (kk / 4) * half_bytes + (kk % 4) * 32, 16, 1024);
}

// MN-major operand (K rows x N, N contiguous), k-step kk of 16 rows: 2048
// bytes a step; the next 64 columns lie a half further on.
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int half_bytes,
                                             int kk) {
  return sw128(tile + kk * 2048, half_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep registers that wgmma reads or writes asynchronously in place until
// the wait that follows.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B in shared memory with
// K contiguous; accumulate 0 overwrites D.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B in shared memory
// with N contiguous (the transpose flag).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B in shared memory
// with N contiguous (the transpose flag).
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4],
                                       uint64_t b) {
  if constexpr (D == 128)
    mma_rs_n128(d, a, b);
  else
    mma_rs_n64(d, a, b);
}

// Accumulator fragment of m64nNk16 for thread `lane` of warp `warp` in its
// warpgroup: element e sits at row 16*warp + lane/4 + 8*((e/2) % 2) and
// column 8*(e/4) + 2*(lane%4) + e%2. Elements 8kk .. 8kk+7 of a 64-column
// fragment are, in this order, the A fragment of k-step kk (columns
// 16kk .. 16kk+15) of the next product, so P and dS never leave registers.

// [lo, hi) of the BT-row key tiles that query rows [r0, r0 + n) ∩ [0, S) of
// a tile at offset `off` can see; lo == hi when they see none.
__host__ __device__ inline void key_tiles(int r0, int n, int S, int off,
                                          int causal, int window, int& lo,
                                          int& hi) {
  const int end = r0 + n < S ? r0 + n : S;  // one past the last row
  int first = 0, stop = S;                  // keys [first, stop)
  if (causal) {
    stop = off + end < S ? off + end : S;
    if (window > 0 && off + r0 - window + 1 > 0) first = off + r0 - window + 1;
  }
  if (end <= r0 || stop <= first) {
    lo = hi = 0;
    return;
  }
  lo = first / BT;
  hi = (stop + BT - 1) / BT;
}

// [lo, hi) of the BT-row query tiles with a row that can see a key of the key
// tile [k0, k0 + BT) ∩ [0, S) of a tile at offset `off`; lo == hi when none.
__host__ __device__ inline void query_tiles(int k0, int S, int off, int causal,
                                            int window, int& lo, int& hi) {
  lo = 0;
  hi = (S + BT - 1) / BT;
  if (!causal) return;
  const int first = k0 > off ? k0 - off : 0;  // the first row that sees k0
  lo = first / BT;
  if (first >= S) {
    hi = lo;
  } else if (window > 0) {
    // the last row that sees the tile's last key
    const int top = (k0 + BT < S ? k0 + BT : S) - 1 + window - 1 - off;
    if (top < 0)
      hi = 0;
    else if (top / BT + 1 < hi)
      hi = top / BT + 1;
  }
  if (hi < lo) hi = lo;
}

// Whether a grid of n tiles should launch its last tile first: the end with
// more tiles to visit goes first (the last query tiles and the first key
// tiles under a causal mask; the reverse for a band tile past its window).
inline int last_tile_first(bool dq, int n, int S, int off, int causal,
                           int window) {
  int lo0, hi0, lo1, hi1;
  if (dq) {
    key_tiles(0, BQ, S, off, causal, window, lo0, hi0);
    key_tiles((n - 1) * BQ, BQ, S, off, causal, window, lo1, hi1);
    return hi1 - lo1 >= hi0 - lo0;
  }
  query_tiles(0, S, off, causal, window, lo0, hi0);
  query_tiles((n - 1) * BT, S, off, causal, window, lo1, hi1);
  return hi1 - lo1 > hi0 - lo0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda.so.1: it is looked up in the copy
// the process has loaded (dlopen), so the build needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The tensor-core route's rule on its operands (ops/flash_attention.py,
// tensor_core_route): bf16 (dtype 1), D 64 or 128 (whole 64-column boxes),
// H a multiple of Hkv, 16-byte-aligned base pointers and (batch, sequence,
// head) strides that are positive multiples of 8 elements (TMA's 16 bytes).
// The entry points refuse anything else; nothing is rerouted.
inline bool route_takes(int dtype, int D, int H, int Hkv,
                        std::initializer_list<const void*> ptrs,
                        const long long* st, int n_st) {
  bool ok = dtype == 1 && (D == 64 || D == 128) && Hkv >= 1 && H % Hkv == 0;
  for (const void* p : ptrs) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (int i = 0; i < n_st; ++i) ok = ok && st[i] > 0 && st[i] % 8 == 0;
  return ok;
}

// The TMA map of a (B, S, heads, D) bf16 tensor with (batch, sequence, head)
// strides `st` in elements: boxes of 64 columns by `rows` rows of one
// (batch, head), 128-byte swizzle, zeros past the edges.
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads,
                int D, const long long* st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tc
}  // namespace
