// Flash-attention forward for Hopper (sm_90a), f32 math on bf16 or f32 inputs.
//
// Replaces horovod_tpu/ops/flash_attention.py:_fwd_kernel (the Pallas TPU
// kernel launched by _flash_fwd_impl). It computes, for every query row,
//
//     s   = (q * scale) . k^T            in f32, scale = 1/sqrt(D)
//     s   = -1e30 where masked            (causal, sliding window, ragged edge)
//     out = softmax(s) . v                (online: running max m, normalizer l)
//     lse = m + log(max(l, 1e-30))
//
// with the reference's order of operations: q is converted to f32 and scaled
// before the product, masked scores are filled with -1e30 (not -inf), and l is
// clamped at 1e-30 before the division and the log.
//
// Layout: q (B, S, H, D), k/v (B, S, H_kv, D) with the head dim contiguous and
// any strides on B, S and H; out (B, S, H, D) contiguous in the input type; lse
// (B, H, S) contiguous f32. Grouped-query attention reads kv head h / group and
// never expands K/V.
//
// Design. The TPU kernel carries (m, l, acc) across a sequential kv grid axis.
// Blocks on Hopper run in no order, so one CTA owns one (b*h, 64-row q tile)
// and loops over 64-row kv tiles itself. The causal and window tile skips of
// the TPU kernel become that loop's bounds; the in-tile masks and the ragged
// edge (S not a multiple of 64) are masked per element, so the card needs
// neither the reference's pad-to-128 path nor its dense fallback. Each kv tile
// is converted to f32 in shared memory; 128 threads each own 4 query rows x 8
// score columns of a tile and 4 rows x D/8 output columns, so the row max and
// row sum reduce over the 8 lanes of a row with shuffles. The P tile reuses the
// K tile's shared memory. Padded row strides (D + 1, 64 + 1) keep the
// shared-memory reads free of bank conflicts.
//
// Bound on this card (H100 SXM): causal FLOPs ~ 2*B*H*S^2*D against 989
// TFLOP/s bf16, bytes ~ (2*B*H*S*D + 2*B*H_kv*S*D) * dtype size (Q and O, K and
// V) against 3.35 TB/s. At the serving prefill shape (B 8, S 512, H 16, H_kv 4,
// D 128, bf16) the bytes bound is the larger one, 0.0126 ms against 0.0087 ms.
// This first design is for correctness: the products run on the CUDA cores in
// f32, not on the tensor cores. wgmma, TMA and warp specialisation come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;               // query rows per CTA
constexpr int BK = 64;               // kv rows per tile
constexpr int THREADS = 128;
constexpr int TX = 8;                // threads across one row
constexpr int TY = THREADS / TX;     // 16 row groups
constexpr int RPT = BQ / TY;         // query rows per thread: 4
constexpr int CPT = BK / TX;         // score columns per thread: 8
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory, in floats: the q tile, the k tile (then the p tile), the v tile.
template <int DMAX>
__host__ __device__ constexpr int kp_floats() {
  return BK * (DMAX + 1) > BQ * (BK + 1) ? BK * (DMAX + 1) : BQ * (BK + 1);
}
template <int DMAX>
__host__ __device__ constexpr int smem_floats() {
  return BQ * (DMAX + 1) + kp_floats<DMAX>() + BK * DMAX;
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int group, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, float scale,
    int causal, int window) {
  constexpr int LDQ = DMAX + 1;
  constexpr int LDK = DMAX + 1;
  constexpr int LDV = DMAX;
  constexpr int LDP = BK + 1;
  constexpr int OCPT = DMAX / TX;    // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kp = qs + BQ * LDQ;
  float* vs = kp + kp_floats<DMAX>();

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  // Highest q tiles first: under a causal mask they have the most kv tiles.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  for (int i = tid; i < BQ * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (q0 + r < S && d < D) x = to_f32(qb[(q0 + r) * qss + d]) * scale;
    qs[r * LDQ + d] = x;
  }

  float m[RPT], l[RPT], acc[RPT][OCPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OCPT; ++c) acc[i][c] = 0.f;
  }

  // kv rows [kv_lo, kv_hi) can be live for some row of this q tile.
  int kv_lo = 0, kv_hi = S;
  if (causal) {
    kv_hi = min(S, q0 + BQ);
    if (window > 0) kv_lo = max(0, q0 - window + 1);
  }
  const int t_hi = (kv_hi + BK - 1) / BK;

  for (int t = kv_lo / BK; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's p and v reads are done
    for (int i = tid; i < BK * DMAX; i += THREADS) {
      const int r = i / DMAX, d = i % DMAX;
      const bool ok = k0 + r < S && d < D;
      kp[r * LDK + d] = ok ? to_f32(kb[(k0 + r) * kss + d]) : 0.f;
      vs[r * LDV + d] = ok ? to_f32(vb[(k0 + r) * vss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + TY * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = kp[(tx + TX * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + ty + TY * i;
      float bm = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        bool keep = kpos < S;
        if (causal) {
          keep = keep && qp >= kpos;
          if (window > 0) keep = keep && qp - kpos < window;
        }
        if (!keep) s[i][j] = NEG_INF;
        bm = fmaxf(bm, s[i][j]);
      }
      const float nm = fmaxf(m[i], row_max8(bm));
      const float alpha = expf(m[i] - nm);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s[i][j] = expf(s[i][j] - nm);
        ps += s[i][j];
      }
      // l stays a per-thread partial over this thread's columns; the row
      // sum over the 8 lanes happens once, at the end.
      l[i] = l[i] * alpha + ps;
      m[i] = nm;
#pragma unroll
      for (int c = 0; c < OCPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the k tile
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) kp[(ty + TY * i) * LDP + tx + TX * j] = s[i][j];
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RPT], vv[OCPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = kp[(ty + TY * i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < OCPT; ++c) vv[c] = vs[kk * LDV + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < OCPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float lt = fmaxf(row_sum8(l[i]), 1e-30f);
    const int qp = q0 + ty + TY * i;
    if (qp < S) {
      T* orow = o + ((static_cast<long long>(b) * S + qp) * H + h) * D;
#pragma unroll
      for (int c = 0; c < OCPT; ++c) {
        const int d = tx + TX * c;
        if (d < D) store(orow + d, acc[i][c] / lt);
      }
      if (tx == 0) lse[(static_cast<long long>(b) * H + h) * S + qp] = m[i] + logf(lt);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int S, int H, int Hkv, int D, const long long* qst,
                   const long long* kst, const long long* vst, float scale,
                   int causal, int window, cudaStream_t stream) {
  constexpr int smem = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, H, H / Hkv, D, qst[0],
      qst[1], qst[2], kst[0], kst[1], kst[2], vst[0], vst[1], vst[2], scale,
      causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int S, int H, int Hkv, int D,
                       const long long* qst, const long long* kst,
                       const long long* vst, float scale, int causal, int window,
                       cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 32>(q, k, v, o, lse, B, S, H, Hkv, D, qst, kst, vst, scale,
                         causal, window, stream);
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, lse, B, S, H, Hkv, D, qst, kst, vst, scale,
                         causal, window, stream);
  return launch<T, 128>(q, k, v, o, lse, B, S, H, Hkv, D, qst, kst, vst, scale,
                        causal, window, stream);
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides are
// in elements, (batch, sequence, head) for each of q, k, v. window <= 0 means
// no window. Returns the cudaError_t of the launch (0 = success).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int dtype, int B, int S, int H, int Hkv,
                             int D, long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             float scale, int causal, int window, void* stream) {
  if (D < 1 || D > 128 || Hkv < 1 || H % Hkv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qst[3] = {qsb, qss, qsh};
  const long long kst[3] = {ksb, kss, ksh};
  const long long vst[3] = {vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch_d<float>(q, k, v, o, lse, B, S, H, Hkv, D, qst, kst,
                                     vst, scale, causal, window, s)
                 : dispatch_d<__nv_bfloat16>(q, k, v, o, lse, B, S, H, Hkv, D, qst,
                                             kst, vst, scale, causal, window, s);
  return static_cast<int>(err);
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
