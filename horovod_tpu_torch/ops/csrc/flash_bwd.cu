// Flash-attention backward for Hopper (sm_90a), f32 math on bf16 or f32 inputs.
//
// Replaces four Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//
//   flash_bwd_dq   <- _bwd_dq_kernel    (_flash_bwd_impl)  dQ = scale * sum_j dS_ij K_j
//   flash_bwd_dkv  <- _bwd_dkv_kernel   (_flash_bwd_impl)  dV = sum_i P_ij^T dO_i,
//                                                          dK = sum_i dS_ij^T (Q_i * scale)
//   flash_band_dq  <- _band_dq_kernel   (_band_tile_bwd)   the same, for a band tile
//   flash_band_dkv <- _band_dkv_kernel  (_band_tile_bwd)
//
// A band tile is ring attention's tile of a visiting K/V shard: its query rows
// sit `off` global positions after the K/V origin (query row i at position
// off + i for the causal and window masks), and lse and delta are the ring's
// global ones. The static kernels are the band kernels at off = 0: both run
// the same tile loops, the TPU's SMEM scalar becoming an int argument. The
// static kernels write gradients in the input type; the band kernels write
// f32, as _band_tile_bwd does, since the ring sums them across tiles.
//
// with, for every live (query i, key j) pair,
//
//     s  = (q * scale) . k^T        in f32, scale = 1/sqrt(D)
//     s  = -1e30 where masked        (causal, sliding window, ragged edge)
//     p  = exp(s - lse)              lse saved by the forward
//     dp = dO . v^T
//     dS = p * (dp - delta)          delta = rowsum(dO * O) - g_lse, computed
//                                    outside the kernel as on the TPU
//
// in the reference's order of operations: q is converted to f32 and scaled
// before the product, masked scores are -1e30 (so p is exactly 0 there), dQ is
// accumulated from unscaled K and scaled once at the end, and dK is accumulated
// from the scaled q.
//
// Layout: q and dO (B, S, H, D), k/v (B, S, H_kv, D) with the head dim
// contiguous and any strides on B, S and H; lse and delta (B, H, S) contiguous
// f32; dq (B, S, H, D) and dk/dv (B, S, H_kv, D) contiguous in the input type.
//
// Design. The TPU kernels carry their accumulators in VMEM scratch across a
// sequential inner grid axis. Blocks on Hopper run in no order, so each kernel
// owns its output tile and loops over the other side itself; nothing crosses
// blocks, there are no atomics, and every run gives the same bits.
//
// - flash_bwd_dq: one CTA per (b*h, 64-row q tile). It holds the tile's scaled
//   q, dO, lse and delta in shared memory and loops over 64-row kv tiles, with
//   the causal and window skips (for a band tile, _band_live at the tile's
//   offset) as the loop's bounds. The highest q tiles
//   launch first: under a causal mask they have the most kv tiles.
// - flash_bwd_dkv: one CTA per (b*h_kv, 64-row k tile). It holds K and V and
//   loops over the `group` query heads that share the kv head and, inside
//   that, over the live q tiles. dK and dV accumulate in f32 registers across
//   the whole group, so the GQA group sum that the TPU path runs outside the
//   kernel over f32 per-q-head partials (:688-692 and :797-801) happens here,
//   and the partial buffers do not exist. The lowest k tiles launch first: under a
//   causal mask they have the most q tiles.
//
// Ragged lengths are masked per element: a key at or past S gets -1e30, a
// query row at or past S is read as zeros, masked, and never written. So the
// card needs neither the reference's pad-to-128 backward nor its dense VJP.
//
// 256 threads; each owns 2 rows x 8 columns of a 64 x 64 score tile (the row
// sums reduce nowhere: every product here contracts over D or over the tile)
// and 2 rows x D/8 columns of each accumulator. Tiles are staged in shared
// memory as f32 with padded row strides (D + 1, 64 + 1), so the inner loops
// read without bank conflicts. At D = 128 the dq CTA takes 145 KB of shared
// memory and the dkv CTA 162 KB, one CTA per SM.
//
// Bound on this card (H100 SXM): 6*D FLOPs per live pair for dq (s, dp, dS.K)
// and 8*D for dkv (s, dp, P^T.dO, dS^T.Q), against 989 TFLOP/s bf16. At the
// training shape (B 4, S 4096, H 16, H_kv 4, D 128, bf16, causal) that is
// 412 GFLOP (0.42 ms) and 550 GFLOP (0.56 ms); each moves about 0.24 GB
// (0.07 ms at 3.35 TB/s), so operations bound both, and the band kernels at
// the ring's shapes too. A band tile's row that is dead in the tile gets
// p = exp(-1e30 - lse) = 0 from the finite global lse, so it adds nothing.
// This first design is for
// correctness: the products run on the CUDA cores in f32, not on the tensor
// cores. wgmma, TMA and warp specialisation come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // key rows per tile
constexpr int THREADS = 256;
constexpr int TX = 8;                // threads across one tile row
constexpr int TY = THREADS / TX;     // 32 row groups
constexpr int RPT = BQ / TY;         // tile rows per thread: 2
constexpr int CPT = BK / TX;         // score columns per thread: 8
constexpr int LDS = BK + 1;          // row stride of a 64 x 64 score tile
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the dkv kernel transposes the score tile");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + 64) of one head, converted to f32 and multiplied by `mul`,
// into a 64 x DMAX shared tile of row stride DMAX + 1. Rows at or past S and
// columns at or past D read as zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0, int S,
                                          int D, float mul) {
  for (int i = threadIdx.x; i < 64 * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (r0 + r < S && d < D) x = to_f32(src[(r0 + r) * row_stride + d]) * mul;
    dst[r * (DMAX + 1) + d] = x;
  }
}

// lse and delta of rows [r0, r0 + 64) of one (b, h) row of the (B, H, S)
// vectors; rows at or past S read as zero (they are masked everywhere).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          long long base, int r0, int S) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool ok = r0 + r < S;
    lse_s[r] = ok ? lse[base + r0 + r] : 0.f;
    delta_s[r] = ok ? delta[base + r0 + r] : 0.f;
  }
}

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

template <int DMAX>
__host__ __device__ constexpr int dq_smem_floats() {
  return 2 * BQ * (DMAX + 1) + 2 * BK * (DMAX + 1) + BQ * LDS;
}
template <int DMAX>
__host__ __device__ constexpr int dkv_smem_floats() {
  return 2 * BK * (DMAX + 1) + 2 * BQ * (DMAX + 1) + 2 * BK * LDS;
}

template <typename T, typename TO, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dq, int S, int H,
    int group, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int causal, int window, int off) {
  constexpr int LD = DMAX + 1;
  constexpr int OCPT = DMAX / TX;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // q * scale
  float* dos = qs + BQ * LD;         // dO
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dst = vs + BK * LD;         // dS tile, BQ x LDS
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  load_tile<T, DMAX>(qs, q + b * qsb + h * qsh, qss, q0, S, D, scale);
  load_tile<T, DMAX>(dos, dout + b * dsb + h * dsh, dss, q0, S, D, 1.f);
  load_rows(lse_s, delta_s, lse, delta, static_cast<long long>(bh) * S, q0, S);

  float acc[RPT][OCPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < OCPT; ++c) acc[i][c] = 0.f;

  // kv rows [kv_lo, kv_hi) can be live for some row of this q tile, whose
  // rows sit at positions off + q0 .. off + q0 + BQ - 1.
  int kv_lo = 0, kv_hi = S;
  if (causal) {
    kv_hi = max(0, min(S, off + q0 + BQ));
    if (window > 0) kv_lo = max(0, off + q0 - window + 1);
  }
  const int t_hi = (kv_hi + BK - 1) / BK;

  for (int t = kv_lo / BK; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of ks and dst are done
    load_tile<T, DMAX>(ks, kb, kss, k0, S, D, 1.f);
    load_tile<T, DMAX>(vs, vb, vss, k0, S, D, 1.f);
    __syncthreads();

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = qs[(ty + TY * i) * LD + d];
        ov[i] = dos[(ty + TY * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = ks[(tx + TX * j) * LD + d];
        vv[j] = vs[(tx + TX * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tx + TX * j;
        const float sv =
            live(q0 + r, k0 + c, S, off, causal, window) ? s[i][j] : NEG_INF;
        const float p = expf(sv - lse_s[r]);
        dst[r * LDS + c] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RPT], kv[OCPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dst[(ty + TY * i) * LDS + kk];
#pragma unroll
      for (int c = 0; c < OCPT; ++c) kv[c] = ks[kk * LD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < OCPT; ++c) acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qp = q0 + ty + TY * i;
    if (qp >= S) continue;
    TO* row = dq + ((static_cast<long long>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int c = 0; c < OCPT; ++c) {
      const int d = tx + TX * c;
      if (d < D) store(row + d, acc[i][c] * scale);
    }
  }
}

template <typename T, typename TO, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv,
    int S, int H, int group, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss, long long dsh,
    float scale, int causal, int window, int off) {
  constexpr int LD = DMAX + 1;
  constexpr int OCPT = DMAX / TX;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;          // q * scale
  float* dos = qs + BQ * LD;
  float* pt = dos + BQ * LD;         // P^T tile, BK x LDS
  float* dst = pt + BK * LDS;        // dS^T tile, BK x LDS
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int h_kv = H / group;
  const int b = blockIdx.x / h_kv;
  const int hk = blockIdx.x % h_kv;
  const int k0 = blockIdx.y * BK;

  load_tile<T, DMAX>(ks, k + b * ksb + hk * ksh, kss, k0, S, D, 1.f);
  load_tile<T, DMAX>(vs, v + b * vsb + hk * vsh, vss, k0, S, D, 1.f);

  float acc_k[RPT][OCPT], acc_v[RPT][OCPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < OCPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // q tiles [t_lo, t_hi) hold a query that can see some key of this tile:
  // query row i (position off + i) sees key k0 from i = k0 - off on, and,
  // under a window, key k0 + BK - 1 up to i = k0 + BK - 2 + window - off.
  int t_lo = 0, t_hi = (S + BQ - 1) / BQ;
  if (causal) {
    t_lo = max(0, k0 - off) / BQ;
    if (window > 0) {
      const int last = k0 + BK - 2 + window - off;
      t_hi = last < 0 ? 0 : min(t_hi, last / BQ + 1);
    }
  }

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qsb + h * qsh;
    const T* ob = dout + b * dsb + h * dsh;
    const long long base = (static_cast<long long>(b) * H + h) * S;
    for (int t = t_lo; t < t_hi; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's reads of qs, dos, pt, dst are done
      load_tile<T, DMAX>(qs, qb, qss, q0, S, D, scale);
      load_tile<T, DMAX>(dos, ob, dss, q0, S, D, 1.f);
      load_rows(lse_s, delta_s, lse, delta, base, q0, S);
      __syncthreads();

      // Transposed score tile: rows are keys, columns are queries.
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = ks[(ty + TY * i) * LD + d];
          vv[i] = vs[(ty + TY * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = qs[(tx + TX * j) * LD + d];
          ov[j] = dos[(tx + TX * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
            dp[i][j] = fmaf(ov[j], vv[i], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TY * i;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = tx + TX * j;
          const float sv =
              live(q0 + c, k0 + r, S, off, causal, window) ? s[i][j] : NEG_INF;
          const float p = expf(sv - lse_s[c]);
          pt[r * LDS + c] = p;
          dst[r * LDS + c] = p * (dp[i][j] - delta_s[c]);
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RPT], dsv[RPT], ov[OCPT], qv[OCPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = pt[(ty + TY * i) * LDS + qq];
          dsv[i] = dst[(ty + TY * i) * LDS + qq];
        }
#pragma unroll
        for (int c = 0; c < OCPT; ++c) {
          ov[c] = dos[qq * LD + tx + TX * c];
          qv[c] = qs[qq * LD + tx + TX * c];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < OCPT; ++c) {
            acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kp = k0 + ty + TY * i;
    if (kp >= S) continue;
    const long long at = ((static_cast<long long>(b) * S + kp) * h_kv + hk) * D;
#pragma unroll
    for (int c = 0; c < OCPT; ++c) {
      const int d = tx + TX * c;
      if (d < D) {
        store(dk + at + d, acc_k[i][c]);
        store(dv + at + d, acc_v[i][c]);
      }
    }
  }
}

// Arguments shared by both kernels, as the C interface receives them.
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int B, S, H, Hkv, D;
  long long st[12];   // (batch, sequence, head) strides of q, k, v, dO
  float scale;
  int causal, window, off;
};

template <typename T, typename TO, int DMAX>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dq_kernel<T, TO, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(a.out0), a.S, a.H, a.H / a.Hkv, a.D, a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8], a.st[9],
      a.st[10], a.st[11], a.scale, a.causal, a.window, a.off);
  return cudaGetLastError();
}

template <typename T, typename TO, int DMAX>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dkv_kernel<T, TO, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.S + BK - 1) / BK);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(a.out0), static_cast<TO*>(a.out1), a.S, a.H,
      a.H / a.Hkv, a.D, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11], a.scale,
      a.causal, a.window, a.off);
  return cudaGetLastError();
}

template <typename T, typename TO, bool DQ>
cudaError_t dispatch_d(const Args& a, cudaStream_t s) {
  if (a.D <= 32)
    return DQ ? launch_dq<T, TO, 32>(a, s) : launch_dkv<T, TO, 32>(a, s);
  if (a.D <= 64)
    return DQ ? launch_dq<T, TO, 64>(a, s) : launch_dkv<T, TO, 64>(a, s);
  return DQ ? launch_dq<T, TO, 128>(a, s) : launch_dkv<T, TO, 128>(a, s);
}

// f32_out: gradients in f32 (the band kernels) rather than the input type.
template <bool DQ>
int run(const Args& a, int dtype, bool f32_out, void* stream) {
  if (a.D < 1 || a.D > 128 || a.Hkv < 1 || a.H % a.Hkv != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_d<float, float, DQ>(a, s);
  else if (f32_out)
    err = dispatch_d<__nv_bfloat16, float, DQ>(a, s);
  else
    err = dispatch_d<__nv_bfloat16, __nv_bfloat16, DQ>(a, s);
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides are
// in elements, (batch, sequence, head) for each of q, k, v and dO. window <= 0
// means no window. Each returns the cudaError_t of its launch (0 = success).
extern "C" int hvd_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int causal, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, causal, window, 0};
  return run<true>(a, dtype, false, stream);
}

extern "C" int hvd_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int S, int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int causal, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, causal, window, 0};
  return run<false>(a, dtype, false, stream);
}

// The band tiles: causal at offset `off` (query row i at position off + i),
// gradients in f32. dk and dv are summed over each GQA group.
extern "C" int hvd_flash_band_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int off, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, 1, window, off};
  return run<true>(a, dtype, true, stream);
}

extern "C" int hvd_flash_band_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int S, int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int off, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, 1, window, off};
  return run<false>(a, dtype, true, stream);
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
