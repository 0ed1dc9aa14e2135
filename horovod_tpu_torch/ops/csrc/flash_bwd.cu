// Flash-attention backward for Hopper (sm_90a) on bf16 or f32 inputs.
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
//     s  = q . k^T * scale          scale = 1/sqrt(D)
//     s  = -1e30 where masked        (causal, sliding window, ragged edge)
//     p  = exp(s - lse)              lse saved by the forward
//     dp = dO . v^T
//     dS = p * (dp - delta)          delta = rowsum(dO * O) - g_lse, computed
//                                    outside the kernel as on the TPU
//
// Two routes, chosen by the wrapper (ops/flash_attention.py,
// tensor_core_route) and checked again here:
//
// - The tensor-core route (the *_wgmma_kernel templates, entries
//   hvd_*_wgmma): bf16 inputs, D 64 or 128, 16-byte-aligned base pointers
//   and (batch, sequence, head) strides. The training and sequence-parallel
//   paths run it.
// - The CUDA-core loop (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): every
//   other shape, f32 inputs among them, whose products it keeps exact, as
//   the reference's f32 products are (TF32 stays off).
//
// Layout: q and dO (B, S, H, D), k/v (B, S, H_kv, D) with the head dim
// contiguous and any strides on B, S and H; lse and delta (B, H, S) contiguous
// f32; dq (B, S, H, D) and dk/dv (B, S, H_kv, D) contiguous.
//
// Both routes own their output tiles. The TPU kernels carry their
// accumulators in VMEM scratch across a sequential inner grid axis; blocks on
// Hopper run in no order, so each CTA loops over the other side itself.
// Nothing crosses blocks, there are no atomics, and every run gives the same
// bits. The loop's dq CTAs launch highest query tiles first and its dkv CTAs
// lowest key tiles first: under a causal mask those have the most tiles to
// visit. The tensor-core kernels launch whichever end of their grid has more,
// as the host works out per launch (a band tile past its window has the most
// at the other end). The
// skips are the loops' bounds (for a band tile, _band_live at the offset); the
// per-element mask live() covers the ragged edge, so the card needs neither the
// reference's pad-to-128 backward nor its dense VJP. dK and dV accumulate over
// the whole GQA group in the CTA, so the group sum that the TPU path runs
// outside the kernel over f32 per-q-head partials (:688-692 and :797-801)
// happens here, and the partial buffers do not exist.
//
// Bound on this card (H100 SXM): 6*D FLOPs per live pair for dq (s, dp, dS.K)
// and 8*D for dkv (s, dp, P^T.dO, dS^T.Q), against 989 TFLOP/s bf16. At the
// training shape (B 4, S 4096, H 16, H_kv 4, D 128, bf16, causal) that is
// 412 GFLOP (0.42 ms) and 550 GFLOP (0.56 ms); each moves about 0.24 GB
// (0.07 ms at 3.35 TB/s), so operations bound both, and the band kernels at
// the ring's shapes too. A band tile's row that is dead in the tile gets
// p = exp(-1e30 - lse) = 0 from the finite global lse, so it adds nothing.
//
// The tensor-core route (its TMA, mbarrier and wgmma machinery, the mask and
// the tile bounds in hopper.cuh, shared with flash_fwd.cu). 384 threads:
// consumer warpgroups 0 and 1 (240 registers each by setmaxnreg) and a
// producer warpgroup (24) of which one warp works. The producer streams tiles with TMA (4-D tensor maps over
// (D, heads, S, B), 64-column boxes, 128-byte swizzle, zeros past S) through
// a ring of shared-memory stages guarded by full/empty mbarriers; the
// consumers run wgmma (bf16 operands, f32 accumulators) on the tiles that
// have arrived.
//
// - flash_bwd_dq: one CTA per (b*h, 128-row query tile); each consumer
//   warpgroup owns 64 rows. Q and dO stay in shared memory; K and V stream in
//   64-row tiles through 3 stages. Per tile: S = Q.K^T and dP = dO.V^T
//   (m64n64k16, both operands in shared memory, K-major); p and dS in f32
//   registers; dS converted in registers to the bf16 A fragment of
//   dQ += dS.K (m64nDk16, K read MN-major through the transpose flag). dS
//   never touches shared memory. dQ takes the scale once at the end.
// - flash_bwd_dkv: one CTA per (b*h_kv, 64-row key tile); K and V stay in
//   shared memory. The producer streams (Q, dO, lse, delta) of the live query
//   tiles of all `group` query heads through 4 stages, alternating between
//   the two warpgroups. S^T = K.Q^T and dP^T = V.dO^T leave P^T and dS^T in
//   the accumulator layout with keys as rows; as bf16 register fragments they
//   feed dV += P^T.dO and dK += dS^T.Q (B MN-major). At the end warpgroup 1
//   hands its dK/dV to warpgroup 0 through shared memory, which adds them
//   (always in that order), scales dK and writes both.
//
// Rounding against the f32 reference: S and dP are sums of exact products of
// bf16 values in f32, as in the loop up to summation order; the scale
// multiplies q.k^T instead of q (about one f32 rounding); exp runs as exp2 of
// (s * scale - lse) * log2(e). P and dS are rounded to bf16 before the second
// products, as SDPA rounds them, each by at most 2^-8 of itself; so a
// gradient differs from the f32 plain version by at most 2^-8 of the same sum
// taken over absolute values (ops/flash_attention.py,
// bf16_rounding_bound), and from the plain version run with
// operand_dtype=torch.bfloat16 by summation order and rare one-ulp flips of
// those roundings.
//
// The loop: 256 threads; each owns 2 rows x 8 columns of a 64 x 64 score
// tile and 2 rows x D/8 columns of each accumulator, tiles staged in shared
// memory as f32 with padded row strides (D + 1, 64 + 1). It takes the
// reference's order of operations: q is converted to f32 and scaled before
// the product, dQ is accumulated from unscaled K and scaled once at the end,
// and dK is accumulated from the scaled q. At D = 128 the dq CTA takes 145 KB
// of shared memory and the dkv CTA 162 KB, one CTA per SM. Head dims up to 256
// take 32-row tiles (tile_rows), each thread then 1 row x 4 columns of a score
// tile: the dq CTA takes 133 KB and the dkv CTA 137 KB. A head dim above 256 is
// held in 256-column pieces: S and dP sum over the pieces of q, dO, k and v
// (loaded in turn, in column order, so every CTA of a tile gets the same
// bits), and grid.z gives each CTA one 256-column piece of dQ, or of dK and dV,
// whose operand piece it loads again after the scores; a CTA recomputes the
// scores once per output piece.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TX = 8;                // threads across one tile row
constexpr int TY = THREADS / TX;     // 32 row groups
constexpr float NEG_INF = -1e30f;

// Rows of the loop's query and key tiles (equal: the dkv kernel transposes
// the score tile) at head dims up to DMAX: 64, and 32 at DMAX 256, where four
// 64-row f32 tiles of 257 columns (257 KB) would not fit in a block's 227 KB.
template <int DMAX>
__host__ __device__ constexpr int tile_rows() {
  return DMAX > 128 ? 32 : 64;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [r0, r0 + tile_rows) of one head, converted to f32 and multiplied by
// `mul`, into a tile_rows x DMAX shared tile of row stride DMAX + 1. Rows at
// or past S and columns at or past D read as zero.
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int r0, int S,
                                          int D, float mul) {
  for (int i = threadIdx.x; i < tile_rows<DMAX>() * DMAX; i += THREADS) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (r0 + r < S && d < D) x = to_f32(src[(r0 + r) * row_stride + d]) * mul;
    dst[r * (DMAX + 1) + d] = x;
  }
}

// lse and delta of rows [r0, r0 + n) of one (b, h) row of the (B, H, S)
// vectors; rows at or past S read as zero (they are masked everywhere).
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse, const float* delta,
                                          long long base, int r0, int n,
                                          int S) {
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const bool ok = r0 + r < S;
    lse_s[r] = ok ? lse[base + r0 + r] : 0.f;
    delta_s[r] = ok ? delta[base + r0 + r] : 0.f;
  }
}

// Shared memory in floats: at DMAX 256 (32-row tiles) the dq CTA takes
// 135,808 bytes and the dkv CTA 140,032.
template <int DMAX>
__host__ __device__ constexpr int dq_smem_floats() {
  constexpr int n = tile_rows<DMAX>();
  return 4 * n * (DMAX + 1) + n * (n + 1);
}
template <int DMAX>
__host__ __device__ constexpr int dkv_smem_floats() {
  constexpr int n = tile_rows<DMAX>();
  return 4 * n * (DMAX + 1) + 2 * n * (n + 1);
}

// PIECES: the head dim may exceed DMAX (then DMAX is 256 and the pieces of
// the file comment run); without it the pieces fold away at compile time.
template <typename T, typename TO, int DMAX, bool PIECES>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dq, int S, int H,
    int group, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int causal, int window, int off) {
  constexpr int BQ = tile_rows<DMAX>(), BK = BQ;
  constexpr int RPT = BQ / TY;       // tile rows per thread: 2, or 1
  constexpr int CPT = BK / TX;       // score columns per thread: 8, or 4
  constexpr int LDS = BK + 1;        // row stride of a score tile
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
  const T* qb = q + b * qsb + h * qsh;
  const T* ob = dout + b * dsb + h * dsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  // Pieces of the score sums, and this CTA's dQ columns [c0, c0 + DMAX).
  const int n_dp = PIECES ? (D + DMAX - 1) / DMAX : 1;
  const int c0 = PIECES ? blockIdx.z * DMAX : 0;
  const int d_end = PIECES ? D : 1;  // the pieces' starts are below d_end

  if (n_dp == 1) {
    load_tile<T, DMAX>(qs, qb, qss, q0, S, D, scale);
    load_tile<T, DMAX>(dos, ob, dss, q0, S, D, 1.f);
  }
  load_rows(lse_s, delta_s, lse, delta, static_cast<long long>(bh) * S, q0, BQ,
            S);

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

    float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < d_end; d0 += DMAX) {
      if (d0 > 0) __syncthreads();  // the previous piece's reads are done
      if (n_dp > 1) {
        load_tile<T, DMAX>(qs, qb + d0, qss, q0, S, D - d0, scale);
        load_tile<T, DMAX>(dos, ob + d0, dss, q0, S, D - d0, 1.f);
      }
      load_tile<T, DMAX>(ks, kb + d0, kss, k0, S, D - d0, 1.f);
      load_tile<T, DMAX>(vs, vb + d0, vss, k0, S, D - d0, 1.f);
      __syncthreads();
      const int dw = PIECES ? min(DMAX, D - d0) : D;
      for (int d = 0; d < dw; ++d) {
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
    if (n_dp > 1) {  // the k columns of this CTA's dQ piece
      __syncthreads();
      load_tile<T, DMAX>(ks, kb + c0, kss, k0, S, D - c0, 1.f);
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
      const int d = c0 + tx + TX * c;
      if (d < D) store(row + d, acc[i][c] * scale);
    }
  }
}

template <typename T, typename TO, int DMAX, bool PIECES>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv,
    int S, int H, int group, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss, long long dsh,
    float scale, int causal, int window, int off) {
  constexpr int BQ = tile_rows<DMAX>(), BK = BQ;
  constexpr int RPT = BQ / TY;       // tile rows per thread: 2, or 1
  constexpr int CPT = BK / TX;       // score columns per thread: 8, or 4
  constexpr int LDS = BK + 1;        // row stride of a score tile
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
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  // Pieces of the score sums, and this CTA's dK/dV columns [c0, c0 + DMAX).
  const int n_dp = PIECES ? (D + DMAX - 1) / DMAX : 1;
  const int c0 = PIECES ? blockIdx.z * DMAX : 0;
  const int d_end = PIECES ? D : 1;  // the pieces' starts are below d_end

  if (n_dp == 1) {
    load_tile<T, DMAX>(ks, kb, kss, k0, S, D, 1.f);
    load_tile<T, DMAX>(vs, vb, vss, k0, S, D, 1.f);
  }

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
      load_rows(lse_s, delta_s, lse, delta, base, q0, BQ, S);

      // Transposed score tile: rows are keys, columns are queries.
      float s[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d0 = 0; d0 < d_end; d0 += DMAX) {
        if (d0 > 0) __syncthreads();  // the previous piece's reads are done
        if (n_dp > 1) {
          load_tile<T, DMAX>(ks, kb + d0, kss, k0, S, D - d0, 1.f);
          load_tile<T, DMAX>(vs, vb + d0, vss, k0, S, D - d0, 1.f);
        }
        load_tile<T, DMAX>(qs, qb + d0, qss, q0, S, D - d0, scale);
        load_tile<T, DMAX>(dos, ob + d0, dss, q0, S, D - d0, 1.f);
        __syncthreads();
        const int dw = PIECES ? min(DMAX, D - d0) : D;
        for (int d = 0; d < dw; ++d) {
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
      if (n_dp > 1) {  // the q and dO columns of this CTA's dK/dV piece
        __syncthreads();
        load_tile<T, DMAX>(qs, qb + c0, qss, q0, S, D - c0, scale);
        load_tile<T, DMAX>(dos, ob + c0, dss, q0, S, D - c0, 1.f);
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
      const int d = c0 + tx + TX * c;
      if (d < D) {
        store(dk + at + d, acc_k[i][c]);
        store(dv + at + d, acc_v[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route.

namespace tc {

constexpr int DQ_STAGES = 3;
constexpr int DKV_STAGES = 4;

// Shared memory in bytes from a 1024-byte-aligned base. A tile of R rows and
// D columns is D / 64 halves of R x 128 bytes, each as TMA writes a 64-column
// box with the 128-byte swizzle (8-row atoms of 1024 bytes).
template <int D>
struct DqSmem {
  static constexpr int HQ = BQ * 128;        // a half of the q or dO tile
  static constexpr int HK = BT * 128;        // a half of a k or v tile
  static constexpr int TQ = HQ * (D / 64);
  static constexpr int TK = HK * (D / 64);
  static constexpr int Q = 0, DO = TQ, STAGES = 2 * TQ;
  static constexpr int STAGE = 2 * TK;       // k, then v
  static constexpr int BARS = STAGES + DQ_STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * DQ_STAGES) + 1024;
};

template <int D>
struct DkvSmem {
  static constexpr int HT = BT * 128;
  static constexpr int TT = HT * (D / 64);
  static constexpr int K = 0, V = TT, STAGES = 2 * TT;
  // q, dO, then lse * log2(e) and delta (BT f32 each), padded so that every
  // tile stays 1024-byte aligned
  static constexpr int STAGE = 2 * TT + 1024;
  static constexpr int BARS = STAGES + DKV_STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * DKV_STAGES) + 1024;
  static_assert(128 * D * 4 <= DKV_STAGES * STAGE,
                "the group sum's buffer reuses the stages");
};

template <typename TO, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dq, int S, int H,
    int group, float scale, int causal, int window, int off, int last_first) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + DQ_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (last_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BQ;
  // each warpgroup's key tiles, and their union, which the producer streams
  int lo[2], hi[2];
  key_tiles(q0, 64, S, off, causal, window, lo[0], hi[0]);
  key_tiles(q0 + 64, 64, S, off, causal, window, lo[1], hi[1]);
  const int t_lo = lo[0] < hi[0] ? lo[0] : lo[1];
  const int n_tiles = max(0, max(hi[0], hi[1]) - t_lo);

  if (threadIdx.x == 0) {
    bar_init(qfull, 1);
    for (int i = 0; i < DQ_STAGES; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      const int hk = h / group;
      bar_arrive_expect(qfull, 2 * L::TQ);
      for (int c = 0; c < D / 64; ++c) {
        tma_load(smem + L::Q + c * L::HQ, &tq, qfull, 64 * c, h, q0, b);
        tma_load(smem + L::DO + c * L::HQ, &tdo, qfull, 64 * c, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % DQ_STAGES;
        bar_wait(&empty[st], ((i / DQ_STAGES) & 1) ^ 1);
        uint8_t* kv = smem + L::STAGES + st * L::STAGE;
        const int k0 = (t_lo + i) * BT;
        bar_arrive_expect(&full[st], 2 * L::TK);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(kv + c * L::HK, &tk, &full[st], 64 * c, hk, k0, b);
          tma_load(kv + L::TK + c * L::HK, &tv, &full[st], 64 * c, hk, k0, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * wg;  // this warpgroup's first row
    const int ra = row0 + 16 * warp + lane / 4;  // the thread's two rows
    const int rb = ra + 8;
    const int cq = 2 * (lane % 4);  // its first column of each 8
    const int my_lo = wg ? lo[1] : lo[0];
    const int my_hi = wg ? hi[1] : hi[0];
    const long long vb = static_cast<long long>(bh) * S;
    const float lse_a = ra < S ? lse[vb + ra] * LOG2E : 0.f;
    const float lse_b = rb < S ? lse[vb + rb] * LOG2E : 0.f;
    const float dl_a = ra < S ? delta[vb + ra] : 0.f;
    const float dl_b = rb < S ? delta[vb + rb] : 0.f;
    const float sl2 = scale * LOG2E;
    const uint32_t q_s = smem_u32(smem + L::Q) + wg * 64 * 128;
    const uint32_t do_s = smem_u32(smem + L::DO) + wg * 64 * 128;

    float acc[D / 2], s[32], dp[32];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;

    if (n_tiles > 0) bar_wait(qfull, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % DQ_STAGES;
      const int t = t_lo + i;
      bar_wait(&full[st], (i / DQ_STAGES) & 1);
      if (t >= my_lo && t < my_hi) {
        const uint32_t k_s = smem_u32(smem + L::STAGES + st * L::STAGE);
        const uint32_t v_s = k_s + L::TK;
        hold(s);
        hold(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss_n64(s, k_major(q_s, L::HQ, kk), k_major(k_s, L::HK, kk), kk);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss_n64(dp, k_major(do_s, L::HQ, kk), k_major(v_s, L::HK, kk),
                     kk);
        wgmma_commit();
        wgmma_wait_all();
        hold(s);
        hold(dp);

        const int k0 = t * BT;
        const bool whole =
            row0 + 63 < S && k0 + BT - 1 < S &&
            (!causal || (off + row0 >= k0 + BT - 1 &&
                         (window <= 0 || off + row0 + 63 - k0 < window)));
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float ds[2];
#pragma unroll
            for (int y = 0; y < 2; ++y) {
              const int e = 8 * kk + 2 * x + y;
              const bool lower = (e & 2) != 0;  // row rb
              const int col = k0 + 8 * (e / 4) + cq + (e & 1);
              const bool keep =
                  whole ||
                  live(lower ? rb : ra, col, S, off, causal, window);
              const float p = exp2f(
                  fmaf(keep ? s[e] : NEG_INF, sl2, lower ? -lse_b : -lse_a));
              ds[y] = p * (dp[e] - (lower ? dl_b : dl_a));
            }
            a[kk][x] = pack_bf16(ds[0], ds[1]);
          }

        hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs<D>(acc, a[kk], mn_major(k_s, L::HK, kk));
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
        hold(a);
      }
      bar_arrive(&empty[st]);
    }

#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = u ? rb : ra;
        if (row < S)
          store2(dq + ((static_cast<long long>(b) * S + row) * H + h) * D +
                     8 * j + cq,
                 acc[4 * j + 2 * u] * scale, acc[4 * j + 2 * u + 1] * scale);
      }
  }
}

template <typename TO, int D>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
    const float* __restrict__ delta, TO* __restrict__ dk, TO* __restrict__ dv,
    int S, int H, int group, float scale, int causal, int window, int off,
    int last_first) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + DKV_STAGES;

  const int h_kv = H / group;
  const int b = blockIdx.x / h_kv;
  const int hk = blockIdx.x % h_kv;
  const int k0 = (last_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BT;
  // the work items: (query head g of the group, query tile t), item
  // i = g * nt + (t - t_lo); warpgroup w takes items w, w + 2, ...
  int t_lo, t_hi;
  query_tiles(k0, S, off, causal, window, t_lo, t_hi);
  const int nt = t_hi - t_lo;
  const int n_items = group * nt;

  if (threadIdx.x == 0) {
    bar_init(kvfull, 1);
    for (int i = 0; i < DKV_STAGES; ++i) {
      bar_init(&full[i], 32);
      bar_init(&empty[i], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x < 256 + 32 && n_items > 0) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        bar_arrive_expect(kvfull, 2 * L::TT);
        for (int c = 0; c < D / 64; ++c) {
          tma_load(smem + L::K + c * L::HT, &tk, kvfull, 64 * c, hk, k0, b);
          tma_load(smem + L::V + c * L::HT, &tv, kvfull, 64 * c, hk, k0, b);
        }
      }
      for (int i = 0; i < n_items; ++i) {
        const int st = i % DKV_STAGES;
        const int hq = hk * group + i / nt;
        const int q0 = (t_lo + i % nt) * BT;
        bar_wait(&empty[st], ((i / DKV_STAGES) & 1) ^ 1);
        uint8_t* tile = smem + L::STAGES + st * L::STAGE;
        float* rows = reinterpret_cast<float*>(tile + 2 * L::TT);
        const long long vb = (static_cast<long long>(b) * H + hq) * S;
        for (int r = lane; r < BT; r += 32) {
          const bool ok = q0 + r < S;
          rows[r] = ok ? lse[vb + q0 + r] * LOG2E : 0.f;
          rows[BT + r] = ok ? delta[vb + q0 + r] : 0.f;
        }
        if (lane == 0) {
          bar_arrive_expect(&full[st], 2 * L::TT);
          for (int c = 0; c < D / 64; ++c) {
            tma_load(tile + c * L::HT, &tq, &full[st], 64 * c, hq, q0, b);
            tma_load(tile + L::TT + c * L::HT, &tdo, &full[st], 64 * c, hq, q0,
                     b);
          }
        } else {
          bar_arrive(&full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int ka = k0 + 16 * warp + lane / 4;  // the thread's two keys
    const int kb = ka + 8;
    const int cq = 2 * (lane % 4);
    const float sl2 = scale * LOG2E;
    const uint32_t k_s = smem_u32(smem + L::K);
    const uint32_t v_s = smem_u32(smem + L::V);

    float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;

    if (n_items > 0) bar_wait(kvfull, 0);
    for (int i = wg; i < n_items; i += 2) {
      const int st = i % DKV_STAGES;
      const int q0 = (t_lo + i % nt) * BT;
      bar_wait(&full[st], (i / DKV_STAGES) & 1);
      const uint32_t q_s = smem_u32(smem + L::STAGES + st * L::STAGE);
      const uint32_t do_s = q_s + L::TT;
      const float* rows = reinterpret_cast<const float*>(
          smem + L::STAGES + st * L::STAGE + 2 * L::TT);
      hold(s);
      hold(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(s, k_major(k_s, L::HT, kk), k_major(q_s, L::HT, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss_n64(dp, k_major(v_s, L::HT, kk), k_major(do_s, L::HT, kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      hold(s);
      hold(dp);

      // rows are keys, columns queries
      const bool whole =
          k0 + BT - 1 < S && q0 + BT - 1 < S &&
          (!causal || (off + q0 >= k0 + BT - 1 &&
                       (window <= 0 || off + q0 + BT - 1 - k0 < window)));
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float p2[2], ds[2];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            const int e = 8 * kk + 2 * x + y;
            const int c = 8 * (e / 4) + cq + (e & 1);
            const bool keep =
                whole || live(q0 + c, (e & 2) ? kb : ka, S, off, causal,
                              window);
            p2[y] = exp2f(fmaf(keep ? s[e] : NEG_INF, sl2, -rows[c]));
            ds[y] = p2[y] * (dp[e] - rows[BT + c]);
          }
          pa[kk][x] = pack_bf16(p2[0], p2[1]);
          da[kk][x] = pack_bf16(ds[0], ds[1]);
        }

      hold(dk_acc);
      hold(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<D>(dv_acc, pa[kk], mn_major(do_s, L::HT, kk));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<D>(dk_acc, da[kk], mn_major(q_s, L::HT, kk));
      wgmma_commit();
      wgmma_wait_all();
      hold(dk_acc);
      hold(dv_acc);
      hold(pa);
      hold(da);
      bar_arrive(&empty[st]);
    }

    // The group sum of the two warpgroups, in a fixed order: warpgroup 1's
    // partials go through the (now idle) stages to warpgroup 0, whose
    // fragment layout is the same.
    sync_consumers();
    float* red = reinterpret_cast<float*>(smem + L::STAGES);
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) {
        red[e * 128 + tid] = dk_acc[e];
        red[(D / 2 + e) * 128 + tid] = dv_acc[e];
      }
    }
    sync_consumers();
    if (wg == 0) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = u ? kb : ka;
          if (key >= S) continue;
          const int e = 4 * j + 2 * u;
          const long long at =
              ((static_cast<long long>(b) * S + key) * h_kv + hk) * D + 8 * j +
              cq;
          store2(dk + at, (dk_acc[e] + red[e * 128 + tid]) * scale,
                 (dk_acc[e + 1] + red[(e + 1) * 128 + tid]) * scale);
          store2(dv + at, dv_acc[e] + red[(D / 2 + e) * 128 + tid],
                 dv_acc[e + 1] + red[(D / 2 + e + 1) * 128 + tid]);
        }
    }
  }
}

}  // namespace tc

// Arguments shared by all kernels, as the C interface receives them.
struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  int B, S, H, Hkv, D;
  long long st[12];   // (batch, sequence, head) strides of q, k, v, dO
  float scale;
  int causal, window, off;
};

template <typename T, typename TO, int DMAX, bool PIECES = false>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int smem = dq_smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dq_kernel<T, TO, DMAX, PIECES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = tile_rows<DMAX>();
  const dim3 grid(a.B * a.H, (a.S + rows - 1) / rows, (a.D + DMAX - 1) / DMAX);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<TO*>(a.out0), a.S, a.H, a.H / a.Hkv, a.D, a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8], a.st[9],
      a.st[10], a.st[11], a.scale, a.causal, a.window, a.off);
  return cudaGetLastError();
}

template <typename T, typename TO, int DMAX, bool PIECES = false>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int smem = dkv_smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kernel = flash_bwd_dkv_kernel<T, TO, DMAX, PIECES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  constexpr int rows = tile_rows<DMAX>();
  const dim3 grid(a.B * a.Hkv, (a.S + rows - 1) / rows,
                  (a.D + DMAX - 1) / DMAX);
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
  if (a.D <= 128)
    return DQ ? launch_dq<T, TO, 128>(a, s) : launch_dkv<T, TO, 128>(a, s);
  if (a.D <= 256)
    return DQ ? launch_dq<T, TO, 256>(a, s) : launch_dkv<T, TO, 256>(a, s);
  return DQ ? launch_dq<T, TO, 256, true>(a, s)
            : launch_dkv<T, TO, 256, true>(a, s);
}

// f32_out: gradients in f32 (the band kernels) rather than the input type.
template <bool DQ>
int run(const Args& a, int dtype, bool f32_out, void* stream) {
  if (a.D < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || (dtype != 0 && dtype != 1))
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

template <typename TO, int D, bool DQ>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  const int q_rows = DQ ? tc::BQ : tc::BT;
  CUtensorMap tq, tk, tv, tdo;
  if (!tc::tensor_map(&tq, a.q, a.B, a.S, a.H, D, a.st, q_rows) ||
      !tc::tensor_map(&tk, a.k, a.B, a.S, a.Hkv, D, a.st + 3, tc::BT) ||
      !tc::tensor_map(&tv, a.v, a.B, a.S, a.Hkv, D, a.st + 6, tc::BT) ||
      !tc::tensor_map(&tdo, a.dout, a.B, a.S, a.H, D, a.st + 9, q_rows))
    return cudaErrorInvalidValue;
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const int group = a.H / a.Hkv;
  cudaError_t err;
  if constexpr (DQ) {
    constexpr int smem = tc::DqSmem<D>::BYTES;
    auto kernel = tc::flash_bwd_dq_wgmma_kernel<TO, D>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const int n = (a.S + tc::BQ - 1) / tc::BQ;
    const dim3 grid(a.B * a.H, n);
    kernel<<<grid, tc::THREADS, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<TO*>(a.out0), a.S, a.H, group,
        a.scale, a.causal, a.window, a.off,
        tc::last_tile_first(true, n, a.S, a.off, a.causal, a.window));
  } else {
    constexpr int smem = tc::DkvSmem<D>::BYTES;
    auto kernel = tc::flash_bwd_dkv_wgmma_kernel<TO, D>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const int n = (a.S + tc::BT - 1) / tc::BT;
    const dim3 grid(a.B * a.Hkv, n);
    kernel<<<grid, tc::THREADS, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<TO*>(a.out0),
        static_cast<TO*>(a.out1), a.S, a.H, group, a.scale, a.causal,
        a.window, a.off,
        tc::last_tile_first(false, n, a.S, a.off, a.causal, a.window));
  }
  return cudaGetLastError();
}

// The tensor-core route takes what tc::route_takes says of q, k, v and dO.
template <bool DQ>
int run_wgmma(const Args& a, int dtype, bool f32_out, void* stream) {
  if (!tc::route_takes(dtype, a.D, a.H, a.Hkv, {a.q, a.k, a.v, a.dout}, a.st,
                       12))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (f32_out)
    err = a.D == 64 ? launch_wgmma<float, 64, DQ>(a, s)
                    : launch_wgmma<float, 128, DQ>(a, s);
  else
    err = a.D == 64 ? launch_wgmma<__nv_bfloat16, 64, DQ>(a, s)
                    : launch_wgmma<__nv_bfloat16, 128, DQ>(a, s);
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

// The same four entry points on the tensor-core route (see run_wgmma for
// what it takes).
extern "C" int hvd_flash_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int causal, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, causal, window, 0};
  return run_wgmma<true>(a, dtype, false, stream);
}

extern "C" int hvd_flash_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int S, int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int causal, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, causal, window, 0};
  return run_wgmma<false>(a, dtype, false, stream);
}

extern "C" int hvd_flash_band_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int dtype, int B, int S,
    int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int off, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, 1, window, off};
  return run_wgmma<true>(a, dtype, true, stream);
}

extern "C" int hvd_flash_band_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int dtype, int B,
    int S, int H, int Hkv, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, float scale,
    int off, int window, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh},
               scale, 1, window, off};
  return run_wgmma<false>(a, dtype, true, stream);
}

// Dynamic shared memory of a tensor-core kernel in bytes (dkv 0: the dq
// kernel), for reports; 0 for a head dim the route does not take.
extern "C" int hvd_flash_bwd_wgmma_smem(int dkv, int d) {
  if (d == 64) return dkv ? tc::DkvSmem<64>::BYTES : tc::DqSmem<64>::BYTES;
  if (d == 128) return dkv ? tc::DkvSmem<128>::BYTES : tc::DqSmem<128>::BYTES;
  return 0;
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
