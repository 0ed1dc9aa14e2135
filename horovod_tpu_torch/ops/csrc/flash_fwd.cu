// Flash-attention forward for Hopper (sm_90a) on bf16 or f32 inputs.
//
// Replaces two Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//
//   hvd_flash_fwd       <- _fwd_kernel       (launched by _flash_fwd_impl)
//   hvd_flash_band_fwd  <- _band_fwd_kernel  (launched by _band_tile_fwd)
//
// A band tile is ring attention's tile of a visiting K/V shard: its query rows
// sit `off` global positions after the K/V origin, so query row i is at
// position off + i for the causal and window masks. The static kernel is the
// band kernel at off = 0, and both run the same tile loops. The TPU passed off
// as an SMEM scalar; here it is an int argument. It computes, for every query
// row,
//
//     s   = (q * scale) . k^T            in f32, scale = 1/sqrt(D)
//     s   = -1e30 where masked            (causal, sliding window, ragged edge)
//     out = softmax(s) . v                (online: running max m, normalizer l)
//     lse = m + log(max(l, 1e-30))
//
// Layout: q (B, S, H, D), k/v (B, S, H_kv, D) with the head dim contiguous and
// any strides on B, S and H; out (B, S, H, D) contiguous in the input type; lse
// (B, H, S) contiguous f32. Grouped-query attention reads kv head h / group and
// never expands K/V.
//
// Two routes, chosen by the wrapper (ops/flash_attention.py,
// tensor_core_route) and checked again here:
//
// - The tensor-core route (flash_fwd_wgmma_kernel, entries hvd_*_wgmma):
//   bf16 inputs, D 64 or 128, 16-byte-aligned base pointers and (batch,
//   sequence, head) strides. Serving's prefill, training and the
//   sequence-parallel path run it.
// - The CUDA-core loop (flash_fwd_kernel): every other shape, f32 inputs among
//   them, in the reference's f32 arithmetic and order of operations: q is
//   converted to f32 and scaled before the product, and the products are
//   exact f32 (TF32 stays off).
//
// Both routes fill masked scores with -1e30 (not -inf), clamp l at 1e-30
// before the division and the log, and keep m, the fill and lse in natural-log
// units: the tensor-core route multiplies by log2(e) only inside exp2, so a
// masked score stays -1e30 and never becomes -1e30 * scale * log2(e) (a dead
// row's lse would then be about -9e28, above the ring's -1e29). A row with no
// live key in a visited tile (a band tile's rows past the window) gets
// p = exp(-1e30 - (-1e30)) = 1 for every masked column, as in the reference;
// a later live tile wipes that out through alpha = exp(-1e30 - m) = 0. A row
// with no live key anywhere ends with lse -1e30 (to f32 precision) and a
// finite out, the mean of the V rows its warpgroup visited, or 0 when it
// visited none (l clamped): the ring's lse merge gives it weight 0, and needs
// its lse <= -1e29.
//
// Design. The TPU kernel carries (m, l, acc) across a sequential kv grid axis.
// Blocks on Hopper run in no order, so a CTA owns its query rows and loops over
// the key tiles itself. The causal and window tile skips of the TPU kernels
// (pl.when, and _band_live for a band tile) become that loop's bounds, computed
// at the tile's offset; the in-tile masks and the ragged edge (S not a
// multiple of 64) are masked per element, so the card needs neither the
// reference's pad-to-128 path nor its dense fallback.
//
// The tensor-core route (its machinery in hopper.cuh, shared with
// flash_bwd.cu): one CTA per (b*h, 128-row query tile), 384 threads. A
// producer warp loads Q once by TMA (bf16, unscaled) and streams K and V in
// 64-row tiles through 4 shared-memory stages guarded by full/empty mbarriers
// (4-D tensor maps over (D, heads, S, B), 64-column boxes, 128-byte swizzle,
// zeros past S): the union of the two warpgroups' live key tiles (key_tiles).
// Each consumer warpgroup (240 registers by setmaxnreg) owns 64 query rows
// and, for each of its live tiles: S = Q.K^T by wgmma m64n64k16 (both
// operands K-major in shared memory); x = s * scale or -1e30 in f32
// registers; the row max over the 4 lanes of a quad; m_new = max(m, rowmax),
// alpha = exp(m - m_new), p = exp2((x - m_new) * log2(e)) in f32; l = l * alpha
// + sum(p) from the f32 p; acc *= alpha; p packed to bf16 straight into the A
// fragment of O += P.V (m64nDk16, V read MN-major from the same stage through
// the transpose flag), so P never touches shared memory. The epilogue writes
// out = acc / max(l, 1e-30) and lse = m + log(l). The grid launches its
// heavier end first (last_tile_first). No atomics: the same bits every run.
//
// Rounding of the tensor-core route against the f32 reference: s is a sum of
// exact products of bf16 values in f32, scaled after the product instead of
// before (about one f32 rounding; scaling q to bf16 first would round every
// q), and P is rounded to bf16 before P.V, as SDPA rounds it, each term by at
// most 2^-8 of itself, while l sums the f32 p. So an out element differs from
// the f32 plain version by at most 2^-8 of (sum_j p_j |v_j|) / l before the
// bf16 output rounding (ops/flash_attention.py, fwd_bf16_rounding_bound),
// and from the plain version run with operand_dtype=torch.bfloat16 by
// summation order and by P being rounded against the running max, not the
// row's final one.
//
// The loop: one CTA per (b*h, 64-row q tile), 128 threads, each owning 4 query
// rows x 8 score columns of a tile and 4 rows x D/8 output columns, so the row
// max and row sum reduce over the 8 lanes of a row with shuffles. Each kv tile
// is converted to f32 in shared memory; the P tile reuses the K tile's shared
// memory. Padded row strides (D + 1, 64 + 1) keep the shared-memory reads free
// of bank conflicts. Tiles are padded to DMAX 32, 64, 128 or 256 columns; at
// DMAX 256 a CTA takes 197,120 bytes of shared memory, inside the 227 KB a block
// may have, and grid.x carries B*H (grid.y would stop at 65535). A head dim
// above 256 is held in 256-column pieces: S sums over the pieces of q and k
// (each piece loaded in turn, in column order, so every CTA of a row gets the
// same bits), and grid.z gives each CTA one 256-column piece of O, so a CTA
// recomputes S once per output piece.
//
// Bound on this card (H100 SXM): 4*D FLOPs per live (query, key) pair against
// 989 TFLOP/s bf16, and the bytes (2*B*H*S*D + 2*B*H_kv*S*D) * dtype size (Q
// and O, K and V) against 3.35 TB/s. At the serving prefill shape (B 8, S 512,
// H 16, H_kv 4, D 128, bf16) the bytes bound is the larger one, 0.0126 ms
// against 0.0087 ms; at the training shape (B 4, S 4096, causal) operations
// bound it, 275 GFLOP in 0.278 ms. A band tile has fewer live pairs: at the
// ring's shapes (S 2048, window 4096) the tile at off 2048 is fully visible and
// the one at off 4096 half masked, and operations bound both.

#include <math.h>

#include "hopper.cuh"

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

// PIECES: the head dim may exceed DMAX (then DMAX is 256 and the pieces of
// the file comment run); without it the pieces fold away at compile time.
template <typename T, int DMAX, bool PIECES>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int H, int group, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, float scale,
    int causal, int window, int off) {
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
  // B*H on grid.x (up to 2^31 - 1 blocks; grid.y stops at 65535), q tiles
  // on grid.y, highest first: under a causal mask they have the most kv
  // tiles.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / group;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  // Pieces of the score sum, and this CTA's output columns [c0, c0 + DMAX).
  const int n_dp = PIECES ? (D + DMAX - 1) / DMAX : 1;
  const int c0 = PIECES ? blockIdx.z * DMAX : 0;
  const int d_end = PIECES ? D : 1;  // the pieces' starts are below d_end

  // The q columns [d0, d0 + DMAX), scaled, into qs.
  auto load_q = [&](int d0) {
    for (int i = tid; i < BQ * DMAX; i += THREADS) {
      const int r = i / DMAX, d = i % DMAX;
      float x = 0.f;
      if (q0 + r < S && d0 + d < D)
        x = to_f32(qb[(q0 + r) * qss + d0 + d]) * scale;
      qs[r * LDQ + d] = x;
    }
  };
  if (n_dp == 1) load_q(0);

  float m[RPT], l[RPT], acc[RPT][OCPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OCPT; ++c) acc[i][c] = 0.f;
  }

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
    __syncthreads();  // the previous tile's p and v reads are done

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < d_end; d0 += DMAX) {
      if (d0 > 0) __syncthreads();  // the previous piece's reads are done
      if (n_dp > 1) load_q(d0);
      // this piece of k; with the first, this CTA's piece of v
      for (int i = tid; i < BK * DMAX; i += THREADS) {
        const int r = i / DMAX, d = i % DMAX;
        const bool row = k0 + r < S;
        kp[r * LDK + d] =
            row && d0 + d < D ? to_f32(kb[(k0 + r) * kss + d0 + d]) : 0.f;
        if (d0 == 0)
          vs[r * LDV + d] =
              row && c0 + d < D ? to_f32(vb[(k0 + r) * vss + c0 + d]) : 0.f;
      }
      __syncthreads();
      const int dw = PIECES ? min(DMAX, D - d0) : D;
      for (int d = 0; d < dw; ++d) {
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
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = off + q0 + ty + TY * i;  // the row's position
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
        const int d = c0 + tx + TX * c;
        if (d < D) store(orow + d, acc[i][c] / lt);
      }
      if (tx == 0 && blockIdx.z == 0)
        lse[(static_cast<long long>(b) * H + h) * S + qp] = m[i] + logf(lt);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route.

namespace tc {

constexpr int FWD_STAGES = 4;

// Shared memory in bytes from a 1024-byte-aligned base: the q tile, then the
// stages of (k, v), then the mbarriers (hopper.cuh describes the tiles).
template <int D>
struct FwdSmem {
  static constexpr int HQ = BQ * 128;        // a half of the q tile
  static constexpr int HK = BT * 128;        // a half of a k or v tile
  static constexpr int TQ = HQ * (D / 64);
  static constexpr int TK = HK * (D / 64);
  static constexpr int Q = 0, STAGES = TQ;
  static constexpr int STAGE = 2 * TK;       // k, then v
  static constexpr int BARS = STAGES + FWD_STAGES * STAGE;
  static constexpr int BYTES = BARS + 8 * (1 + 2 * FWD_STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int group, float scale, int causal,
    int window, int off, int last_first) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + FWD_STAGES;

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
    for (int i = 0; i < FWD_STAGES; ++i) {
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
      bar_arrive_expect(qfull, L::TQ);
      for (int c = 0; c < D / 64; ++c)
        tma_load(smem + L::Q + c * L::HQ, &tq, qfull, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % FWD_STAGES;
        bar_wait(&empty[st], ((i / FWD_STAGES) & 1) ^ 1);
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
    const uint32_t q_s = smem_u32(smem + L::Q) + wg * 64 * 128;

    // Per row u (0: ra, 1: rb): the running max, and this thread's share of
    // the running normalizer (its 16 columns of each tile; the quad's four
    // shares are summed at the end, their common alpha factored out).
    float acc[D / 2], s[32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;

    if (n_tiles > 0) bar_wait(qfull, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % FWD_STAGES;
      const int t = t_lo + i;
      bar_wait(&full[st], (i / FWD_STAGES) & 1);
      if (t >= my_lo && t < my_hi) {
        const uint32_t k_s = smem_u32(smem + L::STAGES + st * L::STAGE);
        const uint32_t v_s = k_s + L::TK;
        hold(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_ss_n64(s, k_major(q_s, L::HQ, kk), k_major(k_s, L::HK, kk), kk);
        wgmma_commit();
        wgmma_wait_all();
        hold(s);

        // x = s * scale or -1e30, in natural-log units, and its row max
        const int k0 = t * BT;
        const bool whole =
            row0 + 63 < S && k0 + BT - 1 < S &&
            (!causal || (off + row0 >= k0 + BT - 1 &&
                         (window <= 0 || off + row0 + 63 - k0 < window)));
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int u = (e >> 1) & 1;
          const int col = k0 + 8 * (e / 4) + cq + (e & 1);
          const bool keep = whole || live(u ? rb : ra, col, S, off, causal,
                                          window);
          s[e] = keep ? s[e] * scale : NEG_INF;
          mx[u] = fmaxf(mx[u], s[e]);
        }
        float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
          mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
          const float m_new = fmaxf(m[u], mx[u]);
          alpha[u] = exp2f((m[u] - m_new) * LOG2E);
          m[u] = m_new;
        }
        // p in f32 for l, rounded to bf16 into the A fragment of P.V
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int e = 8 * kk + 2 * x;
            const int u = x & 1;
            const float p0 = exp2f((s[e] - m[u]) * LOG2E);
            const float p1 = exp2f((s[e + 1] - m[u]) * LOG2E);
            ps[u] += p0 + p1;
            a[kk][x] = pack_bf16(p0, p1);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u) l[u] = l[u] * alpha[u] + ps[u];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

        hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_rs<D>(acc, a[kk], mn_major(v_s, L::HK, kk));
        wgmma_commit();
        wgmma_wait_all();
        hold(acc);
        hold(a);
      }
      bar_arrive(&empty[st]);
    }

#pragma unroll
    for (int u = 0; u < 2; ++u) {
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 1);
      l[u] += __shfl_xor_sync(0xffffffffu, l[u], 2);
      l[u] = fmaxf(l[u], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = u ? rb : ra;
        if (row < S)
          store2(o + ((static_cast<long long>(b) * S + row) * H + h) * D +
                     8 * j + cq,
                 acc[4 * j + 2 * u] / l[u], acc[4 * j + 2 * u + 1] / l[u]);
      }
    if (lane % 4 == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = u ? rb : ra;
        if (row < S)
          lse[static_cast<long long>(bh) * S + row] = m[u] + logf(l[u]);
      }
    }
  }
}

}  // namespace tc

// Arguments of every launch, as the C interface receives them.
struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int B, S, H, Hkv, D;
  long long st[9];    // (batch, sequence, head) strides of q, k, v
  float scale;
  int causal, window, off;
};

template <typename T, int DMAX, bool PIECES = false>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_floats<DMAX>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, DMAX, PIECES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + BQ - 1) / BQ, (a.D + DMAX - 1) / DMAX);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o),
      static_cast<float*>(a.lse), a.S, a.H, a.H / a.Hkv, a.D, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8],
      a.scale, a.causal, a.window, a.off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch<T, 32>(a, s);
  if (a.D <= 64) return launch<T, 64>(a, s);
  if (a.D <= 128) return launch<T, 128>(a, s);
  if (a.D <= 256) return launch<T, 256>(a, s);
  return launch<T, 256, true>(a, s);
}

int run(const Args& a, int dtype, void* stream) {
  if (a.D < 1 || a.Hkv < 1 || a.H % a.Hkv != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? dispatch_d<float>(a, s)
                                     : dispatch_d<__nv_bfloat16>(a, s);
  return static_cast<int>(err);
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tc::tensor_map(&tq, a.q, a.B, a.S, a.H, D, a.st, tc::BQ) ||
      !tc::tensor_map(&tk, a.k, a.B, a.S, a.Hkv, D, a.st + 3, tc::BT) ||
      !tc::tensor_map(&tv, a.v, a.B, a.S, a.Hkv, D, a.st + 6, tc::BT))
    return cudaErrorInvalidValue;
  constexpr int smem = tc::FwdSmem<D>::BYTES;
  auto kernel = tc::flash_fwd_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n = (a.S + tc::BQ - 1) / tc::BQ;
  const dim3 grid(a.B * a.H, n);
  kernel<<<grid, tc::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), static_cast<float*>(a.lse),
      a.S, a.H, a.H / a.Hkv, a.scale, a.causal, a.window, a.off,
      tc::last_tile_first(true, n, a.S, a.off, a.causal, a.window));
  return cudaGetLastError();
}

// The tensor-core route takes what tc::route_takes says of q, k and v.
int run_wgmma(const Args& a, int dtype, void* stream) {
  if (!tc::route_takes(dtype, a.D, a.H, a.Hkv, {a.q, a.k, a.v}, a.st, 9))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.D == 64 ? launch_wgmma<64>(a, s)
                                    : launch_wgmma<128>(a, s));
}

}  // namespace

// Plain C interface for ctypes. dtype: 0 = float32, 1 = bfloat16. Strides are
// in elements, (batch, sequence, head) for each of q, k, v. window <= 0 means
// no window. Each returns the cudaError_t of its launch (0 = success).
extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int dtype, int B, int S, int H, int Hkv,
                             int D, long long qsb, long long qss, long long qsh,
                             long long ksb, long long kss, long long ksh,
                             long long vsb, long long vss, long long vsh,
                             float scale, int causal, int window, void* stream) {
  const Args a{q, k, v, o, lse, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               scale, causal, window, 0};
  return run(a, dtype, stream);
}

// The band tile: causal at offset `off` (query row i at position off + i),
// out in the input type and lse f32, as _band_fwd_kernel writes them.
extern "C" int hvd_flash_band_fwd(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int dtype, int B, int S,
                                  int H, int Hkv, int D, long long qsb,
                                  long long qss, long long qsh, long long ksb,
                                  long long kss, long long ksh, long long vsb,
                                  long long vss, long long vsh, float scale,
                                  int off, int window, void* stream) {
  const Args a{q, k, v, o, lse, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               scale, 1, window, off};
  return run(a, dtype, stream);
}

// The same two entry points on the tensor-core route (see run_wgmma for what
// it takes).
extern "C" int hvd_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B, int S,
                                   int H, int Hkv, int D, long long qsb,
                                   long long qss, long long qsh, long long ksb,
                                   long long kss, long long ksh, long long vsb,
                                   long long vss, long long vsh, float scale,
                                   int causal, int window, void* stream) {
  const Args a{q, k, v, o, lse, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               scale, causal, window, 0};
  return run_wgmma(a, dtype, stream);
}

extern "C" int hvd_flash_band_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, void* lse, int dtype,
    int B, int S, int H, int Hkv, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, float scale, int off, int window,
    void* stream) {
  const Args a{q, k, v, o, lse, B, S, H, Hkv, D,
               {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh},
               scale, 1, window, off};
  return run_wgmma(a, dtype, stream);
}

// Dynamic shared memory of the tensor-core kernel in bytes, for reports; 0
// for a head dim the route does not take.
extern "C" int hvd_flash_fwd_wgmma_smem(int d) {
  if (d == 64) return tc::FwdSmem<64>::BYTES;
  if (d == 128) return tc::FwdSmem<128>::BYTES;
  return 0;
}

extern "C" const char* hvd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
