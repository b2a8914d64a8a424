// Fused attention, backward, for Hopper (sm_90a): two stride-generic kernels
// (dq, then dk and dv) per dtype behind two entries, in two variants.
//
// (K1b, K1r) vdk_fused_qkv_attention_bwd: (qkv [B, N, 3C], dO [B, N, C], P)
// -> dqkv [B, N, 3C]. Replaces the Pallas TPU kernels of
// visiondk_tpu/ops/pallas/attention.py::_fused_vjp_bwd:
// _fused_bwd_from_p_kernel (:323-369, the default, which reads the
// probabilities the forward stashed; K1b) and _fused_bwd_kernel (:263-320,
// the recompute backward, chosen by VDK_ATTN_NO_PCACHE=1; K1r). Same layout
// contract as the forward: q, k, v are read by strides out of the packed
// [B, N, 3C] buffer, dO out of [B, N, C], and dq, dk, dv are written into the
// column blocks of dqkv (q at h*d, k at C + h*d, v at 2C + h*d).
//
// (K3r) vdk_vision_attention_bwd: (q, k, v, dO [B, H, N, D]) -> dq, dk, dv
// [B, H, N, D]. Replaces attention.py::_bwd_kernel (:68-92, launched by
// _attn_bwd_padded, the custom VJP of vision_attention), the recompute
// variant of the same kernels: q, k, v and dO are read through any (batch,
// head, token) strides with a unit-stride head dim, dq, dk and dv are written
// to three contiguous [B, H, N, D] buffers, n_valid = N (the JAX wrapper's
// padded keys do not exist here).
//
// Math, per (b, h), as the reference does it (attention.py:286-320, 343-369),
// in f32 from the input dtype's values:
//   from P:     P = the stash (masked keys hold 0)
//   recompute:  S = scale * log2(e) * (q . k^T), keys >= n_valid -> -1e30,
//               P = exp2(S - rowmax) * (1 / rowsum), NOT rounded
//   dV = P^T . dO        dP = dO . V^T        delta = rowsum(P o dP)
//   dS = P o (dP - delta)
//   dQ = scale * (dS . k)        dK = scale * (dS^T . q)
// delta is rowsum(P o dP) from the same P, never rowsum(dO o O): the two
// differ once O is rounded to bf16. scale multiplies dQ and dK after the sum
// (the reference scales k and q first; for the recompute variant it divides
// a log2-domain dK by log2(e)): a last-bit difference.
//
// Structure. The Pallas kernel holds a (row, head)'s whole N x N block in
// VMEM and runs its grid in order; here blocks are tiled and run in
// parallel, so dQ (a sum over keys) and dK, dV (sums over queries) come from
// two kernels, with no atomics, so every run gives the same bits:
//   (a) dq kernel, per query tile: one pass over the key tiles for delta, one
//       for dS and dQ; the recompute variant first makes one more for the row
//       max and sum of exp2 (as the forward's pass 1) and writes them with
//       delta.
//   (b) dkv kernel, per key tile: one pass over the query tiles with the
//       delta (and max and 1 / sum) that (a) wrote: P, dP, dS, dV and dK.
// Both run on the same stream, so (b) sees (a)'s stats.
//
// What bounds it on the H100, at ViT-B/16 (B 128, N 197, 12 heads, d 64,
// bf16): bytes. The recompute variant reads q, k, v and dO and writes dq, dk
// and dv once, 271.1 MB (81 us at 3.35 TB/s), against 38.2 GFLOP of the
// reference's five products (39 us at the bf16 tensor-core peak); from P it
// also reads the 119.2 MB stash (390.3 MB, 117 us; 30.5 GFLOP, four
// products).
//
// bfloat16 (the main path): tensor cores. A warp owns 16 rows (queries in
// (a), keys in (b)); the rows of a (head, batch row) are split over blocks of
// up to 7 warps as in the forward (tc::split_rows). Every product is
// mma.sync m16n8k16 (bf16 in, f32 accumulation) on fragments from ldmatrix:
//   (a) S = q . k^T (recompute), dP = dO . v^T, dQ += dS . k (k by
//       ldmatrix.trans);
//   (b) S^T = k . q^T (recompute), dP^T = v . dO^T, dV += P^T . dO and
//       dK += dS^T . q (dO, q by ldmatrix.trans). Computing S^T and dP^T with
//       the key rows as M puts P^T and dS^T in the accumulators, so they
//       become A fragments in registers, never shared memory; the stashed P
//       comes as P^T fragments by ldmatrix.trans of its [query][key] tile.
// Inner tiles are 32 keys in (a) and 16 queries in (b): the accumulators
// stay small enough for two blocks of 7 warps an SM. Tiles of q, k, v, dO
// and the stash stay bf16 in shared memory (head dim padded to 32, 64, 80 or
// 128 with zeros) and arrive by cp.async, 16 bytes a thread, into rings of
// two stages; the row stats come by 4-byte cp.async. A view whose rows are
// not 16-byte aligned is staged element by element into the same bytes, and
// so is the stash of an N that is not a multiple of 8 (N = 197), which
// cp.async cannot take (a prefetch of it through registers, one stage ahead,
// cost the dq kernel enough registers to halve its blocks an SM and was
// slower on the H100).
// Rounding against the reference, which keeps dS and the recompute variant's
// P in f32 (attention.py:75-92, :298-315): a bf16 operand rounds them. One
// rounding put the backward above a quarter of chip_smoke.py's bar (bf16
// dqkv within 1.6e-2 * max(1, |plain|); tests/test_torch_port_attention_
// rounding.py models it), so dS and the recomputed P are split into bf16
// hi + lo = bf16(x - hi) and multiplied twice, which carries them to about
// 16 bits; the stashed P is bf16 already and multiplies once. The scores are
// the f32 product of the bf16 q and k, scaled in f32 after it.
//
// float32: CUDA-core kernels, kept for the f32 bars (dqkv
// 1e-4, the one-step train comparison at 1e-5 loss); TF32 products would not
// hold them. One block per (32 rows, head, batch row), 128 threads, products
// out of f32 shared memory. run() dispatches on dtype: a bf16 tensor never
// reaches these kernels.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "attention_tc.cuh"

namespace {

using tc::View;

// ---------------------------------------------------------------- float32

// Thread t of the 128 owns row t / 4 of the block's 32 rows and, within
// every 64-column tile, the columns (t % 4) + 4j, j < 16; for the products
// into [rows, d] it owns the dims (t % 4) + 4i.
constexpr int kThreads = 128;
constexpr int kRows = 32;                          // rows a block owns
constexpr int kTile = 64;                          // columns per inner tile
constexpr int kLanesPerRow = kThreads / kRows;     // 4
constexpr int kColsPerLane = kTile / kLanesPerRow;  // 16
constexpr float kMaskValue = -1e30f;               // the reference's key mask

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// Copies rows [row0, row0 + ROWS) of one head's slice of a row-major buffer
// into shared memory (row stride DP + 1 floats) as f32 times `mul`, with
// zeros for rows >= n and dims >= d.
// Thread t keeps column t % DP and reads rows t / DP + i * kThreads / DP,
// i < ROWS * DP / kThreads. Every load is unconditional: a row >= n reads the
// last real row and a dim >= d the last real dim, and a select stores 0 for
// them. So every thread makes the same, compile-time number of loads with no
// branch between them, and the unrolled loop issues eight before their first
// use (faster on the H100 than a predicated load or 2, 4, 16 or full unrolls;
// PERF.md). row0 < n.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int64_t row_stride, int row0,
                                          int n, int d, float mul) {
  constexpr int kRowStep = kThreads / DP;
  static_assert(kThreads % DP == 0 && ROWS % kRowStep == 0, "each thread keeps one column");
  const int c = threadIdx.x % DP;
  const int r0 = threadIdx.x / DP;
  const int valid = c < d ? n - row0 : 0;  // rows this thread may read
  const int last = min(ROWS, n - row0) - 1;  // the last real row of the tile
  const T* ptr = src + row0 * row_stride + min(c, d - 1);
#pragma unroll 8
  for (int i = 0; i < ROWS / kRowStep; ++i) {
    const int r = r0 + i * kRowStep;
    const float x = to_float(ptr[min(r, last) * row_stride]);
    dst[r * (DP + 1) + c] = r < valid ? x * mul : 0.f;
  }
}

// s[j] = <row r of a, row g + 4j of b>; both in shared memory, stride DP + 1.
template <int DP>
__device__ __forceinline__ void row_dots(const float* a, const float* b, int r, int g,
                                         float (&s)[kColsPerLane]) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < DP; ++kd) {
    const float x = a[r * (DP + 1) + kd];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      s[j] = fmaf(x, b[(g + j * kLanesPerRow) * (DP + 1) + kd], s[j]);
    }
  }
}

// acc[i] += sum over cc < cols of w[r, cc] * m[cc, g + 4i]; w has stride
// kTile + 1, m stride DP + 1.
template <int DP>
__device__ __forceinline__ void accumulate(const float* w, const float* m, int r, int g, int cols,
                                           float (&acc)[DP / kLanesPerRow]) {
  for (int cc = 0; cc < cols; ++cc) {
    const float x = w[r * (kTile + 1) + cc];
    const float* mrow = m + cc * (DP + 1);
#pragma unroll
    for (int i = 0; i < DP / kLanesPerRow; ++i) acc[i] = fmaf(x, mrow[g + i * kLanesPerRow], acc[i]);
  }
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

// Shared-memory layouts, in floats.
template <int DP, bool kRecompute>
struct DqSmem {
  static constexpr int kQ = kRecompute ? kRows * (DP + 1) : 0;  // q * scale * log2(e)
  static constexpr int kDo = kRows * (DP + 1);
  static constexpr int kK = kTile * (DP + 1);
  static constexpr int kV = kTile * (DP + 1);
  static constexpr int kW = kRows * (kTile + 1);  // the P tile, then the dS tile
  static constexpr size_t kBytes = sizeof(float) * (kQ + kDo + kK + kV + kW);
};

template <int DP, bool kRecompute>
struct DkvSmem {
  static constexpr int kK = kRecompute ? kRows * (DP + 1) : 0;
  static constexpr int kV = kRows * (DP + 1);
  static constexpr int kQ = kTile * (DP + 1);
  static constexpr int kDo = kTile * (DP + 1);
  static constexpr int kP = kRows * (kTile + 1);   // P^T tile: [key row][query]
  static constexpr int kDs = kRows * (kTile + 1);  // dS^T tile
  static constexpr int kStats = (kRecompute ? 3 : 1) * kTile;  // delta[, max, 1/sum]
  static constexpr size_t kBytes = sizeof(float) * (kK + kV + kQ + kDo + kP + kDs + kStats);
};

struct Args {
  View q, k, v, dout;  // inputs
  View dq, dk, dv;     // outputs
  const void* p;       // [B, H, N, N] stash (from-P variant)
  float* delta;        // [B, H, N] rowsum(P o dP), written by (a), read by (b)
  float* row_m;        // [B, H, N] row max of S (recompute variant)
  float* row_il;       // [B, H, N] 1 / row sum of exp2(S - max) (recompute variant)
  int n, heads, d, n_valid;
  float q_mul;  // head_dim**-0.5 * log2(e)
  float scale;  // head_dim**-0.5
  float inv_log2e;
  int p_aligned;  // the stash's rows start on 16 bytes (bf16 kernels)
};

template <typename T, int DP, bool kRecompute>
__global__ void __launch_bounds__(kThreads) attention_bwd_dq_kernel(Args a) {
  using S = DqSmem<DP, kRecompute>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + S::kQ;
  float* ks = dos + S::kDo;
  float* vs = ks + S::kK;
  float* ws = vs + S::kV;

  const int n = a.n, d = a.d;
  const int m0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* k_src = a.k.head<const T>(b, h);
  const T* v_src = a.v.head<const T>(b, h);
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;

  const int r = threadIdx.x / kLanesPerRow;
  const int g = threadIdx.x % kLanesPerRow;
  const int row = m0 + r;

  load_rows<T, DP, kRows>(dos, a.dout.head<const T>(b, h), a.dout.sn, m0, n, d, 1.f);
  float m_row = 0.f, inv_l = 0.f;
  float s[kColsPerLane];
  if (kRecompute) {
    load_rows<T, DP, kRows>(qs, a.q.head<const T>(b, h), a.q.sn, m0, n, d, a.q_mul);
    // pass 0: the row's max and sum of exp2, as the forward's pass 1
    float m_loc = -INFINITY, l_loc = 0.f;
    for (int k0 = 0; k0 < n; k0 += kTile) {
      __syncthreads();
      load_rows<T, DP, kTile>(ks, k_src, a.k.sn, k0, n, d, 1.f);
      __syncthreads();
      row_dots<DP>(qs, ks, r, g, s);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = k0 + g + j * kLanesPerRow;
        if (key >= n) continue;
        const float sj = key < a.n_valid ? s[j] : kMaskValue;
        if (sj > m_loc) {
          l_loc = l_loc * exp2f(m_loc - sj) + 1.f;
          m_loc = sj;
        } else {
          l_loc += exp2f(sj - m_loc);
        }
      }
    }
    m_row = row_max(m_loc);
    inv_l = 1.f / row_sum(m_loc == -INFINITY ? 0.f : l_loc * exp2f(m_loc - m_row));
  }

  // This thread's P[row, k0 + g + 4j] and dP, for the key tile at k0.
  auto tile_p_dp = [&](int k0, float (&pv)[kColsPerLane], float (&dp)[kColsPerLane]) {
    row_dots<DP>(dos, vs, r, g, dp);
    if (kRecompute) {
      row_dots<DP>(qs, ks, r, g, s);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = k0 + g + j * kLanesPerRow;
        pv[j] = key < a.n_valid ? exp2f(s[j] - m_row) * inv_l : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) pv[j] = ws[r * (kTile + 1) + g + j * kLanesPerRow];
    }
  };
  auto load_p_tile = [&](int k0) {  // the stash, zero outside [:n, :n]
    const T* p_rows = static_cast<const T*>(a.p) + (bh * n + m0) * n;
    for (int idx = threadIdx.x; idx < kRows * kTile; idx += kThreads) {
      const int rr = idx / kTile;
      const int cc = idx - rr * kTile;
      float val = 0.f;
      if (m0 + rr < n && k0 + cc < n) {
        val = to_float(p_rows[static_cast<int64_t>(rr) * n + k0 + cc]);
      }
      ws[rr * (kTile + 1) + cc] = val;
    }
  };

  // pass 1: delta = rowsum(P o dP)
  float pv[kColsPerLane], dp[kColsPerLane];
  float dlt = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_rows<T, DP, kTile>(vs, v_src, a.v.sn, k0, n, d, 1.f);
    if (kRecompute) {
      load_rows<T, DP, kTile>(ks, k_src, a.k.sn, k0, n, d, 1.f);
    } else {
      load_p_tile(k0);
    }
    __syncthreads();
    tile_p_dp(k0, pv, dp);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) dlt = fmaf(pv[j], dp[j], dlt);
  }
  dlt = row_sum(dlt);
  if (g == 0 && row < n) {
    a.delta[bh * n + row] = dlt;
    if (kRecompute) {
      a.row_m[bh * n + row] = m_row;
      a.row_il[bh * n + row] = inv_l;
    }
  }

  // pass 2: dS = P o (dP - delta), dQ = scale * dS . k
  constexpr int kDimsPerLane = DP / kLanesPerRow;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kTile) {
    __syncthreads();
    load_rows<T, DP, kTile>(vs, v_src, a.v.sn, k0, n, d, 1.f);
    load_rows<T, DP, kTile>(ks, k_src, a.k.sn, k0, n, d, 1.f);
    if (!kRecompute) load_p_tile(k0);
    __syncthreads();
    tile_p_dp(k0, pv, dp);
    // each thread overwrites only the P entries it has just read
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      ws[r * (kTile + 1) + g + j * kLanesPerRow] = pv[j] * (dp[j] - dlt);
    }
    __syncthreads();
    accumulate<DP>(ws, ks, r, g, min(kTile, n - k0), acc);
  }

  if (row < n) {
    T* dq = a.dq.head<T>(b, h) + row * a.dq.sn;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) dq[dd] = from_float<T>(acc[i] * a.scale);
    }
  }
}

template <typename T, int DP, bool kRecompute>
__global__ void __launch_bounds__(kThreads) attention_bwd_dkv_kernel(Args a) {
  using S = DkvSmem<DP, kRecompute>;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + S::kK;
  float* qs = vs + S::kV;
  float* dos = qs + S::kQ;
  float* pt = dos + S::kDo;
  float* dst = pt + S::kP;
  float* st_delta = dst + S::kDs;
  float* st_m = st_delta + kTile;   // recompute only
  float* st_il = st_m + kTile;      // recompute only

  const int n = a.n, d = a.d;
  const int n0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q_src = a.q.head<const T>(b, h);
  const T* do_src = a.dout.head<const T>(b, h);
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;

  const int r = threadIdx.x / kLanesPerRow;
  const int g = threadIdx.x % kLanesPerRow;
  const int key = n0 + r;
  // q is scaled by scale (from P) or by scale * log2(e) (recompute: the score operand)
  const float q_mul = kRecompute ? a.q_mul : a.scale;

  if (kRecompute) load_rows<T, DP, kRows>(ks, a.k.head<const T>(b, h), a.k.sn, n0, n, d, 1.f);
  load_rows<T, DP, kRows>(vs, a.v.head<const T>(b, h), a.v.sn, n0, n, d, 1.f);

  constexpr int kDimsPerLane = DP / kLanesPerRow;
  float acc_dv[kDimsPerLane], acc_dk[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  float s[kColsPerLane], dp[kColsPerLane];
  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();
    load_rows<T, DP, kTile>(qs, q_src, a.q.sn, q0, n, d, q_mul);
    load_rows<T, DP, kTile>(dos, do_src, a.dout.sn, q0, n, d, 1.f);
    for (int qq = threadIdx.x; qq < kTile; qq += kThreads) {
      const bool in = q0 + qq < n;
      st_delta[qq] = in ? a.delta[bh * n + q0 + qq] : 0.f;
      if (kRecompute) {
        st_m[qq] = in ? a.row_m[bh * n + q0 + qq] : 0.f;
        st_il[qq] = in ? a.row_il[bh * n + q0 + qq] : 0.f;  // 0: no probability for pad rows
      }
    }
    if (!kRecompute) {
      // P^T tile; neighbouring threads read neighbouring keys of one query row
      const T* p_src = static_cast<const T*>(a.p) + (bh * n + q0) * n + n0;
      for (int idx = threadIdx.x; idx < kTile * kRows; idx += kThreads) {
        const int qq = idx / kRows;
        const int rr = idx - qq * kRows;
        float val = 0.f;
        if (q0 + qq < n && n0 + rr < n) val = to_float(p_src[static_cast<int64_t>(qq) * n + rr]);
        pt[rr * (kTile + 1) + qq] = val;
      }
    }
    __syncthreads();
    row_dots<DP>(vs, dos, r, g, dp);  // dP[query, key] = dO[query] . v[key]
    if (kRecompute) row_dots<DP>(ks, qs, r, g, s);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int qq = g + j * kLanesPerRow;
      float p;
      if (kRecompute) {
        p = key < a.n_valid ? exp2f(s[j] - st_m[qq]) * st_il[qq] : 0.f;
        pt[r * (kTile + 1) + qq] = p;
      } else {
        p = pt[r * (kTile + 1) + qq];
      }
      dst[r * (kTile + 1) + qq] = p * (dp[j] - st_delta[qq]);
    }
    __syncthreads();
    const int cols = min(kTile, n - q0);
    accumulate<DP>(pt, dos, r, g, cols, acc_dv);   // dV[key] += P[query, key] dO[query]
    accumulate<DP>(dst, qs, r, g, cols, acc_dk);   // dK[key] += dS[query, key] q'[query]
  }

  if (key < n) {
    T* dk = a.dk.head<T>(b, h) + key * a.dk.sn;
    T* dv = a.dv.head<T>(b, h) + key * a.dv.sn;
    const float dk_mul = kRecompute ? a.inv_log2e : 1.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) {
        dk[dd] = from_float<T>(acc_dk[i] * dk_mul);
        dv[dd] = from_float<T>(acc_dv[i]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, size_t max_bytes, size_t bytes, dim3 grid, int threads, const Args& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(max_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool kRecompute>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid((a.n + kRows - 1) / kRows, a.heads, b);
  constexpr size_t dq_bytes = DqSmem<DP, kRecompute>::kBytes, dkv_bytes = DkvSmem<DP, kRecompute>::kBytes;
  cudaError_t err = launch_one(attention_bwd_dq_kernel<float, DP, kRecompute>, dq_bytes, dq_bytes, grid,
                               kThreads, a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(attention_bwd_dkv_kernel<float, DP, kRecompute>, dkv_bytes, dkv_bytes, grid, kThreads, a,
                    stream);
}

template <bool kRecompute>
cudaError_t dispatch_dim(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch<32, kRecompute>(a, b, stream);
  if (a.d <= 64) return launch<64, kRecompute>(a, b, stream);
  return launch<128, kRecompute>(a, b, stream);
}

// ---------------------------------------------------------------- bfloat16

// Keys per inner tile of the dq kernel and queries per inner tile of the dkv
// kernel (multiples of 16). Narrow tiles keep the score, dP and dS
// accumulators small, so two blocks of 7 warps fit an SM at N = 197: of
// 64/64, 32/32, 64/32, 32/64, 16/16, 16/32 and 32/16 this pair was the
// fastest on the H100 for both variants.
constexpr int kDqTile = 32;
constexpr int kDkvTile = 16;

// Shared memory of the tensor-core dq kernel, in bf16 elements: the block's
// dO rows (later each warp's dQ tile) and, recomputing, its q rows; two
// stages of K and of V (kDqTile keys each); from P, two stages of the
// block's P rows x kDqTile keys.
template <int DP, bool kRecompute>
struct DqTcSmem {
  static constexpr int kLd = DP + tc::kPad;
  static constexpr int kLdP = kDqTile + tc::kPad;
  static constexpr size_t bytes(int warps) {
    const int rows = warps * tc::kWarpRows;
    return sizeof(tc::bf16) *
           ((kRecompute ? 2 : 1) * rows * kLd + 4 * kDqTile * kLd + (kRecompute ? 0 : 2 * rows * kLdP));
  }
};

// Shared memory of the tensor-core dkv kernel: the block's v rows (later each
// warp's dV and dK tiles) and, recomputing, its k rows; two stages of q and
// of dO (kDkvTile queries each); from P, two stages of kDkvTile query rows x
// the block's keys; and two stages of those queries' delta (and row max and
// 1 / sum) in f32.
template <int DP, bool kRecompute>
struct DkvTcSmem {
  static constexpr int kLd = DP + tc::kPad;
  static constexpr int kLdP = tc::kMaxWarps * tc::kWarpRows + tc::kPad;
  static constexpr int kStats = kRecompute ? 3 : 1;
  static constexpr size_t bytes(int warps) {
    const int rows = warps * tc::kWarpRows;
    return sizeof(tc::bf16) * ((kRecompute ? 2 : 1) * rows * kLd + 4 * kDkvTile * kLd +
                               (kRecompute ? 0 : 2 * kDkvTile * kLdP)) +
           sizeof(float) * 2 * kStats * kDkvTile;
  }
};

// The log2-domain scores of a tile, scaled in f32 after the product: keys >=
// n_valid at -1e30 as the reference, keys past N out of the row (-inf).
template <int NT>
__device__ __forceinline__ void scale_and_mask(float (&s)[NT][4], int k0, int t, int n, int n_valid, float q_mul) {
  if (k0 + NT * 8 <= n_valid) {  // every key of the tile is real and unmasked
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= q_mul;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key >= n ? -INFINITY : key >= n_valid ? tc::kMaskValue : s[j][e] * q_mul;
    }
  }
}

// dq kernel: a warp per 16 query rows, up to 8 warps a block (tc::split_rows);
// loops over tiles of kDqTile keys. Recomputing: pass 0 finds the row max and sum (as
// the forward's pass 1). Pass 1: delta = rowsum(P o dP). Pass 2: dS = P o
// (dP - delta), dQ += dS . k (dS split into bf16 hi + lo). P is recomputed
// from S = q . k^T in f32 (not rounded), or read from the stash.
template <int DP, bool kRecompute>
__global__ void __launch_bounds__(tc::kMaxWarps * 32) attention_bwd_dq_tc_kernel(Args a) {
  using namespace tc;
  constexpr int kLd = DqTcSmem<DP, kRecompute>::kLd;
  constexpr int kLdP = DqTcSmem<DP, kRecompute>::kLdP;
  constexpr int kNT = kDqTile / 8;
  constexpr int kFirst = kRecompute ? 0 : 1;  // passes kFirst..2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5, rows = warps * kWarpRows;
  bf16* dos = reinterpret_cast<bf16*>(smem_raw);       // [rows][kLd]
  bf16* qs = dos + rows * kLd;                         // [rows][kLd], recompute
  bf16* ks = qs + (kRecompute ? rows * kLd : 0);       // [2][kDqTile][kLd]
  bf16* vs = ks + 2 * kDqTile * kLd;                     // [2][kDqTile][kLd]
  bf16* ps = vs + 2 * kDqTile * kLd;                     // [2][rows][kLdP], from P

  const int n = a.n, d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m_block = blockIdx.x * rows;
  const int m0 = m_block + warp * kWarpRows;
  const bool active = m0 < n;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const bf16* k_src = a.k.head<const bf16>(b, h);
  const bf16* v_src = a.v.head<const bf16>(b, h);
  const bf16* p_src = static_cast<const bf16*>(a.p) + (bh * n + m_block) * n;  // from P
  bf16* do_w = dos + warp * kWarpRows * kLd;
  const bf16* q_w = qs + warp * kWarpRows * kLd;

  const int tiles = (n + kDqTile - 1) / kDqTile;
  const int stages = (3 - kFirst) * tiles;
  auto load = [&](int i) {
    const int pass = kFirst + i / tiles, k0 = (i % tiles) * kDqTile, buf = i & 1;
    if (kRecompute || pass == 2) {
      stage(ks + buf * kDqTile * kLd, kLd, k_src + k0 * a.k.sn, a.k.sn, kDqTile, DP, n - k0, d, a.k.aligned);
    }
    if (pass >= 1) {
      stage(vs + buf * kDqTile * kLd, kLd, v_src + k0 * a.v.sn, a.v.sn, kDqTile, DP, n - k0, d, a.v.aligned);
    }
    if (!kRecompute) {
      stage(ps + buf * rows * kLdP, kLdP, p_src + k0, n, rows, kDqTile, n - m_block, n - k0, a.p_aligned);
    }
  };
  stage(dos, kLd, a.dout.head<const bf16>(b, h) + m_block * a.dout.sn, a.dout.sn, rows, DP, n - m_block, d,
        a.dout.aligned);
  if (kRecompute) {
    stage(qs, kLd, a.q.head<const bf16>(b, h) + m_block * a.q.sn, a.q.sn, rows, DP, n - m_block, d,
          a.q.aligned);
  }
  load(0);
  cp_async_commit();

  float m_loc[2] = {-INFINITY, -INFINITY}, l_loc[2] = {0.f, 0.f};  // rows g, g + 8
  float m_row[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
  float dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; i < stages; ++i) {
    if (i + 1 < stages) {
      load(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int pass = kFirst + i / tiles, k0 = (i % tiles) * kDqTile, buf = i & 1;
    if (kRecompute && i == tiles) {  // the row's max and 1 / sum over its four lanes
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = m_loc[r];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = m_loc[r] == -INFINITY ? 0.f : l_loc[r] * exp2f(m_loc[r] - m);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        m_row[r] = m;
        inv_l[r] = 1.f / l;
      }
    }
    if (pass == 2 && k0 == 0) {  // delta is complete: sum the four lanes, write the row stats
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 1);
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 2);
        const int row = m0 + g + 8 * r;
        if (t == 0 && row < n) {
          a.delta[bh * n + row] = dlt[r];
          if (kRecompute) {
            a.row_m[bh * n + row] = m_row[r];
            a.row_il[bh * n + row] = inv_l[r];
          }
        }
      }
    }
    if (active) {
      const bf16* kt = ks + buf * kDqTile * kLd;
      float s[kNT][4];  // scores, then P
      if (kRecompute) {
        product_nt<DP, kNT>(s, q_w, kt, kLd, lane);
        scale_and_mask<kNT>(s, k0, t, n, a.n_valid, a.q_mul);
      }
      if (kRecompute && pass == 0) {  // running max and sum of exp2 of this thread's keys
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int j = 0; j < kNT; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
          const float m_new = fmaxf(m_loc[r], tmax);
          if (m_new != -INFINITY) {
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kNT; ++j) sum += exp2f(s[j][2 * r] - m_new) + exp2f(s[j][2 * r + 1] - m_new);
            l_loc[r] = l_loc[r] * exp2f(m_loc[r] - m_new) + sum;
            m_loc[r] = m_new;
          }
        }
      } else {
        if (kRecompute) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m_row[e >> 1]) * inv_l[e >> 1];
          }
        } else {
          const bf16* pt = ps + buf * rows * kLdP + warp * kWarpRows * kLdP;
#pragma unroll
          for (int kk = 0; kk < kDqTile / 16; ++kk) {
            uint32_t pa[4];
            ldmatrix_x4(pa, pt + a_row(lane) * kLdP + kk * 16 + a_col(lane));
            c_from_a(s[2 * kk], s[2 * kk + 1], pa);
          }
        }
        float dp[kNT][4];  // dP = dO . v^T, then dS
        product_nt<DP, kNT>(dp, do_w, vs + buf * kDqTile * kLd, kLd, lane);
        if (pass == 1) {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dlt[e >> 1] = fmaf(s[j][e], dp[j][e], dlt[e >> 1]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dlt[e >> 1]);
          }
#pragma unroll
          for (int kk = 0; kk < kDqTile / 16; ++kk) {
            uint32_t hi[4], lo[4];
            a_from_c_split(hi, lo, dp[2 * kk], dp[2 * kk + 1]);
            accumulate_tn<DP, true>(dq, hi, lo, kt, kLd, kk, lane);
          }
        }
      }
    }
    __syncthreads();  // this stage's buffers are free for stage i + 2
  }

  if (active) {  // dQ * scale through the warp's dO rows, then out
    c_to_smem<DP / 8>(do_w, kLd, dq, a.scale, lane);
    __syncwarp();
    unstage(a.dq.head<bf16>(b, h) + m0 * a.dq.sn, a.dq.sn, do_w, kLd, min(kWarpRows, n - m0), d, DP,
            a.dq.aligned, lane, 32);
  }
}

// dkv kernel: a warp per 16 key rows, up to 8 warps a block; loops over
// tiles of kDkvTile queries with the delta (and row max and 1 / sum) that the dq kernel
// wrote. S^T = k . q^T (recompute) and dP^T = v . dO^T put key rows in the
// accumulators, so P^T and dS^T are A fragments of dV += P^T . dO and
// dK += dS^T . q with dO and q through ldmatrix.trans. Recomputed P^T and
// dS^T are split into bf16 hi + lo; the stashed P is bf16 already.
template <int DP, bool kRecompute>
__global__ void __launch_bounds__(tc::kMaxWarps * 32) attention_bwd_dkv_tc_kernel(Args a) {
  using namespace tc;
  using Smem = DkvTcSmem<DP, kRecompute>;
  constexpr int kLd = Smem::kLd;
  constexpr int kLdP = Smem::kLdP;
  constexpr int kNT = kDkvTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5, rows = warps * kWarpRows;
  bf16* vs_own = reinterpret_cast<bf16*>(smem_raw);       // [rows][kLd]
  bf16* ks_own = vs_own + rows * kLd;                     // [rows][kLd], recompute
  bf16* qs = ks_own + (kRecompute ? rows * kLd : 0);      // [2][kDkvTile][kLd]
  bf16* dos = qs + 2 * kDkvTile * kLd;                       // [2][kDkvTile][kLd]
  bf16* pts = dos + 2 * kDkvTile * kLd;                      // [2][kDkvTile][kLdP], from P
  float* st = reinterpret_cast<float*>(pts + (kRecompute ? 0 : 2 * kDkvTile * kLdP));  // [2][kStats][kDkvTile]

  const int n = a.n, d = a.d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_block = blockIdx.x * rows;
  const int n0 = n_block + warp * kWarpRows;  // this warp's first key
  const bool active = n0 < n;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t bh = static_cast<int64_t>(b) * a.heads + h;
  const bf16* q_src = a.q.head<const bf16>(b, h);
  const bf16* do_src = a.dout.head<const bf16>(b, h);
  const bf16* p_src = static_cast<const bf16*>(a.p) + bh * n * n + n_block;  // from P
  bf16* v_w = vs_own + warp * kWarpRows * kLd;
  const bf16* k_w = ks_own + warp * kWarpRows * kLd;

  const int tiles = (n + kDkvTile - 1) / kDkvTile;
  auto load = [&](int i) {
    const int q0 = i * kDkvTile, buf = i & 1;
    stage(qs + buf * kDkvTile * kLd, kLd, q_src + q0 * a.q.sn, a.q.sn, kDkvTile, DP, n - q0, d, a.q.aligned);
    stage(dos + buf * kDkvTile * kLd, kLd, do_src + q0 * a.dout.sn, a.dout.sn, kDkvTile, DP, n - q0, d,
          a.dout.aligned);
    if (!kRecompute) {
      stage(pts + buf * kDkvTile * kLdP, kLdP, p_src + static_cast<int64_t>(q0) * n, n, kDkvTile, rows, n - q0,
            n - n_block, a.p_aligned);
    }
    for (int idx = threadIdx.x; idx < Smem::kStats * kDkvTile; idx += blockDim.x) {
      const int which = idx / kDkvTile, qq = idx - which * kDkvTile;
      const float* src = which == 0 ? a.delta : which == 1 ? a.row_m : a.row_il;
      const bool in = q0 + qq < n;  // 0 past N: 1 / sum = 0 gives those queries no probability
      cp_async4(st + buf * Smem::kStats * kDkvTile + idx, in ? src + bh * n + q0 + qq : a.delta, in ? 4 : 0);
    }
  };
  stage(vs_own, kLd, a.v.head<const bf16>(b, h) + n_block * a.v.sn, a.v.sn, rows, DP, n - n_block, d,
        a.v.aligned);
  if (kRecompute) {
    stage(ks_own, kLd, a.k.head<const bf16>(b, h) + n_block * a.k.sn, a.k.sn, rows, DP, n - n_block, d,
          a.k.aligned);
  }
  load(0);
  cp_async_commit();

  float dv[DP / 8][4], dk[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
  }

  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      load(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int buf = i & 1;
      const bf16* qt = qs + buf * kDkvTile * kLd;
      const bf16* dot = dos + buf * kDkvTile * kLd;
      const float* st_delta = st + buf * Smem::kStats * kDkvTile;
      float p[kNT][4];  // P^T: key rows g, g + 8 of the warp; query columns
      if (kRecompute) {
        const float* st_m = st_delta + kDkvTile;
        const float* st_il = st_m + kDkvTile;
        product_nt<DP, kNT>(p, k_w, qt, kLd, lane);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qq = j * 8 + 2 * t + (e & 1);
            const int key = n0 + g + 8 * (e >> 1);
            p[j][e] = key < a.n_valid ? exp2f(p[j][e] * a.q_mul - st_m[qq]) * st_il[qq] : 0.f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < kDkvTile / 16; ++kk) {  // dV += P^T . dO
          uint32_t hi[4], lo[4];
          a_from_c_split(hi, lo, p[2 * kk], p[2 * kk + 1]);
          accumulate_tn<DP, true>(dv, hi, lo, dot, kLd, kk, lane);
        }
      } else {
        const bf16* pt = pts + buf * kDkvTile * kLdP + warp * kWarpRows;
#pragma unroll
        for (int kk = 0; kk < kDkvTile / 16; ++kk) {  // P^T fragments straight from the [query][key] tile
          uint32_t pa[4];
          ldmatrix_x4_trans(pa, pt + (kk * 16 + b_row(lane)) * kLdP + b_col(lane));
          c_from_a(p[2 * kk], p[2 * kk + 1], pa);
          accumulate_tn<DP, false>(dv, pa, pa, dot, kLd, kk, lane);  // dV += P^T . dO
        }
      }
      float ds[kNT][4];  // dP^T = v . dO^T, then dS^T
      product_nt<DP, kNT>(ds, v_w, dot, kLd, lane);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - st_delta[j * 8 + 2 * t + (e & 1)]);
      }
#pragma unroll
      for (int kk = 0; kk < kDkvTile / 16; ++kk) {  // dK += dS^T . q
        uint32_t hi[4], lo[4];
        a_from_c_split(hi, lo, ds[2 * kk], ds[2 * kk + 1]);
        accumulate_tn<DP, true>(dk, hi, lo, qt, kLd, kk, lane);
      }
    }
    __syncthreads();  // this stage's buffers are free for stage i + 2
  }

  if (active) {  // dV, then dK * scale, through the warp's v rows
    const int keys = min(kWarpRows, n - n0);
    c_to_smem<DP / 8>(v_w, kLd, dv, 1.f, lane);
    __syncwarp();
    unstage(a.dv.head<bf16>(b, h) + n0 * a.dv.sn, a.dv.sn, v_w, kLd, keys, d, DP, a.dv.aligned, lane, 32);
    __syncwarp();
    c_to_smem<DP / 8>(v_w, kLd, dk, a.scale, lane);
    __syncwarp();
    unstage(a.dk.head<bf16>(b, h) + n0 * a.dk.sn, a.dk.sn, v_w, kLd, keys, d, DP, a.dk.aligned, lane, 32);
  }
}

template <int DP, bool kRecompute>
cudaError_t launch_tc(const Args& a, int b, cudaStream_t stream) {
  using Dq = DqTcSmem<DP, kRecompute>;
  using Dkv = DkvTcSmem<DP, kRecompute>;
  const tc::Split sp = tc::split_rows(a.n);
  const dim3 grid(sp.blocks, a.heads, b);
  cudaError_t err = launch_one(attention_bwd_dq_tc_kernel<DP, kRecompute>, Dq::bytes(tc::kMaxWarps),
                               Dq::bytes(sp.warps), grid, sp.warps * 32, a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(attention_bwd_dkv_tc_kernel<DP, kRecompute>, Dkv::bytes(tc::kMaxWarps),
                    Dkv::bytes(sp.warps), grid, sp.warps * 32, a, stream);
}

template <bool kRecompute>
cudaError_t dispatch_dim_tc(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch_tc<32, kRecompute>(a, b, stream);
  if (a.d <= 64) return launch_tc<64, kRecompute>(a, b, stream);
  if (a.d <= 80) return launch_tc<80, kRecompute>(a, b, stream);
  return launch_tc<128, kRecompute>(a, b, stream);
}

// float32 -> the CUDA-core kernels, bfloat16 -> the tensor-core kernels.
int run(Args a, int b, int dtype, void* stream) {
  if (b < 1 || b > 65535 || a.n < 1 || a.heads < 1 || a.heads > 65535 || a.d < 1 || a.d > 128 ||
      a.n_valid < 1 || a.n_valid > a.n || a.delta == nullptr ||
      (a.p == nullptr && (a.row_m == nullptr || a.row_il == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool recompute = a.p == nullptr;
  switch (dtype) {
    case 0:
      return static_cast<int>(recompute ? dispatch_dim<true>(a, b, s) : dispatch_dim<false>(a, b, s));
    case 1:
      for (View* v : {&a.q, &a.k, &a.v, &a.dout, &a.dq, &a.dk, &a.dv}) tc::mark_aligned(*v, a.d);
      a.p_aligned = reinterpret_cast<uintptr_t>(a.p) % 16 == 0 && a.n % 8 == 0;
      return static_cast<int>(recompute ? dispatch_dim_tc<true>(a, b, s) : dispatch_dim_tc<false>(a, b, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

size_t elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// qkv: [b, n, 3 * heads * head_dim], dout: [b, n, heads * head_dim], dqkv:
// [b, n, 3 * heads * head_dim], p: [b, heads, n, n] (the forward's stash) or
// NULL to recompute the probabilities; all contiguous, of `dtype` (0:
// float32, 1: bfloat16), on the current device. delta: f32 [b, heads, n]
// scratch; row_m and row_il: f32 [b, heads, n] scratch, needed only when p is
// NULL. q_mul = head_dim**-0.5 * log2(e), scale = head_dim**-0.5, inv_log2e =
// 1 / log2(e). Launches the dq kernel, then the dkv kernel, on `stream`.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int vdk_fused_qkv_attention_bwd(const void* qkv, const void* p, const void* dout,
                                           void* dqkv, float* delta, float* row_m, float* row_il,
                                           int b, int n, int heads, int head_dim, int n_valid,
                                           float q_mul, float scale, float inv_log2e, int dtype,
                                           void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * head_dim;
  const int64_t rs = 3 * c;  // row stride of the packed buffers
  const size_t col = c * elem_bytes(dtype);
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  const Args a{{in, n * rs, head_dim, rs},
               {in + col, n * rs, head_dim, rs},
               {in + 2 * col, n * rs, head_dim, rs},
               {dout, n * c, head_dim, c},
               {out, n * rs, head_dim, rs},
               {out + col, n * rs, head_dim, rs},
               {out + 2 * col, n * rs, head_dim, rs},
               p, delta, row_m, row_il, n, heads, head_dim, n_valid, q_mul, scale, inv_log2e};
  return run(a, b, dtype, stream);
}

// q, k, v, dout: [b, heads, n, head_dim] with element strides (sb, sh, sn) each
// and a unit-stride head dim; dq, dk, dv: [b, heads, n, head_dim] contiguous;
// all of `dtype` (0: float32, 1: bfloat16), on the current device. delta,
// row_m, row_il: f32 [b, heads, n] scratch. Recomputes P (no stash, no key
// mask). q_mul, scale and inv_log2e as above. Launches the dq kernel, then
// the dkv kernel, on `stream`. Returns the CUDA error code of the launches
// (0 on success).
extern "C" int vdk_vision_attention_bwd(
    const void* q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
    const void* k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
    const void* v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
    const void* dout, int64_t do_sb, int64_t do_sh, int64_t do_sn,
    void* dq, void* dk, void* dv, float* delta, float* row_m, float* row_il,
    int b, int n, int heads, int head_dim, float q_mul, float scale, float inv_log2e, int dtype,
    void* stream) {
  const int64_t nd = static_cast<int64_t>(n) * head_dim;
  const Args a{{q, q_sb, q_sh, q_sn},
               {k, k_sb, k_sh, k_sn},
               {v, v_sb, v_sh, v_sn},
               {dout, do_sb, do_sh, do_sn},
               {dq, heads * nd, nd, head_dim},
               {dk, heads * nd, nd, head_dim},
               {dv, heads * nd, nd, head_dim},
               nullptr, delta, row_m, row_il, n, heads, head_dim, n, q_mul, scale, inv_log2e};
  return run(a, b, dtype, stream);
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
