// Fused attention, backward, for Hopper (sm_90a): two stride-generic kernels
// (dq, then dk and dv) behind two entries, in two variants.
//
// (K1b, K1r) vdk_fused_qkv_attention_bwd: (qkv [B, N, 3C], dO [B, N, C], P)
// -> dqkv [B, N, 3C]. Replaces the Pallas TPU kernels of
// visiondk_tpu/ops/pallas/attention.py::_fused_vjp_bwd:
// _fused_bwd_from_p_kernel (the default, which reads the probabilities the
// forward stashed) and _fused_bwd_kernel (the recompute backward, chosen by
// VDK_ATTN_NO_PCACHE=1). Same layout contract as the forward: q, k, v are
// read by strides out of the packed [B, N, 3C] buffer, dO out of [B, N, C],
// and dq, dk, dv are written into the column blocks of dqkv (q at h*d, k at
// C + h*d, v at 2C + h*d) in the input dtype.
//
// (K3r) vdk_vision_attention_bwd: (q, k, v, dO [B, H, N, D]) -> dq, dk, dv
// [B, H, N, D]. Replaces visiondk_tpu/ops/pallas/attention.py::_bwd_kernel
// (launched by _attn_bwd_padded, the custom VJP of vision_attention), the
// recompute variant of the same kernels: q, k, v and dO are read through any
// (batch, head, token) strides with a unit-stride head dim, dq, dk and dv
// are written to three contiguous [B, H, N, D] buffers, n_valid = N (no
// padding: the JAX wrapper's padded keys do not exist here). P is recomputed
// in f32 and not rounded, as the reference's is. The reference computes
// dS = P o (dP - delta) * scale, dQ = dS . k, dK = dS^T . q from exp-domain
// scores; the recompute variant below applies the same scale in another
// place (log2 domain, see dK) and agrees within f32 rounding.
//
// Math, per (b, h), as the reference does it (attention.py:286-320, 343-369),
// all in f32 from upcast operands:
//   from P:     P = the stash, upcast (masked keys hold 0)
//   recompute:  S = (q * scale * log2(e)) . k^T, keys >= n_valid -> -1e30,
//               P = exp2(S - rowmax) * (1 / rowsum), NOT rounded
//   dV = P^T . dO        dP = dO . V^T        delta = rowsum(P o dP)
//   dS = P o (dP - delta)
//   dQ = dS . (k * scale)
//   dK = dS^T . (q * scale)            (from P)
//   dK = (dS^T . (q * scale * log2(e))) / log2(e)   (recompute, as the reference)
// delta is rowsum(P o dP) from the same P, never rowsum(dO o O): the two
// differ once O is rounded to bf16. dQ applies `scale` after the sum over
// keys instead of to every k (a last-bit difference from the reference).
//
// Structure. The Pallas kernel holds a (row, head)'s whole N x N block in
// VMEM and runs its grid in order; here blocks are tiled and run in
// parallel, so dQ (a sum over keys) and dK, dV (sums over queries) come from
// two kernels, with no atomics, so every run gives the same bits:
//   (a) dq kernel, one block per (32 query rows, head, batch row). It loops
//       over 64-key tiles twice: once for delta, once for dS and dQ. The
//       recompute variant first makes one more pass for the row max and sum
//       of exp2 (as the forward's pass 1), and writes them with delta.
//   (b) dkv kernel, one block per (32 key rows, head, batch row). It loops
//       over 64-query tiles, forms dP again and dS from P and the delta that
//       (a) wrote, and accumulates dV and dK.
// Both run on the same stream, so (b) sees (a)'s delta.
//
// What bounds it. On the H100 the least time is set by bytes: at ViT-B/16
// (bs 128, bf16) the recompute variant reads q, k, v and dO and writes dq,
// dk and dv once, 271 MB (81 us at 3.35 TB/s), against 38 GFLOP of products
// (38 us at the bf16 tensor-core peak); from P it also reads the 119 MB
// stash (390 MB, 117 us). The work is products of depth 64 over the
// B*H*N^2 (query, key) pairs: the reference needs 4 (from P) or 5
// (recompute); these kernels do 6 (from P: dP three times, dQ, dV, dK) or
// 10 (recompute: S four times besides), on CUDA cores out of shared memory,
// as the forward does, so those products bound them here, far above the
// bytes. The P stash is read three times, in rows of neighbouring keys.
// What the design does: shared memory is sized by the tile, not by N, so
// any N works; the dS tile never leaves the SM; no [B, H, N, N] scratch is
// written; K3r shares every line of K1r's kernels, so the two cannot drift.
// Tensor-core products and one fused kernel with a cross-block reduction
// are later work.
//
// Threads: 128 per block. Thread t owns row t / 4 of the block's 32 rows and,
// within every 64-column tile, the columns (t % 4) + 4j, j < 16; for the
// products into [rows, d] it owns the dims (t % 4) + 4i. The four threads of
// a row are adjacent lanes, so row reductions are two xor-shuffles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;                          // rows a block owns
constexpr int kTile = 64;                          // columns per inner tile
constexpr int kLanesPerRow = kThreads / kRows;     // 4
constexpr int kColsPerLane = kTile / kLanesPerRow;  // 16
constexpr float kMaskValue = -1e30f;               // the reference's key mask

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

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

// A [B, H, N, d] operand seen through element strides of its batch row, head
// and token; the head dim has unit stride.
struct View {
  const void* ptr;
  int64_t sb, sh, sn;
  template <typename T>
  __device__ __forceinline__ T* head(int b, int h) const {
    return static_cast<T*>(const_cast<void*>(ptr)) + b * sb + h * sh;
  }
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
cudaError_t launch_one(Kernel kernel, size_t bytes, dim3 grid, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP, bool kRecompute>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const dim3 grid((a.n + kRows - 1) / kRows, a.heads, b);
  cudaError_t err = launch_one(attention_bwd_dq_kernel<T, DP, kRecompute>,
                               DqSmem<DP, kRecompute>::kBytes, grid, a, stream);
  if (err != cudaSuccess) return err;
  return launch_one(attention_bwd_dkv_kernel<T, DP, kRecompute>,
                    DkvSmem<DP, kRecompute>::kBytes, grid, a, stream);
}

template <typename T, bool kRecompute>
cudaError_t dispatch_dim(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32, kRecompute>(a, b, stream);
  if (a.d <= 64) return launch<T, 64, kRecompute>(a, b, stream);
  return launch<T, 128, kRecompute>(a, b, stream);
}

template <typename T>
cudaError_t dispatch_variant(const Args& a, int b, cudaStream_t stream) {
  if (a.p == nullptr) return dispatch_dim<T, true>(a, b, stream);
  return dispatch_dim<T, false>(a, b, stream);
}

int run(const Args& a, int b, int dtype, void* stream) {
  if (b < 1 || b > 65535 || a.n < 1 || a.heads < 1 || a.heads > 65535 || a.d < 1 || a.d > 128 ||
      a.n_valid < 1 || a.n_valid > a.n || a.delta == nullptr ||
      (a.p == nullptr && (a.row_m == nullptr || a.row_il == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_variant<float>(a, b, s));
    case 1:
      return static_cast<int>(dispatch_variant<__nv_bfloat16>(a, b, s));
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
