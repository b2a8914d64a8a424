// Fused window attention, backward: (qkv [B, H, W, 3C], dO [B, H, W, C], P)
// -> (dqkv [B, H, W, 3C], dbias [heads, N, N] f32), for Hopper (sm_90a), in
// two variants.
//
// Replaces the Pallas TPU kernels of visiondk_tpu/ops/pallas/window_attention.py::
// _wattn_vjp_bwd: _wattn_bwd_from_p_kernel (:350-396; K2b, the default,
// which reads the probabilities the forward stashed) and _wattn_bwd_kernel
// (:293-347; K2r, the recompute backward, chosen by VDK_ATTN_NO_PCACHE=1).
// Same layout contract as the forward: row r of window (wy, wx) is pixel
// (wy*ws + r / ws, wx*ws + r % ws); q, k, v are read by strides out of
// [B, H, W, 3C], dO out of [B, H, W, C], and dq, dk, dv are written to the
// same pixel's column blocks of dqkv (q at h*d, k at C + h*d, v at 2C + h*d)
// in the input dtype.
//
// Math, per (window, head, batch row), as the reference does it
// (window_attention.py:293-396), in f32 from the input dtype's values:
//   from P:     P = the stash (the region mask is implicit in it)
//   recompute:  S = (q . k^T) * scale * log2(e) + bias_h * log2(e)
//               [+ -100 * log2(e) across regions],
//               P = exp2(S - rowmax) * (1 / rowsum), NOT rounded
//   dV = P^T . dO        dP = dO . V^T        delta = rowsum(P o dP)
//   dS = P o (dP - delta)                      (the gradient of the scores)
//   dQ = (dS . k) * scale     dK = (dS^T . q) * scale   (q unscaled, in both)
//   dbias = sum of dS over every window and batch row
// The recompute variant applies scale * log2(e) to q . k^T after the sum
// where the reference scales q first (a last-bit difference in S).
//
// Structure. A window is tiny (Swin: N = 49, d = 32), so one block forms
// dQ, dK and dV of a whole (window, head) with none of the cross-block split
// that attention over long sequences needs. Only the bias gradient is summed
// across windows, and it must be the same bits on every run, so there are
// no atomics: each block takes one head and a fixed run of `per_chunk`
// consecutive windows (in batch-row-major order) and walks them in order;
// the thread that owns (query r, key j) of the tile adds dS[r, j] to its own
// register, so a block's sum has a fixed order; the block writes its
// partial to dbias_part [n_chunks, heads, N, N]; a second small kernel sums
// the partials over chunks in chunk order.
//
// What bounds it on the H100: bytes. At Swin-B stage 0 (bs 80, 56^2, 4
// heads, d 32, bf16) the backward from P reads qkv, dO and the 98 MB stash
// and writes dqkv, 548.0 MB (0.164 ms at 3.35 TB/s), against 12.6 GFLOP of
// products (0.013 ms at the bf16 tensor-core peak); the recompute variant
// moves 449.7 MB (0.134 ms) for 15.7 GFLOP.
//
// bfloat16 (the main path): tensor cores. The first design (the f32 kernel
// below, once also bf16's) ran every product on CUDA cores from f32 shared
// memory, one shared-memory load per multiply-add, and walked its windows
// one after another, each a synchronous load and two barriers: the issue of
// shared-memory instructions and the latency of each window's loads, not
// the bytes, set its time (6.6% and 9.9% of the bound on the H100). This
// design:
//   - a window's rows and keys are padded to 64 = four 16-row MMA tiles, one
//     warp each (4 warps a block); every product is mma.sync m16n8k16 (bf16
//     in, f32 accumulation) on fragments from ldmatrix. Rows and keys past N
//     are never stored: their ldmatrix addresses read row N - 1 (finite
//     values), and P and dS are set to 0 there, so they reach neither dqkv
//     nor dbias.
//   - phase A, per warp and its 16 query rows: dP = dO . V^T and (recompute)
//     S = q . k^T in C fragments, P (stash or softmax), delta, dS, dQ += dS .
//     k with dS as A fragments packed from the C fragments (FA2's register
//     trick). The warp writes P and dS to padded [64][72] bf16 tiles.
//   - one barrier; phase B, per warp and its 16 keys: dV += P^T . dO and
//     dK += dS^T . q with P^T and dS^T as A fragments by ldmatrix.trans of
//     those tiles, dO and q by ldmatrix.trans of theirs.
//   - a ring of two stages over the block's run of windows: window t + 1's
//     q, k, v, dO (64-byte head slices at 16-byte offsets, cp.async of 16
//     bytes) and its stash tile arrive while window t computes; two barriers
//     a window.
//   - the stash tile of 49 x 49 bf16 starts on a 2-byte boundary and its
//     98-byte rows are never 16-byte aligned, so cp.async cannot place its
//     rows into the padded layout ldmatrix needs. Each stage copies the
//     tile's enclosing 16-byte-aligned range raw (cp.async, zero-filled past
//     the end of the stash); phase A reads each thread's P values from there
//     at its fragment positions and writes them to the padded P tile with
//     the dS tile, so the stash costs no extra barrier and no synchronous
//     load (tc::stage's element-by-element path would be one a window).
//   - rounding: dS, and the recomputed P, are f32 in the reference; one bf16
//     rounding of them would break a quarter of chip_smoke.py's bar
//     (tests/test_torch_port_window_rounding.py), so they are split into
//     bf16 hi + lo = bf16(x - hi) and multiplied twice; the stashed P is bf16
//     already and multiplies once. Scale multiplies dQ and dK after the sum.
//   - 4 warps and about 67 KB of shared memory at d 32: three blocks an SM
//     from P, two recomputing; the wrapper sizes the runs of windows so that
//     one wave of blocks covers the call. A deeper ring (3 or 4 stages at two
//     blocks an SM) and dK, dV staged through shared memory for 16-byte
//     stores were both slower on the H100.
//   - each thread's pixel offsets (row r of a window is r / ws rows and
//     r % ws columns from its first pixel) are divided out once per block:
//     runtime divisions in every window's loads and stores cost 7% of the
//     time on the H100.
//
// float32: the first design's CUDA-core kernel, kept for the f32 bars (dqkv
// 1e-4, the one-step train comparison at 1e-5 loss); TF32 products would not
// hold them. 256 threads per block; in the first phase thread t owns query row
// t / 4 and keys (t % 4) + 4j, j < 16, as the forward; in the second it owns
// row t / 4 as a query (dQ) and as a key (dK, dV), and the dims (t % 4) + 4i.
// A bf16 tensor never reaches it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int kMaxN = 64;  // ws <= 8
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -144.26950408889634f;  // -100 * log2(e), the reference's region mask

struct Args {
  const void* qkv;     // [B, H, W, 3C]
  const float* bias;   // [heads, N, N] (recompute)
  const int* ids;      // [nW, N] region ids, or NULL (recompute, unshifted)
  const void* p;       // [B, nW, heads, N, N] stash, or NULL (recompute)
  const void* dout;    // [B, H, W, C]
  void* dqkv;          // [B, H, W, 3C]
  float* dbias_part;   // [n_chunks, heads, N, N]
  int h_img, w_img, heads, d, ws, n, n_win_x, n_win, total, per_chunk;
  float q_mul;  // scale * log2(e)
  float scale;
  int aligned;  // bf16: qkv, dout and dqkv start on 16 bytes, d and C multiples of 8
};

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kLanesPerRow = kThreads / kMaxN;      // 4
constexpr int kColsPerLane = kMaxN / kLanesPerRow;  // 16

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory in floats: q, k, v, dO [N][DP + 1], P and dS [N][N + 1],
// then N ints of region ids.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (4 * n * (DP + 1) + 2 * n * (n + 1)) + sizeof(int) * n;
}

template <int DP, bool kMasked, bool kRecompute>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_kernel(Args a) {
  constexpr int ld = DP + 1;
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, ws = a.ws;
  const int lp = n + 1;
  float* qs = smem;  // q, unscaled
  float* ks = qs + n * ld;
  float* vs = ks + n * ld;
  float* dos = vs + n * ld;
  float* ps = dos + n * ld;  // P[query][key]
  float* dss = ps + n * lp;  // dS[query][key]
  int* id_s = reinterpret_cast<int*>(dss + n * lp);

  const int chunk = blockIdx.x;
  const int h = blockIdx.y;
  const int c = a.heads * d;
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const float* qkv = static_cast<const float*>(a.qkv);
  const float* dout = static_cast<const float*>(a.dout);
  float* dqkv = static_cast<float*>(a.dqkv);

  const int r = threadIdx.x / kLanesPerRow;
  const int g = threadIdx.x % kLanesPerRow;
  const bool live = r < n;
  const int rr = live ? r : n - 1;  // idle rows read a real row and discard it
  constexpr int kDimsPerLane = DP / kLanesPerRow;

  float db[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) db[j] = 0.f;

  const int t0 = chunk * a.per_chunk;
  const int t1 = min(t0 + a.per_chunk, a.total);
  for (int t = t0; t < t1; ++t) {
    const int b = t / a.n_win;
    const int w = t - b * a.n_win;
    const int wy = w / a.n_win_x;
    const int wx = w - wy * a.n_win_x;
    auto pixel = [&](int row) -> int64_t {
      const int ry = row / ws;
      return (static_cast<int64_t>(b) * a.h_img + wy * ws + ry) * a.w_img + wx * ws + (row - ry * ws);
    };

    __syncthreads();  // the previous window's readers are done
    for (int idx = threadIdx.x; idx < n * DP; idx += kThreads) {
      const int row = idx / DP;
      const int cc = idx - row * DP;
      float qv = 0.f, kv = 0.f, vv = 0.f, dv = 0.f;
      if (cc < d) {
        const int64_t px = pixel(row);
        const float* src = qkv + px * row_stride + h * d + cc;
        qv = src[0];
        kv = src[c];
        vv = src[2 * c];
        dv = dout[px * c + h * d + cc];
      }
      qs[row * ld + cc] = qv;
      ks[row * ld + cc] = kv;
      vs[row * ld + cc] = vv;
      dos[row * ld + cc] = dv;
    }
    if (!kRecompute) {
      const float* p_tile = static_cast<const float*>(a.p) +
                            ((static_cast<int64_t>(b) * a.n_win + w) * a.heads + h) * n * n;
      for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int pr = idx / n;
        ps[pr * lp + idx - pr * n] = p_tile[idx];
      }
    }
    if (kRecompute && kMasked) {
      for (int row = threadIdx.x; row < n; row += kThreads) {
        id_s[row] = a.ids[static_cast<int64_t>(w) * n + row];
      }
    }
    __syncthreads();

    // Phase 1: this thread's P[r, key], dP = dO . V^T and dS, keys g + 4j.
    float pv[kColsPerLane], dp[kColsPerLane], s[kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) dp[j] = s[j] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < DP; ++kd) {
      const float x = dos[rr * ld + kd];
      const float q = kRecompute ? qs[rr * ld + kd] : 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = min(g + j * kLanesPerRow, n - 1);
        dp[j] = fmaf(x, vs[key * ld + kd], dp[j]);
        if (kRecompute) s[j] = fmaf(q, ks[key * ld + kd], s[j]);
      }
    }
    if (kRecompute) {
      const float* bias_row = a.bias + (static_cast<int64_t>(h) * n + rr) * n;
      const int my_id = kMasked ? id_s[rr] : 0;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = g + j * kLanesPerRow;
        if (key < n) {
          float sj = s[j] * a.q_mul + bias_row[key] * kLog2e;
          if (kMasked && id_s[key] != my_id) sj += kMaskValue;
          s[j] = sj;
          m = fmaxf(m, sj);
        }
      }
      m = row_max(m);
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = g + j * kLanesPerRow;
        pv[j] = key < n ? exp2f(s[j] - m) : 0.f;
        l += pv[j];
      }
      const float inv_l = 1.f / row_sum(l);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) pv[j] *= inv_l;
    } else {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = g + j * kLanesPerRow;
        pv[j] = key < n ? ps[rr * lp + key] : 0.f;
      }
    }
    float delta = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) delta = fmaf(pv[j], dp[j], delta);
    delta = row_sum(delta);
    if (live) {
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = g + j * kLanesPerRow;
        if (key < n) {
          const float ds = pv[j] * (dp[j] - delta);
          db[j] += ds;
          dss[r * lp + key] = ds;
          if (kRecompute) ps[r * lp + key] = pv[j];
        }
      }
    }
    __syncthreads();

    // Phase 2: dQ[r] = scale * sum_x dS[r, x] k[x]; dK[r] = scale * sum_x
    // dS[x, r] q[x]; dV[r] = sum_x P[x, r] dO[x].
    if (live) {
      float aq[kDimsPerLane], ak[kDimsPerLane], av[kDimsPerLane];
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) aq[i] = ak[i] = av[i] = 0.f;
      for (int x = 0; x < n; ++x) {
        const float ds_q = dss[r * lp + x];
        const float ds_k = dss[x * lp + r];
        const float p_k = ps[x * lp + r];
        const float* krow = ks + x * ld;
        const float* qrow = qs + x * ld;
        const float* dorow = dos + x * ld;
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) {
          const int dd = g + i * kLanesPerRow;
          aq[i] = fmaf(ds_q, krow[dd], aq[i]);
          ak[i] = fmaf(ds_k, qrow[dd], ak[i]);
          av[i] = fmaf(p_k, dorow[dd], av[i]);
        }
      }
      float* dst = dqkv + pixel(r) * row_stride + h * d;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int dd = g + i * kLanesPerRow;
        if (dd < d) {
          dst[dd] = aq[i] * a.scale;
          dst[c + dd] = ak[i] * a.scale;
          dst[2 * c + dd] = av[i];
        }
      }
    }
  }

  if (live) {
    float* part = a.dbias_part + ((static_cast<int64_t>(chunk) * a.heads + h) * n + r) * n;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int key = g + j * kLanesPerRow;
      if (key < n) part[key] = db[j];
    }
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int kTcWarps = 4;                    // one per 16-row tile of a window padded to 64
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kNP = kTcWarps * tc::kWarpRows;  // 64: a window's rows and keys, padded
constexpr int kNT = kNP / 8;                   // n-tiles of 8 keys
constexpr int kLdT = kNP + tc::kPad;           // row stride of the P and dS tiles
static_assert(kLanesPerRow == 4, "row_max and row_sum also reduce the four lanes of an MMA fragment row");

// Shared memory of the tensor-core kernel, in this order: the P tile (the
// stash's values, or the recomputed P's hi) [kNP][kLdT], recomputing its lo
// [kNP][kLdT], dS hi and lo [kNP][kLdT] (all bf16, rows and keys past N
// written as 0 every window); two stages of q, k, v, dO [N][DP + 8] bf16;
// from P, two stages of the raw stash range; with shift regions, two stages
// of the window's region ids [kNP] int.
template <int DP, bool kMasked, bool kRecompute>
struct TcSmem {
  static constexpr int kLd = DP + tc::kPad;
  static constexpr int kTiles = kRecompute ? 4 : 3;
  // elements of one stage's operands, and bf16 elements of one stage's raw
  // stash copy: the n * n values and up to 7 before them, in 16-byte pieces
  __host__ __device__ static constexpr int ops(int n) { return 4 * n * kLd; }
  __host__ __device__ static constexpr int raw(int n) { return kRecompute ? 0 : (n * n + 7 + 7) / 8 * 8; }
  static constexpr size_t bytes(int n) {
    return sizeof(tc::bf16) * (kTiles * kNP * kLdT + 2 * (ops(n) + raw(n))) + (kMasked ? sizeof(int) * 2 * kNP : 0);
  }
};

// The first element of the stash tile of window t (batch-row-major), head h.
__device__ __forceinline__ const tc::bf16* stash_tile(const Args& a, int t, int h) {
  return static_cast<const tc::bf16*>(a.p) + (static_cast<int64_t>(t) * a.heads + h) * a.n * a.n;
}

// The first pixel (row 0) of window t, as a row index of [B * H * W].
__device__ __forceinline__ int64_t window_base(const Args& a, int t) {
  const int b = t / a.n_win, w = t - b * a.n_win;
  const int wy = w / a.n_win_x, wx = w - wy * a.n_win_x;
  return (static_cast<int64_t>(b) * a.h_img + wy * a.ws) * a.w_img + wx * a.ws;
}

// Blocks an SM: three from P at head dim 32 (161 registers a thread); two
// recomputing (255; capped for three it spilled and was 4% slower on the
// H100) and at head dim 64. The wrapper sizes its runs of windows to match.
template <int DP, bool kMasked, bool kRecompute>
__global__ void __launch_bounds__(kTcThreads, DP <= 32 && !kRecompute ? 3 : 2)
    window_attention_bwd_tc_kernel(Args a) {
  using namespace tc;
  using Smem = TcSmem<DP, kMasked, kRecompute>;
  constexpr int kLd = Smem::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = a.d, ws = a.ws, c = a.heads * d;
  bf16* p_hi = reinterpret_cast<bf16*>(smem_raw);
  bf16* p_lo = p_hi + kNP * kLdT;  // recompute only
  bf16* ds_hi = p_hi + (Smem::kTiles - 2) * kNP * kLdT;
  bf16* ds_lo = ds_hi + kNP * kLdT;
  bf16* ops = ds_lo + kNP * kLdT;
  bf16* raw = ops + 2 * Smem::ops(n);                           // from P
  int* ids_s = reinterpret_cast<int*>(raw + 2 * Smem::raw(n));  // shifted windows

  const int chunk = blockIdx.x, h = blockIdx.y;
  const int t0 = chunk * a.per_chunk;
  const int count = min(a.per_chunk, a.total - t0);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  bf16* dqkv = static_cast<bf16*>(a.dqkv);
  const bf16* p_end = kRecompute ? nullptr : stash_tile(a, a.total, 0);

  // A window's row r is the pixel `base + (r / ws) * w_img + r % ws` of its
  // first pixel `base`. The divisions are made once per block: each thread
  // keeps the offsets of the rows it loads (16-byte column lc of rows lr +
  // kRowStep k) and of the two fragment rows it stores.
  constexpr int kChunks = DP / 8, kRowStep = kTcThreads / kChunks, kRowLoads = kNP / kRowStep;
  const int lc = (threadIdx.x % kChunks) * 8, lr = threadIdx.x / kChunks;
  auto pixel_offset = [&](int r) { return (r / ws) * a.w_img + r % ws; };
  int load_px[kRowLoads];
#pragma unroll
  for (int k = 0; k < kRowLoads; ++k) load_px[k] = pixel_offset(lr + kRowStep * k);

  // Window t0 + i into stage i & 1: q, k, v, dO rows [0, n) with zeros past
  // d; the raw stash range; the region ids.
  auto load = [&](int i) {
    const int t = t0 + i, s = i & 1;
    const int64_t base = window_base(a, t);
    bf16* dst = ops + s * Smem::ops(n) + lc;
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int r = lr + kRowStep * k;
      if (r >= n) break;
      const int64_t px = base + load_px[k];
#pragma unroll
      for (int op = 0; op < 4; ++op) {
        const bf16* src = (op < 3 ? qkv + px * row_stride + op * c : dout + px * c) + h * d + lc;
        bf16* to = dst + (op * n + r) * kLd;
        if (a.aligned) {
          const bool in = lc < d;
          cp_async16(to, in ? src : qkv, in ? 16 : 0);
        } else {
          uint32_t wv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c0 = lc + 2 * e;
            const uint32_t x0 = c0 < d ? __bfloat16_as_ushort(src[2 * e]) : 0u;
            const uint32_t x1 = c0 + 1 < d ? __bfloat16_as_ushort(src[2 * e + 1]) : 0u;
            wv[e] = x0 | (x1 << 16);
          }
          *reinterpret_cast<uint4*>(to) = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
      }
    }
    if (kMasked) {
      const int w = t % a.n_win;
      for (int r = threadIdx.x; r < n; r += kTcThreads) {
        cp_async4(ids_s + s * kNP + r, a.ids + static_cast<int64_t>(w) * n + r, 4);
      }
    }
    if (!kRecompute) {  // the 16-byte pieces that hold the tile, none past the stash
      const bf16* tile = stash_tile(a, t, h);
      const uintptr_t from = reinterpret_cast<uintptr_t>(tile) & ~static_cast<uintptr_t>(15);
      const int pieces = static_cast<int>((reinterpret_cast<uintptr_t>(tile + n * n) - from + 15) / 16);
      for (int k = threadIdx.x; k < pieces; k += kTcThreads) {
        const uintptr_t src = from + 16 * static_cast<uintptr_t>(k);
        const uintptr_t left = reinterpret_cast<uintptr_t>(p_end) - src;
        cp_async16(raw + s * Smem::raw(n) + 8 * k, reinterpret_cast<const void*>(src),
                   left < 16 ? static_cast<int>(left) : 16);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = warp * kWarpRows;  // this warp's 16 query rows (phase A) and keys (phase B)
  const int store_px[2] = {pixel_offset(row0 + g), pixel_offset(row0 + g + 8)};

  // Rows row0 + g and row0 + g + 8 of a warp's 16 x DP C tiles, times mul,
  // into column block blk (0: q, 1: k, 2: v) of their pixels in dqkv.
  auto store = [&](const float (&acc)[DP / 8][4], float mul, int blk, int64_t base) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + g + 8 * r >= n) continue;
      bf16* dst = dqkv + (base + store_px[r]) * row_stride + blk * c + h * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * tq;
        const float x0 = acc[j][2 * r] * mul, x1 = acc[j][2 * r + 1] * mul;
        if (a.aligned) {
          if (col < d) *reinterpret_cast<uint32_t*>(dst + col) = pack(x0, x1);
        } else {
          if (col < d) dst[col] = __float2bfloat16(x0);
          if (col + 1 < d) dst[col + 1] = __float2bfloat16(x1);
        }
      }
    }
  };

  float db[kNT][4];  // this thread's dbias entries: rows row0 + g (+ 8), keys 8j + 2tq (+ 1)
#pragma unroll
  for (int j = 0; j < kNT; ++j) db[j][0] = db[j][1] = db[j][2] = db[j][3] = 0.f;

  load(0);
  cp_async_commit();
  for (int i = 0; i < count; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // window i has arrived, and every warp is done with window i - 1
    if (i + 1 < count) {
      load(i + 1);  // into window i - 1's stage
      cp_async_commit();
    }
    const int t = t0 + i, s = i & 1;
    const int64_t base = window_base(a, t);
    const bf16* qs = ops + s * Smem::ops(n);
    const bf16* ks = qs + n * kLd;
    const bf16* vs = ks + n * kLd;
    const bf16* dos = vs + n * kLd;

    // Phase A: the warp's 16 query rows over all 64 keys.
    float pv[kNT][4], dp[kNT][4];  // P, then dP and dS; C fragments
    if (kRecompute) {  // P first, so that the scores and dP are never live together
      product_nt_rows<DP, kNT>(pv, qs, row0, ks, kLd, n, lane);  // q . k^T
      const float* bias_h = a.bias + static_cast<int64_t>(h) * n * n;
      const int* ids = ids_s + s * kNP;
      int rowc[2], id_row[2];
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rowc[r] = min(row0 + g + 8 * r, n - 1);  // rows past N: row N - 1's scores, then P = 0
        id_row[r] = kMasked ? ids[rowc[r]] : 0;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + 2 * tq + (e & 1), r = e >> 1;
          float x = -INFINITY;  // keys past N: out of the row
          if (key < n) {
            x = pv[j][e] * a.q_mul + __ldg(bias_h + rowc[r] * n + key) * kLog2e;
            if (kMasked && ids[key] != id_row[r]) x += kMaskValue;
          }
          pv[j][e] = x;
          m[r] = fmaxf(m[r], x);
        }
      }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) m[r] = row_max(m[r]);  // over the four lanes of a fragment row
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[j][e] = exp2f(pv[j][e] - m[e >> 1]);
          l[e >> 1] += pv[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sum = row_sum(l[r]);  // every lane of the warp takes part in the shuffles
        l[r] = row0 + g + 8 * r < n ? 1.f / sum : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[j][e] *= l[e >> 1];
      }
    } else {  // the stash, from its raw range
      const bf16* tile = stash_tile(a, t, h);
      const bf16* pr = raw + s * Smem::raw(n) + ((reinterpret_cast<uintptr_t>(tile) & 15) >> 1);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + 2 * tq + (e & 1), row = row0 + g + 8 * (e >> 1);
          pv[j][e] = row < n && key < n ? __bfloat162float(pr[row * n + key]) : 0.f;
        }
      }
    }
    product_nt_rows<DP, kNT>(dp, dos, row0, vs, kLd, n, lane);  // dP = dO . V^T
    float dlt[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dlt[e >> 1] = fmaf(pv[j][e], dp[j][e], dlt[e >> 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) dlt[r] = row_sum(dlt[r]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[j][e] = pv[j][e] * (dp[j][e] - dlt[e >> 1]);  // dS: 0 where P is
        db[j][e] += dp[j][e];
      }
    }
    // P and dS (bf16 hi + lo where f32) to the tiles; dQ += dS . k
    float dq[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
    const int ra = (row0 + g) * kLdT + 2 * tq, rb = ra + 8 * kLdT;  // the fragment's two rows
#pragma unroll
    for (int kk = 0; kk < kNP / 16; ++kk) {
      uint32_t hi[4], lo[4];
      if (kRecompute) {
        a_from_c_split(hi, lo, pv[2 * kk], pv[2 * kk + 1]);
        *reinterpret_cast<uint32_t*>(p_lo + ra + kk * 16) = lo[0];
        *reinterpret_cast<uint32_t*>(p_lo + rb + kk * 16) = lo[1];
        *reinterpret_cast<uint32_t*>(p_lo + ra + kk * 16 + 8) = lo[2];
        *reinterpret_cast<uint32_t*>(p_lo + rb + kk * 16 + 8) = lo[3];
      } else {
        a_from_c(hi, pv[2 * kk], pv[2 * kk + 1]);  // bf16 values: exact
      }
      *reinterpret_cast<uint32_t*>(p_hi + ra + kk * 16) = hi[0];
      *reinterpret_cast<uint32_t*>(p_hi + rb + kk * 16) = hi[1];
      *reinterpret_cast<uint32_t*>(p_hi + ra + kk * 16 + 8) = hi[2];
      *reinterpret_cast<uint32_t*>(p_hi + rb + kk * 16 + 8) = hi[3];
      a_from_c_split(hi, lo, dp[2 * kk], dp[2 * kk + 1]);
      *reinterpret_cast<uint32_t*>(ds_hi + ra + kk * 16) = hi[0];
      *reinterpret_cast<uint32_t*>(ds_hi + rb + kk * 16) = hi[1];
      *reinterpret_cast<uint32_t*>(ds_hi + ra + kk * 16 + 8) = hi[2];
      *reinterpret_cast<uint32_t*>(ds_hi + rb + kk * 16 + 8) = hi[3];
      *reinterpret_cast<uint32_t*>(ds_lo + ra + kk * 16) = lo[0];
      *reinterpret_cast<uint32_t*>(ds_lo + rb + kk * 16) = lo[1];
      *reinterpret_cast<uint32_t*>(ds_lo + ra + kk * 16 + 8) = lo[2];
      *reinterpret_cast<uint32_t*>(ds_lo + rb + kk * 16 + 8) = lo[3];
      accumulate_tn_rows<DP, true>(dq, hi, lo, ks, kLd, kk, n, lane);
    }
    store(dq, a.scale, 0, base);
    __syncthreads();  // the P and dS tiles are complete

    // Phase B: the warp's 16 keys over all 64 queries.
    if (row0 < n) {
      float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
        dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kNP / 16; ++kk) {
        const int at = (kk * 16 + b_row(lane)) * kLdT + row0 + b_col(lane);  // [query][key] -> A of the transpose
        uint32_t hi[4], lo[4];
        ldmatrix_x4_trans(hi, p_hi + at);
        if (kRecompute) ldmatrix_x4_trans(lo, p_lo + at);
        accumulate_tn_rows<DP, kRecompute>(dv, hi, kRecompute ? lo : hi, dos, kLd, kk, n, lane);  // dV += P^T . dO
        ldmatrix_x4_trans(hi, ds_hi + at);
        ldmatrix_x4_trans(lo, ds_lo + at);
        accumulate_tn_rows<DP, true>(dk, hi, lo, qs, kLd, kk, n, lane);  // dK += dS^T . q
      }
      store(dk, a.scale, 1, base);
      store(dv, 1.f, 2, base);
    }
  }

  float* part = a.dbias_part + (static_cast<int64_t>(chunk) * a.heads + h) * n * n;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * tq + (e & 1), row = row0 + g + 8 * (e >> 1);
      if (row < n && key < n) part[row * n + key] = db[j][e];
    }
  }
}

// ---------------------------------------------------------------- launches

// dbias[i] = sum over chunks k, in order, of part[k][i].
__global__ void __launch_bounds__(kSumThreads)
    dbias_sum_kernel(const float* __restrict__ part, float* __restrict__ dbias, int n_chunks,
                     int count) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= count) return;
  float sum = 0.f;
  for (int k = 0; k < n_chunks; ++k) sum += part[static_cast<int64_t>(k) * count + i];
  dbias[i] = sum;
}

// The backward kernel on a grid of (chunk, head), then the dbias sum.
template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, size_t bytes, const Args& a, float* dbias,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.total + a.per_chunk - 1) / a.per_chunk;
  kernel<<<dim3(n_chunks, a.heads), threads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = a.heads * a.n * a.n;
  dbias_sum_kernel<<<(count + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      a.dbias_part, dbias, n_chunks, count);
  return cudaGetLastError();
}

template <int DP, bool kMasked, bool kRecompute>
cudaError_t launch_f32(const Args& a, float* dbias, cudaStream_t stream) {
  return launch(window_attention_bwd_kernel<DP, kMasked, kRecompute>, kThreads, smem_bytes<DP>(a.n), a,
                dbias, stream);
}

template <int DP, bool kMasked, bool kRecompute>
cudaError_t launch_tc(const Args& a, float* dbias, cudaStream_t stream) {
  auto kernel = window_attention_bwd_tc_kernel<DP, kMasked, kRecompute>;
  // as much of the SM's memory as shared memory as it takes for three blocks
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch(kernel, kTcThreads, TcSmem<DP, kMasked, kRecompute>::bytes(a.n), a, dbias, stream);
}

// float32 -> the CUDA-core kernel, bfloat16 -> the tensor-core kernel; DP is
// the head-dim bucket, then the variant: from P, recompute with shift
// regions, recompute without.
template <int DP>
cudaError_t dispatch(const Args& a, float* dbias, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    if (a.p != nullptr) return launch_f32<DP, false, false>(a, dbias, s);
    if (a.ids != nullptr) return launch_f32<DP, true, true>(a, dbias, s);
    return launch_f32<DP, false, true>(a, dbias, s);
  }
  if (a.p != nullptr) return launch_tc<DP, false, false>(a, dbias, s);
  if (a.ids != nullptr) return launch_tc<DP, true, true>(a, dbias, s);
  return launch_tc<DP, false, true>(a, dbias, s);
}

}  // namespace

// qkv: [b, h_img, w_img, 3 * heads * head_dim], dout: [b, h_img, w_img, heads *
// head_dim], dqkv: like qkv, p: [b, nW, heads, ws^2, ws^2] (the forward's
// stash) or NULL to recompute the probabilities from bias (f32 [heads, ws^2,
// ws^2]) and ids (int32 [nW, ws^2] region ids, or NULL for unshifted
// windows); qkv, dout, dqkv and p of `dtype` (0: float32, 1: bfloat16), all
// contiguous, on the current device. dbias_part: f32 [ceil(b * nW /
// per_chunk), heads, ws^2, ws^2] scratch; dbias: f32 [heads, ws^2, ws^2].
// q_mul = scale * log2(e). Takes ws <= 8 and head_dim <= 64. Launches the
// backward kernel, then the dbias sum, on `stream`. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int vdk_fused_window_attention_bwd(const void* qkv, const float* bias, const int* ids,
                                              const void* p, const void* dout, void* dqkv,
                                              float* dbias_part, float* dbias, int b, int h_img,
                                              int w_img, int heads, int head_dim, int ws,
                                              int per_chunk, float q_mul, float scale, int dtype,
                                              void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || head_dim < 1 || head_dim > 64 ||
      ws < 1 || ws * ws > kMaxN || h_img < ws || w_img < ws || h_img % ws || w_img % ws ||
      per_chunk < 1 || dbias_part == nullptr || dbias == nullptr ||
      (p == nullptr && bias == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_win_x = w_img / ws;
  const int n_win = (h_img / ws) * n_win_x;
  const int c = heads * head_dim;
  const int aligned = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dqkv) % 16 == 0 && head_dim % 8 == 0 && c % 8 == 0;
  const Args a{qkv,   bias,  ids,   p,        dout,    dqkv,  dbias_part, h_img,     w_img,
               heads, head_dim, ws, ws * ws, n_win_x, n_win, b * n_win,  per_chunk, q_mul,
               scale, aligned};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = head_dim <= 32 ? dispatch<32>(a, dbias, dtype, s) : dispatch<64>(a, dbias, dtype, s);
  return static_cast<int>(err);
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
