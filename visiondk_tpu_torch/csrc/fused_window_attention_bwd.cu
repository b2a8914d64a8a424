// Fused window attention, backward: (qkv [B, H, W, 3C], dO [B, H, W, C], P)
// -> (dqkv [B, H, W, 3C], dbias [heads, N, N] f32), for Hopper (sm_90a), in
// two variants.
//
// Replaces the Pallas TPU kernels of visiondk_tpu/ops/pallas/window_attention.py::
// _wattn_vjp_bwd: _wattn_bwd_from_p_kernel (:350-396; K2b, the default,
// which reads the probabilities the forward stashed) and _wattn_bwd_kernel
// (:293-347; K2r, the recompute backward, chosen by VDK_ATTN_NO_PCACHE=1).
// Same layout contract as the forward: row r of window (wy, wx) is pixel
// (wy*ws + r / ws, wx*ws + r % ws), or for shifted windows (shift s > 0) the
// pixel ((wy*ws + r / ws + s) mod H, (wx*ws + r % ws + s) mod W) (window_tc.cuh);
// q, k, v are read by strides out of [B, H, W, 3C], dO out of [B, H, W, C],
// and dq, dk, dv are written to the same pixel's column blocks of dqkv (q at
// h*d, k at C + h*d, v at 2C + h*d) in the input dtype. kShifted marks the
// shifted windows' variants: recomputing, they mask across shift regions; from
// P (whose mask is in the stash) they only wrap their addresses.
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
//     time on the H100. Shifted windows wrap them with two compares a row,
//     once a window.
//
// float32: the first design's CUDA-core kernel, kept for the f32 bars (dqkv
// 1e-4, the one-step train comparison at 1e-5 loss); TF32 products would not
// hold them. 256 threads per block; in the first phase thread t owns query row
// t / 4 and keys (t % 4) + 4j, j < 16, as the forward; in the second it owns
// row t / 4 as a query (dQ) and as a key (dK, dV), and the dims (t % 4) + 4i.
// A bf16 tensor never reaches it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC --split-compile=0 (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "window_tc.cuh"

namespace {

constexpr int kMaxN = 64;  // ws <= 8 on the bodies below; larger windows on the tiled ones
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -144.26950408889634f;  // -100 * log2(e), the reference's region mask

struct Args {
  const void* qkv;     // [B, H, W, 3C]
  const float* bias;   // [heads, N, N] (recompute)
  const int* ids;      // [nW, N] region ids, or NULL (from P; recompute, unshifted)
  const void* p;       // [B, nW, heads, N, N] stash, or NULL (recompute)
  const void* dout;    // [B, H, W, C]
  void* dqkv;          // [B, H, W, 3C]
  float* dbias_part;   // [n_chunks, heads, N, N]
  int h_img, w_img, heads, d, ws, n, n_win_x, n_win, total, per_chunk;
  int shift;    // the cyclic shift s of shifted windows (0 where the caller rolled the map)
  float q_mul;  // scale * log2(e)
  float scale;
  int aligned;  // bf16: qkv, dout and dqkv start on 16 bytes, d and C multiples of 8
  float* stats;   // N > 64: [3][B * nW, heads, N] delta, row max, 1 / row sum (the last two recomputing)
  int p_aligned;  // bf16, N > 64: the stash's rows start on 16 bytes
};

// Window t (batch-row-major) of the call: its first pixel and, shifted, where
// its rows wrap.
template <bool kShifted>
__device__ __forceinline__ wtc::WindowWalk<kShifted> window_at(const Args& a, int t) {
  return wtc::WindowWalk<kShifted>(t, a.n_win, a.n_win_x, a.ws, a.h_img, a.w_img, a.shift);
}

// Row r of a window, as a row index of [B * H * W] (one division: the f32
// bodies' and the tiled bodies' stores).
template <bool kShifted>
__device__ __forceinline__ int64_t window_row(const Args& a, const wtc::WindowWalk<kShifted>& win, int r) {
  return win.base + win.at(wtc::row_offset<kShifted>(r, a.ws, a.w_img), a.h_img * a.w_img, a.w_img);
}

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

template <int DP, bool kShifted, bool kRecompute>
__global__ void __launch_bounds__(kThreads) window_attention_bwd_kernel(Args a) {
  constexpr int ld = DP + 1;
  extern __shared__ float smem[];
  const int n = a.n, d = a.d;
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
    const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
    const int b = t / a.n_win, w = win.w;
    auto pixel = [&](int row) -> int64_t { return window_row(a, win, row); };

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
    if (kRecompute && kShifted) {
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
      const int my_id = kShifted ? id_s[rr] : 0;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = g + j * kLanesPerRow;
        if (key < n) {
          float sj = s[j] * a.q_mul + bias_row[key] * kLog2e;
          if (kShifted && id_s[key] != my_id) sj += kMaskValue;
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
// from P, two stages of the raw stash range; recomputing with shift regions,
// two stages of the window's region ids [kNP] int.
template <int DP, bool kShifted, bool kRecompute>
struct TcSmem {
  static constexpr int kLd = DP + tc::kPad;
  static constexpr int kTiles = kRecompute ? 4 : 3;
  // elements of one stage's operands, and bf16 elements of one stage's raw
  // stash copy: the n * n values and up to 7 before them, in 16-byte pieces
  __host__ __device__ static constexpr int ops(int n) { return 4 * n * kLd; }
  __host__ __device__ static constexpr int raw(int n) { return kRecompute ? 0 : (n * n + 7 + 7) / 8 * 8; }
  static constexpr size_t bytes(int n) {
    return sizeof(tc::bf16) * (kTiles * kNP * kLdT + 2 * (ops(n) + raw(n))) +
           (kShifted && kRecompute ? sizeof(int) * 2 * kNP : 0);
  }
};

// The first element of the stash tile of window t (batch-row-major), head h.
__device__ __forceinline__ const tc::bf16* stash_tile(const Args& a, int t, int h) {
  return static_cast<const tc::bf16*>(a.p) + (static_cast<int64_t>(t) * a.heads + h) * a.n * a.n;
}

// Blocks an SM: three from P at head dim 32 (161 registers a thread); two
// recomputing (255; capped for three it spilled and was 4% slower on the
// H100) and at head dim 64. The wrapper sizes its runs of windows to match.
template <int DP, bool kShifted, bool kRecompute>
__global__ void __launch_bounds__(kTcThreads, DP <= 32 && !kRecompute ? 3 : 2)
    window_attention_bwd_tc_kernel(Args a) {
  using namespace tc;
  using Smem = TcSmem<DP, kShifted, kRecompute>;
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
  // first pixel `base` (shifted: wrapped, window_tc.cuh). The divisions are
  // made once per block: each thread keeps the offsets of the rows it loads
  // (16-byte column lc of rows lr + kRowStep k) and of the two fragment rows
  // it stores.
  constexpr int kChunks = DP / 8, kRowStep = kTcThreads / kChunks, kRowLoads = kNP / kRowStep;
  const int lc = (threadIdx.x % kChunks) * 8, lr = threadIdx.x / kChunks;
  const int hw = a.h_img * a.w_img;
  auto pixel_offset = [&](int r) { return wtc::row_offset<kShifted>(r, ws, a.w_img); };
  int load_px[kRowLoads];
#pragma unroll
  for (int k = 0; k < kRowLoads; ++k) load_px[k] = pixel_offset(lr + kRowStep * k);

  // Window t0 + i into stage i & 1: q, k, v, dO rows [0, n) with zeros past
  // d; the raw stash range; the region ids.
  auto load = [&](int i) {
    const int t = t0 + i, s = i & 1;
    const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
    bf16* dst = ops + s * Smem::ops(n) + lc;
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int r = lr + kRowStep * k;
      if (r >= n) break;
      const int64_t px = win.base + win.at(load_px[k], hw, a.w_img);
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
    if (kShifted && kRecompute) {
      for (int r = threadIdx.x; r < n; r += kTcThreads) {
        cp_async4(ids_s + s * kNP + r, a.ids + static_cast<int64_t>(win.w) * n + r, 4);
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
  auto store = [&](const float (&acc)[DP / 8][4], float mul, int blk, const wtc::WindowWalk<kShifted>& win) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + g + 8 * r >= n) continue;
      bf16* dst = dqkv + (win.base + win.at(store_px[r], hw, a.w_img)) * row_stride + blk * c + h * d;
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
    const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
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
        id_row[r] = kShifted ? ids[rowc[r]] : 0;
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + 2 * tq + (e & 1), r = e >> 1;
          float x = -INFINITY;  // keys past N: out of the row
          if (key < n) {
            x = pv[j][e] * a.q_mul + __ldg(bias_h + rowc[r] * n + key) * kLog2e;
            if (kShifted && ids[key] != id_row[r]) x += kMaskValue;
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
    store(dq, a.scale, 0, win);
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
      store(dk, a.scale, 1, win);
      store(dv, 1.f, 2, win);
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

// ---------------------------------------------------------------- windows of N > 64
//
// ws 9 to 16 (N up to 256). Replaces the same Pallas kernels for those
// windows (K2b: _wattn_bwd_from_p_kernel, window_attention.py:350-396; K2r:
// _wattn_bwd_kernel, :293-347). A whole (window, head) no longer fits one
// block: at N = 256 its P and dS tiles alone are 384 KB in bf16 hi + lo. So
// these bodies take the structure of the fused QKV backward for long
// sequences (fused_qkv_attention_bwd.cu): two kernels on the same stream, no
// atomics.
//   (a) dq kernel, per run of 64 query rows: P (the stash, or recomputed from
//       the scores, bias and mask), delta = rowsum(P o dP), dS, dQ += dS . k;
//       it writes delta (and, recomputing, the row max and 1 / sum) per
//       (window, head, row) to `stats`, and carries the bias gradient.
//   (b) dkv kernel, per run of 64 keys: P^T (from the stash, or recomputed
//       with the stats that (a) wrote), dP^T, dS^T, dV += P^T . dO and
//       dK += dS^T . q.
// Both take one head, a run of 64 rows (4 warps of 16) and a fixed run of
// `per_chunk` windows in batch-row-major order, on the same grid; the wrapper
// sizes the runs so that one wave of two blocks an SM covers the call.
//
// What bounds it on the H100: bytes by the roofline. At SwinV2-L stage 0 (bs
// 32, 64^2, 6 heads, d 32, bf16) the backward from P reads qkv, dO and the
// 403 MB stash and writes dqkv: 757 MB (0.226 ms at 3.35 TB/s), against 51.5
// GFLOP of its four products (0.052 ms at the bf16 tensor-core peak); the
// recompute variant moves 356 MB (0.106 ms) for 64.4 GFLOP. In practice, as
// in the forward, the rate of instructions for the per-score work at 8 warps
// an SM (each holds a row's 256 scores or probabilities), and the loads of
// each window, which a block makes once the previous window is done.
//
// bfloat16 (the main path). The first design took 1.70 ms (K2b) and 4.15 ms
// (K2r) at stage 0 (PERF.md). This design, against each of its limits:
//   - dbias: the first design kept a [64][N] f32 tile whose rows, at
//     N = 256, put the 8 rows of an MMA fragment in one bank group (an 8-way
//     conflict at every dS) and held it to 2 blocks of 4 warps an SM. Now each
//     thread adds the dS values of its own fragment positions, in window
//     order, to f32 slots in shared memory laid out in fragment order
//     (16-byte pieces, neighbouring lanes side by side: no bank conflict); at
//     the end of its run the block writes its rows of dbias_part, and the
//     fixed-order sum below adds the runs, so dbias is the same bits on every
//     run. Still 64 KB a block: the unpadded, swizzled K and V tiles
//     (window_tc.cuh) are what keep two blocks an SM.
//   - dP twice and the stash read twice: in dq each warp holds P for all 256
//     keys in registers (from P: the stash's bf16 read as 16-byte pieces of
//     each row, straight into the A fragments of the key order; recomputing:
//     each score formed once, 128 f32 a thread, with the bias read as 16-byte
//     pieces from L2), so the stash is read once. From P, delta =
//     rowsum(dO o (P . V)), the same sum as rowsum(P o dP) in another order,
//     costs one P . V product, and dP = dO . V^T is formed once, where dS
//     needs it. Recomputing, a P . V product would need P split in hi + lo
//     (two products and the splits); forming dP for delta and again for dS
//     costs less.
//   - three passes and the bias at every score, recomputing: the scores are
//     formed once (as in the forward); dkv reads the bias of its keys once a
//     block into shared memory in fragment order.
//   - dkv's 16 barrier-separated 16-query stages: the window's q and dO (all
//     queries), the block's k and v rows, its columns of the stash and the
//     query stats arrive at once, one barrier, then each warp walks the
//     queries in 16s with none.
//   - as in the forward: 256 keys a window with no bound to test, lane
//     offsets computed once, partial sums for every long accumulation
//     (delta's P . V, dQ, dK, dV), and a __syncwarp() a step where ptxas
//     would otherwise hoist every step's loads and spill (dq; dkv from P);
//     dkv recomputing is unrolled in pairs instead, as unrolled whole it
//     spilled. dq's loads come in two groups, the second arriving during the
//     first phase.
//   - rounding as in the small-window kernel: dS, and the recomputed P, are
//     split into bf16 hi + lo and multiplied twice; the stashed P once.
// Tried on the card and dropped: no fences; dkv recomputing unrolled whole
// and dkv from P in pairs; recomputing, delta through a split P . V
// (chip_smoke.py --tiled-variants times them against this file); with no
// time kept here, both slower: the next window's rows
// prefetched into L2 during the current one, and the element-by-element loads
// moved out of line.
// float32: the fused QKV backward's CUDA-core structure (32 rows a block, 128
// threads, tiles of 64), for the f32 bars.

constexpr int kLargeMaxN = wtc::kMaxN;  // ws <= 16
constexpr int kF32Rows = 32;            // rows a block (f32)
constexpr int kF32Tile = 64;            // columns a tile (f32)
constexpr int kF32Threads = 128;        // four a row
constexpr float kInvLog2e = 0.6931471805599453f;

// A warp's 16-row C tiles (rows row0 + g, + 8 of a window), times mul, into
// column block blk (0: q, 1: k, 2: v) of their pixels in dqkv.
template <int DP, bool kShifted>
__device__ __forceinline__ void store_rows(const Args& a, const wtc::WindowWalk<kShifted>& win, int row0, int h, int blk,
                                           const float (&acc)[DP / 8][4], float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3, c = a.heads * a.d;
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= a.n) continue;
    tc::bf16* dst = static_cast<tc::bf16*>(a.dqkv) + window_row(a, win, row) * row_stride + blk * c + h * a.d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + 2 * tq;
      const float x0 = acc[j][2 * r] * mul, x1 = acc[j][2 * r + 1] * mul;
      if (a.aligned) {
        if (col < a.d) *reinterpret_cast<uint32_t*>(dst + col) = tc::pack(x0, x1);
      } else {
        if (col < a.d) dst[col] = __float2bfloat16(x0);
        if (col + 1 < a.d) dst[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// Shared memory of the bf16 dq kernel: the dbias sum in fragment order (per
// warp and group of 32 keys, 2 row halves x 2 pieces x 32 lanes of float4),
// K and V [256][DP] in the key order (keys past N zeros), the block's dO rows
// and, recomputing, its q rows [64][DP]; the rows' pixel offsets [N] int (row_offset);
// then (shifted, recomputing) the window's region ids [N] int.
template <int DP, bool kShifted, bool kRecompute>
struct DqSmem {
  static constexpr size_t bytes() {
    return sizeof(float4) * wtc::kMaxWarps * wtc::kMaxGroups * 128 +
           sizeof(tc::bf16) * (2 * wtc::kMaxN + (kRecompute ? 2 : 1) * wtc::kRows) * DP +
           sizeof(int) * kLargeMaxN * (kShifted && kRecompute ? 2 : 1);
  }
};

template <int DP, bool kShifted, bool kRecompute>
__global__ void __launch_bounds__(wtc::kThreads, 2) window_attention_dq_tc_kernel(Args a) {
  using namespace tc;
  constexpr int kNT = wtc::kNT, kG = wtc::kMaxGroups, kKeys = wtc::kMaxN, kRows = wtc::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* db_s = reinterpret_cast<float4*>(smem_raw);                            // [4][kG][2][2][32]
  bf16* ks = reinterpret_cast<bf16*>(db_s + wtc::kMaxWarps * kG * 128);         // [256][DP], key order
  bf16* vs = ks + kKeys * DP;                                                    // [256][DP], key order
  bf16* dos = vs + kKeys * DP;                                                   // [64][DP]
  bf16* qs = dos + kRows * DP;                                                   // [64][DP], recompute
  int* off_s = reinterpret_cast<int*>(qs + (kRecompute ? kRows * DP : 0));      // [N]
  int* ids_s = off_s + kLargeMaxN;                                               // [N], shifted

  const int n = a.n, d = a.d, c = a.heads * d;
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int m_block = blockIdx.z * kRows, m0 = m_block + warp * kWarpRows;
  const bool active = m0 < n;
  const int t0 = chunk * a.per_chunk, count = min(a.per_chunk, a.total - t0);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const int64_t stats_n = static_cast<int64_t>(a.total) * a.heads * n;
  const int hw = a.h_img * a.w_img;
  const bf16* src = static_cast<const bf16*>(a.qkv) + h * d;
  const bf16* do_src = static_cast<const bf16*>(a.dout) + h * d;
  const float* bias_h = kRecompute ? a.bias + static_cast<int64_t>(h) * n * n : nullptr;
  const wtc::Lanes<DP> lanes(lane);
  // rows past N take row N - 1's bias and id (finite values, never stored)
  const int rowc[2] = {min(m0 + g, n - 1), min(m0 + g + 8, n - 1)};
  auto own_row = [&](int r) { return m_block + r; };
  auto key_row = [](int r) { return wtc::perm(r); };

  // this thread's dbias slots: ((m * 2 + r) * 2 + jp) * 32 + lane holds keys
  // 32m + 8tq + 4jp .. + 3 of row half r (C tiles 4m + 2jp and 4m + 2jp + 1)
  float4* db_t = db_s + warp * kG * 128 + lane;
  if (active) {
#pragma unroll
    for (int i = 0; i < kG * 4; ++i) db_t[i * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  wtc::fill_offsets<kShifted>(off_s, n, a.ws, a.w_img);

  wtc::WindowWalk<kShifted> walk = window_at<kShifted>(a, t0);  // window t
  for (int i = 0; i < count; ++i, walk.next(a.n_win, a.n_win_x, a.ws, a.h_img, a.w_img, a.shift)) {
    const int t = t0 + i;
    const int64_t base = walk.base;
    const bf16* win = src + base * row_stride;
    auto offset = [&](int r) { return walk.at(off_s[r], hw, a.w_img); };
    __syncthreads();  // every warp is done with window t - 1's tiles (and the offsets are written)
    // two groups: what the first phase reads (recomputing: K, q and ids for
    // the scores; from P: V for delta), then the rest (V; K), which arrives
    // during it
    wtc::stage<DP, kRows>(dos, do_src + base * c, offset, c, own_row, n, d, a.aligned);
    wtc::stage<DP, kKeys>(kRecompute ? ks : vs, win + (kRecompute ? c : 2 * c), offset, row_stride, key_row, n, d,
                          a.aligned);
    if (kRecompute) wtc::stage<DP, kRows>(qs, win, offset, row_stride, own_row, n, d, a.aligned);
    if (kRecompute && kShifted) {
      const int* ids = a.ids + static_cast<int64_t>(walk.w) * n;
      for (int r = threadIdx.x; r < n; r += wtc::kThreads) cp_async4(ids_s + r, ids + r, 4);
    }
    cp_async_commit();
    wtc::stage<DP, kKeys>(kRecompute ? vs : ks, win + (kRecompute ? 2 * c : c), offset, row_stride, key_row, n, d,
                          a.aligned);
    cp_async_commit();

    // from P: the stash's values at this thread's fragment positions, as the
    // A fragments of the key order, loaded while the tiles arrive; 0 past N
    uint32_t pa[kNT / 2][4];
    if (!kRecompute && active) {
      const bf16* ptile = stash_tile(a, t, h);
      if (a.p_aligned) {  // N a multiple of 8: a piece's 8 keys are all < N or all past it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + g + 8 * r;
          const bf16* p = ptile + static_cast<int64_t>(row) * n + 8 * tq;
#pragma unroll
          for (int m = 0; m < kG; ++m) {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (row < n && m * wtc::kGroup + 8 * tq < n) v = __ldg(reinterpret_cast<const uint4*>(p + m * wtc::kGroup));
            wtc::set_p_piece(pa, m, r, v);
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < kG; ++m) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m0 + g + 8 * r, key = m * wtc::kGroup + 8 * tq;
            const bf16* p = ptile + static_cast<int64_t>(row) * n + key;
            uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (row < n && key + e < n) w[e >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(p[e])) << (16 * (e & 1));
            }
            wtc::set_p_piece(pa, m, r, make_uint4(w[0], w[1], w[2], w[3]));
          }
        }
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // the first group has arrived

    uint32_t doa[DP / 16][4];
    float s[kNT][4];  // recomputing: the scores, then P in f32
    float mx[2] = {-INFINITY, -INFINITY}, il[2] = {0.f, 0.f};
    if (active) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(doa[kk], dos + lanes.a[kk] + warp * kWarpRows * DP);
    }
    if (kRecompute && active) {
      uint32_t qa[DP / 16][4];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qa[kk], qs + lanes.a[kk] + warp * kWarpRows * DP);
      bool mixed = false;  // region ids that differ within the window
      int id_row[2] = {0, 0};
      if (kShifted) {
        const int id0 = ids_s[0];
        bool diff = false;
        for (int r = lane; r < n; r += 32) diff |= ids_s[r] != id0;
        mixed = __any_sync(0xffffffffu, diff);
        id_row[0] = ids_s[rowc[0]];
        id_row[1] = ids_s[rowc[1]];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + lanes.b[kk] + np * 16 * DP);
          mma(s[2 * np], qa[kk], kb[0], kb[1]);
          mma(s[2 * np + 1], qa[kk], kb[2], kb[3]);
        }
      }
      // log2-domain scores, scaled after the product, + bias [+ region
      // mask]; keys past N out of the row (-inf); four partial maxima a row
      float mp[2][4] = {{-INFINITY, -INFINITY, -INFINITY, -INFINITY}, {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};
#pragma unroll
      for (int m = 0; m < kG; ++m) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const int key = m * wtc::kGroup + 8 * tq + 4 * jp;
            const float* bp = bias_h + static_cast<int64_t>(rowc[r]) * n + key;
            float bv[4];
            if (n % 4 == 0 && key < n) {  // the piece's 4 keys are all < N
              const float4 b = __ldg(reinterpret_cast<const float4*>(bp));
              bv[0] = b.x * kLog2e, bv[1] = b.y * kLog2e, bv[2] = b.z * kLog2e, bv[3] = b.w * kLog2e;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) bv[e] = key + e < n ? __ldg(bp + e) * kLog2e : -INFINITY;
            }
            const int j = 4 * m + 2 * jp;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = s[j + (e >> 1)][2 * r + (e & 1)];
              x = x * a.q_mul + bv[e];
            }
            if (kShifted && mixed) {
              const int4 v = *reinterpret_cast<const int4*>(ids_s + key);
              const int id[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                if (id[e] != id_row[r]) s[j + (e >> 1)][2 * r + (e & 1)] += kMaskValue;
              }
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) mp[r][e] = fmaxf(mp[r][e], s[j + (e >> 1)][2 * r + (e & 1)]);
          }
        }
      }
      float lp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = row_max(fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3])));
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = wtc::exp2_ftz(s[j][e] - mx[e >> 1]);
          lp[e >> 1][(j & 1) * 2 + (e & 1)] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) il[r] = 1.f / row_sum((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= il[e >> 1];
      }
    }
    if (kRecompute) {
      cp_async_wait<0>();
      __syncthreads();  // V has arrived
    }

    float dlt[2] = {0.f, 0.f};
    if (active && kRecompute) {
      // delta = rowsum(P o dP) over four partial sums a row, dP = dO . V^T 16
      // keys at a time (formed again for dS below: cheaper than a split P . V)
      float dp4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        float dp[2][4];
        wtc::product16<DP>(dp, doa, vs, lanes, kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp4[e >> 1][(e & 1) * 2] = fmaf(s[2 * kk][e], dp[0][e], dp4[e >> 1][(e & 1) * 2]);
          dp4[e >> 1][(e & 1) * 2 + 1] = fmaf(s[2 * kk + 1][e], dp[1][e], dp4[e >> 1][(e & 1) * 2 + 1]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) dlt[r] = (dp4[r][0] + dp4[r][1]) + (dp4[r][2] + dp4[r][3]);
    } else if (active) {
      // delta = rowsum(dO o (P . V)): the sum of rowsum(P o dP) in another
      // order, for one P . V product; over two partial sums
      float o[2][DP / 8][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) o[x][j][0] = o[x][j][1] = o[x][j][2] = o[x][j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        wtc::accumulate<DP, false>(o[kk & 1], pa[kk], pa[kk], vs, lanes, kk);
        __syncwarp();
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        float dl[4], dr[4];  // dO at the C positions of O's tiles 2kk and 2kk + 1
        c_from_a(dl, dr, doa[kk]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dlt[e >> 1] += dl[e] * (o[0][2 * kk][e] + o[1][2 * kk][e]) + dr[e] * (o[0][2 * kk + 1][e] + o[1][2 * kk + 1][e]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dlt[r] = row_sum(dlt[r]);
        const int row = m0 + g + 8 * r;
        if (tq == 0 && row < n) {
          const int64_t at = (static_cast<int64_t>(t) * a.heads + h) * n + row;
          a.stats[at] = dlt[r];
          if (kRecompute) {
            a.stats[stats_n + at] = mx[r];
            a.stats[2 * stats_n + at] = il[r];
          }
        }
      }
    }
    if (!kRecompute) {
      cp_async_wait<0>();
      __syncthreads();  // K has arrived
    }
    if (!active) continue;

    // dS = P o (dP - delta) with dP = dO . V^T, 16 keys at a time; dbias +=
    // dS; dQ += dS . k over two partial sums
    float dq[2][DP / 8][4];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) dq[x][j][0] = dq[x][j][1] = dq[x][j][2] = dq[x][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      float dp[2][4];
      wtc::product16<DP>(dp, doa, vs, lanes, kk);
      float pl[4], pr[4];
      if (kRecompute) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pl[e] = s[2 * kk][e], pr[e] = s[2 * kk + 1][e];
      } else {
        c_from_a(pl, pr, pa[kk]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[0][e] = pl[e] * (dp[0][e] - dlt[e >> 1]);
        dp[1][e] = pr[e] * (dp[1][e] - dlt[e >> 1]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float4* slot = db_t + (((kk >> 1) * 2 + r) * 2 + (kk & 1)) * 32;
        float4 v = *slot;
        v.x += dp[0][2 * r];
        v.y += dp[0][2 * r + 1];
        v.z += dp[1][2 * r];
        v.w += dp[1][2 * r + 1];
        *slot = v;
      }
      uint32_t hi[4], lo[4];
      a_from_c_split(hi, lo, dp[0], dp[1]);
      wtc::accumulate<DP, true>(dq[kk & 1], hi, lo, ks, lanes, kk);
      __syncwarp();  // keeps ptxas from hoisting every step's loads (255 registers and spills without)
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[0][j][e] += dq[1][j][e];
    }
    store_rows<DP>(a, walk, m0, h, 0, dq[0], a.scale, lane);
  }

  if (active) {  // this block's rows of dbias_part [n_chunks, heads, N, N]
    float* part = a.dbias_part + (static_cast<int64_t>(chunk) * a.heads + h) * n * n;
#pragma unroll
    for (int m = 0; m < kG; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int row = m0 + g + 8 * r, key = m * wtc::kGroup + 8 * tq + 4 * jp;
          if (row >= n || key >= n) continue;
          const float4 v = db_t[((m * 2 + r) * 2 + jp) * 32];
          float* dst = part + static_cast<int64_t>(row) * n + key;
          if (n % 4 == 0) {  // the piece's 4 keys are all < N
            *reinterpret_cast<float4*>(dst) = v;
          } else {
            const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (key + e < n) dst[e] = x[e];
            }
          }
        }
      }
    }
  }
}

// Shared memory of the bf16 dkv kernel: recomputing, the bias of the block's
// keys (times log2(e)) in fragment order (per warp and n-tile of 8 queries,
// 2 row halves x 32 lanes of float2); q and dO of all queries [256][DP]
// (queries past N zeros); the block's v and, recomputing, k rows [64][DP];
// from P, the stash's columns of the block's keys [256][64 + 8]; the
// queries' delta (and max and 1 / sum) in f32; the rows' pixel offsets [N]
// int; then (shifted, recomputing) the window's region ids [N] int.
template <int DP, bool kShifted, bool kRecompute>
struct DkvSmem {
  static constexpr int kStats = kRecompute ? 3 : 1;
  static constexpr int kLdP = wtc::kRows + tc::kPad;
  static constexpr size_t bytes() {
    return (kRecompute ? sizeof(float2) * wtc::kMaxWarps * (wtc::kMaxN / 8) * 64 : 0) +
           sizeof(tc::bf16) * ((2 * wtc::kMaxN + (kRecompute ? 2 : 1) * wtc::kRows) * DP +
                               (kRecompute ? 0 : wtc::kMaxN * kLdP)) +
           sizeof(float) * kStats * wtc::kMaxN + sizeof(int) * kLargeMaxN * (kShifted && kRecompute ? 2 : 1);
  }
};

template <int DP, bool kShifted, bool kRecompute>
__global__ void __launch_bounds__(wtc::kThreads, 2) window_attention_dkv_tc_kernel(Args a) {
  using namespace tc;
  using Smem = DkvSmem<DP, kShifted, kRecompute>;
  constexpr int kQ = wtc::kMaxN, kRows = wtc::kRows, kLdP = Smem::kLdP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* bias_s = reinterpret_cast<float2*>(smem_raw);  // recompute: [4][kQ / 8][2][32]
  bf16* qs = reinterpret_cast<bf16*>(bias_s + (kRecompute ? wtc::kMaxWarps * (kQ / 8) * 64 : 0));  // [256][DP]
  bf16* dos = qs + kQ * DP;                              // [256][DP]
  bf16* vs = dos + kQ * DP;                              // [64][DP]
  bf16* ks = vs + kRows * DP;                            // [64][DP], recompute
  bf16* pst = ks + (kRecompute ? kRows * DP : 0);        // [256][kLdP], from P
  float* st = reinterpret_cast<float*>(pst + (kRecompute ? 0 : kQ * kLdP));  // [kStats][256]
  int* off_s = reinterpret_cast<int*>(st + Smem::kStats * kQ);              // [N]
  int* ids_s = off_s + kLargeMaxN;                                          // [N], shifted

  const int n = a.n, d = a.d, c = a.heads * d;
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int n_block = blockIdx.z * kRows, n0 = n_block + warp * kWarpRows;  // the block's and the warp's first key
  const bool active = n0 < n;
  const int t0 = chunk * a.per_chunk, count = min(a.per_chunk, a.total - t0);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const int64_t stats_n = static_cast<int64_t>(a.total) * a.heads * n;
  const int hw = a.h_img * a.w_img;
  const bf16* src = static_cast<const bf16*>(a.qkv) + h * d;
  const bf16* do_src = static_cast<const bf16*>(a.dout) + h * d;
  const wtc::Lanes<DP> lanes(lane);
  const int keyc[2] = {min(n0 + g, n - 1), min(n0 + g + 8, n - 1)};
  const bool key_in[2] = {n0 + g < n, n0 + g + 8 < n};
  auto same_row = [](int r) { return r; };
  auto own_row = [&](int r) { return n_block + r; };

  // recomputing: bias * log2(e) at this thread's fragment positions (key rows
  // g, g + 8; query columns 8j + 2tq, + 1), read and written by this thread
  // alone; queries past N read row N - 1 (their P is set to 0)
  float2* bias_t = bias_s + warp * (kQ / 8) * 64 + lane;
  if (kRecompute && active) {
    const float* bias_h = a.bias + static_cast<int64_t>(h) * n * n;
    for (int j = 0; j < kQ / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = 8 * j + 2 * tq;
        bias_t[(j * 2 + r) * 32] =
            make_float2(__ldg(bias_h + static_cast<int64_t>(min(q, n - 1)) * n + keyc[r]) * kLog2e,
                        __ldg(bias_h + static_cast<int64_t>(min(q + 1, n - 1)) * n + keyc[r]) * kLog2e);
      }
    }
  }
  wtc::fill_offsets<kShifted>(off_s, n, a.ws, a.w_img);

  wtc::WindowWalk<kShifted> walk = window_at<kShifted>(a, t0);  // window t
  for (int i = 0; i < count; ++i, walk.next(a.n_win, a.n_win_x, a.ws, a.h_img, a.w_img, a.shift)) {
    const int t = t0 + i;
    const int64_t base = walk.base;
    const int64_t stats0 = (static_cast<int64_t>(t) * a.heads + h) * n;  // this (window, head)'s rows
    const bf16* win = src + base * row_stride;
    auto offset = [&](int r) { return walk.at(off_s[r], hw, a.w_img); };
    __syncthreads();  // every warp is done with window t - 1's tiles (and the offsets are written)
    wtc::stage<DP, kQ>(qs, win, offset, row_stride, same_row, n, d, a.aligned);
    wtc::stage<DP, kQ>(dos, do_src + base * c, offset, c, same_row, n, d, a.aligned);
    wtc::stage<DP, kRows>(vs, win + 2 * c, offset, row_stride, own_row, n, d, a.aligned);
    if (kRecompute) {
      wtc::stage<DP, kRows>(ks, win + c, offset, row_stride, own_row, n, d, a.aligned);
    } else {  // the stash's columns [n_block, n_block + 64) of every query row, 8 16-byte chunks a row
      const bf16* ptile = stash_tile(a, t, h) + n_block;
      const int ch = threadIdx.x & 7, col = ch * 8, r0 = threadIdx.x >> 3;
      const bool col_in = n_block + col < n;
#pragma unroll 4
      for (int q = r0; q < kQ; q += wtc::kThreads / 8) {
        const bf16* s = ptile + static_cast<int64_t>(q) * n + col;
        bf16* dst = pst + q * kLdP + col;
        if (a.p_aligned) {  // N a multiple of 8: a chunk's 8 keys are all < N or all past it
          const bool in = q < n && col_in;
          cp_async16(dst, in ? s : ptile, in ? 16 : 0);
        } else {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in0 = q < n && n_block + col + 2 * e < n, in1 = q < n && n_block + col + 2 * e + 1 < n;
            w[e] = (in0 ? static_cast<uint32_t>(__bfloat16_as_ushort(s[2 * e])) : 0u) |
                   ((in1 ? static_cast<uint32_t>(__bfloat16_as_ushort(s[2 * e + 1])) : 0u) << 16);
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    for (int idx = threadIdx.x; idx < Smem::kStats * kQ; idx += wtc::kThreads) {
      const int which = idx / kQ, q = idx % kQ;
      const bool in = q < n;  // 0 past N
      cp_async4(st + idx, in ? a.stats + which * stats_n + stats0 + q : a.stats, in ? 4 : 0);
    }
    if (kRecompute && kShifted) {
      const int* ids = a.ids + static_cast<int64_t>(walk.w) * n;
      for (int r = threadIdx.x; r < n; r += wtc::kThreads) cp_async4(ids_s + r, ids + r, 4);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // window t's tiles have arrived
    if (!active) continue;

    const float* st_d = st;
    const float* st_m = st + kQ;
    const float* st_il = st + 2 * kQ;
    uint32_t va[DP / 16][4], ka[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ldmatrix_x4(va[kk], vs + lanes.a[kk] + warp * kWarpRows * DP);
      if (kRecompute) ldmatrix_x4(ka[kk], ks + lanes.a[kk] + warp * kWarpRows * DP);
    }
    bool mixed = false;
    int id_key[2] = {0, 0};
    if (kRecompute && kShifted) {
      const int id0 = ids_s[0];
      bool diff = false;
      for (int r = lane; r < n; r += 32) diff |= ids_s[r] != id0;
      mixed = __any_sync(0xffffffffu, diff);
      id_key[0] = ids_s[keyc[0]];
      id_key[1] = ids_s[keyc[1]];
    }
    // two partial sums each, by the parity of the query tile
    float dv[2][DP / 8][4], dk[2][DP / 8][4];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        dv[x][j][0] = dv[x][j][1] = dv[x][j][2] = dv[x][j][3] = 0.f;
        dk[x][j][0] = dk[x][j][1] = dk[x][j][2] = dk[x][j][3] = 0.f;
      }
    }
    // queries [16 qc, 16 qc + 16) into the partial sums of qc's parity
    auto tile = [&](int qc) {
      float p[2][4];  // P^T: key rows g, g + 8 of the warp; query columns
      if (kRecompute) {
        wtc::product16<DP>(p, ka, qs, lanes, qc);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // queries q0, q0 + 1: their max, 1 / sum and ids side by side (ids
          // past N are stale, but so is nothing their P of 0 reaches)
          const int q0 = qc * 16 + 8 * hh + 2 * tq;
          const float2 m2 = *reinterpret_cast<const float2*>(st_m + q0);
          const float2 il2 = *reinterpret_cast<const float2*>(st_il + q0);
          const int2 id2 = kShifted ? *reinterpret_cast<const int2*>(ids_s + q0) : make_int2(0, 0);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 b = bias_t[((2 * qc + hh) * 2 + r) * 32];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = p[hh][2 * r + e] * a.q_mul + (e ? b.y : b.x);
              if (kShifted && mixed && (e ? id2.y : id2.x) != id_key[r]) x += kMaskValue;
              p[hh][2 * r + e] = q0 + e < n && key_in[r] ? wtc::exp2_ftz(x - (e ? m2.y : m2.x)) * (e ? il2.y : il2.x) : 0.f;
            }
          }
        }
        uint32_t hi[4], lo[4];
        a_from_c_split(hi, lo, p[0], p[1]);
        wtc::accumulate<DP, true>(dv[qc & 1], hi, lo, dos, lanes, qc);  // dV += P^T . dO
      } else {
        uint32_t pa[4];  // P^T fragments straight from the [query][key] tile
        ldmatrix_x4_trans(pa, pst + (qc * 16 + b_row(lane)) * kLdP + warp * kWarpRows + b_col(lane));
        c_from_a(p[0], p[1], pa);
        wtc::accumulate<DP, false>(dv[qc & 1], pa, pa, dos, lanes, qc);  // dV += P^T . dO
      }
      float ds[2][4];  // dP^T = v . dO^T, then dS^T
      wtc::product16<DP>(ds, va, dos, lanes, qc);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 d2 = *reinterpret_cast<const float2*>(st_d + qc * 16 + 8 * hh + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[hh][e] = p[hh][e] * (ds[hh][e] - (e & 1 ? d2.y : d2.x));
      }
      uint32_t hi[4], lo[4];
      a_from_c_split(hi, lo, ds[0], ds[1]);
      wtc::accumulate<DP, true>(dk[qc & 1], hi, lo, qs, lanes, qc);  // dK += dS^T . q
    };
    if (kRecompute) {  // rolled in pairs: unrolled whole, it spills
#pragma unroll 2
      for (int qc = 0; qc < kQ / 16; ++qc) tile(qc);
    } else {  // unrolled, with a fence a step against hoisting
#pragma unroll
      for (int qc = 0; qc < kQ / 16; ++qc) {
        tile(qc);
        __syncwarp();
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[0][j][e] += dv[1][j][e];
        dk[0][j][e] += dk[1][j][e];
      }
    }
    store_rows<DP>(a, walk, n0, h, 1, dk[0], a.scale, lane);
    store_rows<DP>(a, walk, n0, h, 2, dv[0], 1.f, lane);
  }
}

// Rows [r0, r0 + ROWS) of a window's head slice (src its column in row 0's
// pixel; offset(r) the element offset of row r's pixel) into shared memory
// as f32 times mul (row stride DP + 1), zeros past N and past d.
template <int DP, int ROWS, typename T, typename Offset>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, Offset offset, int r0, int n, int d,
                                              float mul) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += blockDim.x) {
    const int r = idx / DP, cc = idx - r * DP;
    const int row = r0 + r;
    dst[r * (DP + 1) + cc] = row < n && cc < d ? src[offset(row) + cc] * mul : 0.f;
  }
}

// s[j] = <row r of a, row g + 4j of b>; both in shared memory, stride DP + 1.
template <int DP>
__device__ __forceinline__ void row_dots(const float* a, const float* b, int r, int g, float (&s)[kColsPerLane]) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < DP; ++kd) {
    const float x = a[r * (DP + 1) + kd];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) s[j] = fmaf(x, b[(g + j * kLanesPerRow) * (DP + 1) + kd], s[j]);
  }
}

// acc[i] += sum over cc < cols of w[r, cc] * m[cc, g + 4i]; w has stride
// kF32Tile + 1, m stride DP + 1.
template <int DP>
__device__ __forceinline__ void accumulate_rows(const float* w, const float* m, int r, int g, int cols,
                                                float (&acc)[DP / kLanesPerRow]) {
  for (int cc = 0; cc < cols; ++cc) {
    const float x = w[r * (kF32Tile + 1) + cc];
    const float* mrow = m + cc * (DP + 1);
#pragma unroll
    for (int i = 0; i < DP / kLanesPerRow; ++i) acc[i] = fmaf(x, mrow[g + i * kLanesPerRow], acc[i]);
  }
}

// Shared memory of the f32 dq kernel, in floats: the dbias sum [32][N], q
// (scaled by scale * log2(e), recomputing) and dO [32][DP + 1], K and V
// [64][DP + 1], the P (then dS) tile [32][65]; then the region ids.
template <int DP>
constexpr size_t dq_f32_bytes(int n) {
  return sizeof(float) * (kF32Rows * n + 2 * kF32Rows * (DP + 1) + 2 * kF32Tile * (DP + 1) +
                          kF32Rows * (kF32Tile + 1)) + sizeof(int) * kLargeMaxN;
}

// Thread t owns query row t / 4 and, of each key tile, the keys (t % 4) + 4j;
// for dQ the dims (t % 4) + 4i. Blocks: (run of windows, head, 32 rows).
template <int DP, bool kShifted, bool kRecompute>
__global__ void __launch_bounds__(kF32Threads) window_attention_dq_kernel(Args a) {
  constexpr int ld = DP + 1, lw = kF32Tile + 1;
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, c = a.heads * d;
  float* db = smem;                  // [32][n]
  float* qs = db + kF32Rows * n;     // recompute
  float* dos = qs + kF32Rows * ld;
  float* ks = dos + kF32Rows * ld;
  float* vs = ks + kF32Tile * ld;
  float* ws = vs + kF32Tile * ld;    // P, then dS
  int* ids_s = reinterpret_cast<int*>(ws + kF32Rows * lw);

  const int chunk = blockIdx.x, h = blockIdx.y, m0 = blockIdx.z * kF32Rows;
  const int r = threadIdx.x / kLanesPerRow, g = threadIdx.x % kLanesPerRow;
  const int row = m0 + r, rr = min(row, n - 1);
  const int t0 = chunk * a.per_chunk, t1 = min(t0 + a.per_chunk, a.total);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const int64_t stats_n = static_cast<int64_t>(a.total) * a.heads * n;
  const float* q_src = static_cast<const float*>(a.qkv) + h * d;
  const float* do_src = static_cast<const float*>(a.dout) + h * d;
  const float* bias_row = kRecompute ? a.bias + (static_cast<int64_t>(h) * n + rr) * n : nullptr;
  constexpr int kDimsPerLane = DP / kLanesPerRow;

  for (int i = threadIdx.x; i < kF32Rows * n; i += kF32Threads) db[i] = 0.f;
  for (int t = t0; t < t1; ++t) {
    const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
    auto offset = [&](int x) { return window_row(a, win, x) * row_stride; };
    auto do_offset = [&](int x) { return window_row(a, win, x) * c; };
    const float* p_rows = kRecompute ? nullptr
                                     : static_cast<const float*>(a.p) + ((static_cast<int64_t>(t) * a.heads + h) * n + m0) * n;
    __syncthreads();  // the previous window's readers are done
    load_rows_f32<DP, kF32Rows>(dos, do_src, do_offset, m0, n, d, 1.f);
    if (kShifted && kRecompute) {
      const int* ids = a.ids + static_cast<int64_t>(win.w) * n;
      for (int x = threadIdx.x; x < n; x += kF32Threads) ids_s[x] = ids[x];
    }
    float s[kColsPerLane], pv[kColsPerLane], dp[kColsPerLane];
    float m_row = 0.f, inv_l = 0.f;
    // log2-domain scores of row r against the keys k0 + g + 4j (-inf past N)
    auto scores = [&](int k0) {
      row_dots<DP>(qs, ks, r, g, s);
      const int my_id = kShifted ? ids_s[rr] : 0;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int key = k0 + g + j * kLanesPerRow;
        float x = -INFINITY;
        if (key < n) {
          x = s[j] + bias_row[key] * kLog2e;
          if (kShifted && ids_s[key] != my_id) x += kMaskValue;
        }
        s[j] = x;
      }
    };
    if (kRecompute) {
      load_rows_f32<DP, kF32Rows>(qs, q_src, offset, m0, n, d, a.q_mul);
      float m_loc = -INFINITY, l_loc = 0.f;
      for (int k0 = 0; k0 < n; k0 += kF32Tile) {
        __syncthreads();
        load_rows_f32<DP, kF32Tile>(ks, q_src + c, offset, k0, n, d, 1.f);
        __syncthreads();
        scores(k0);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) {
          const float sj = s[j];
          if (sj == -INFINITY) continue;
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
    // this thread's P[row, k0 + g + 4j] and dP, the key tile's K (recompute), V and P (stash) loaded
    auto tile_p_dp = [&](int k0) {
      row_dots<DP>(dos, vs, r, g, dp);
      if (kRecompute) {
        scores(k0);
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) pv[j] = exp2f(s[j] - m_row) * inv_l;
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) pv[j] = ws[r * lw + g + j * kLanesPerRow];
      }
    };
    auto load_tile = [&](int k0, bool with_k) {
      load_rows_f32<DP, kF32Tile>(vs, q_src + 2 * c, offset, k0, n, d, 1.f);
      if (with_k) load_rows_f32<DP, kF32Tile>(ks, q_src + c, offset, k0, n, d, 1.f);
      if (!kRecompute) {  // the stash, zero outside [:n, :n]
        for (int idx = threadIdx.x; idx < kF32Rows * kF32Tile; idx += kF32Threads) {
          const int pr = idx / kF32Tile, pc = idx - pr * kF32Tile;
          ws[pr * lw + pc] = m0 + pr < n && k0 + pc < n ? p_rows[static_cast<int64_t>(pr) * n + k0 + pc] : 0.f;
        }
      }
    };
    // pass 1: delta = rowsum(P o dP)
    float dlt = 0.f;
    for (int k0 = 0; k0 < n; k0 += kF32Tile) {
      __syncthreads();
      load_tile(k0, kRecompute);
      __syncthreads();
      tile_p_dp(k0);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) dlt = fmaf(pv[j], dp[j], dlt);
    }
    dlt = row_sum(dlt);
    if (g == 0 && row < n) {
      const int64_t at = (static_cast<int64_t>(t) * a.heads + h) * n + row;
      a.stats[at] = dlt;
      if (kRecompute) {
        a.stats[stats_n + at] = m_row;
        a.stats[2 * stats_n + at] = inv_l;
      }
    }
    // pass 2: dS = P o (dP - delta), dbias += dS, dQ = scale * dS . k
    float acc[kDimsPerLane];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < n; k0 += kF32Tile) {
      __syncthreads();
      load_tile(k0, true);
      __syncthreads();
      tile_p_dp(k0);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {  // each thread overwrites only the P entries it has read
        const int key = k0 + g + j * kLanesPerRow;
        const float ds = key < n ? pv[j] * (dp[j] - dlt) : 0.f;
        ws[r * lw + g + j * kLanesPerRow] = ds;
        if (row < n && key < n) db[r * n + key] += ds;
      }
      __syncthreads();
      accumulate_rows<DP>(ws, ks, r, g, min(kF32Tile, n - k0), acc);
    }
    if (row < n) {
      float* dst = static_cast<float*>(a.dqkv) + window_row(a, win, row) * row_stride + h * d;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int dd = g + i * kLanesPerRow;
        if (dd < d) dst[dd] = acc[i] * a.scale;
      }
    }
  }
  __syncthreads();
  float* part = a.dbias_part + (static_cast<int64_t>(chunk) * a.heads + h) * n * n + static_cast<int64_t>(m0) * n;
  const int real = min(kF32Rows, n - m0) * n;
  for (int i = threadIdx.x; i < real; i += kF32Threads) part[i] = db[i];
}

// Shared memory of the f32 dkv kernel, in floats: k (recompute) and v
// [32][DP + 1], q (scaled by scale * log2(e) recomputing, by scale from P)
// and dO [64][DP + 1], P^T and dS^T [32][65], the queries' delta, max and
// 1 / sum [3][64]; then the region ids.
template <int DP>
constexpr size_t dkv_f32_bytes() {
  return sizeof(float) * (2 * kF32Rows * (DP + 1) + 2 * kF32Tile * (DP + 1) + 2 * kF32Rows * (kF32Tile + 1) +
                          3 * kF32Tile) + sizeof(int) * kLargeMaxN;
}

// Thread t owns key row t / 4 and, of each query tile, the queries (t % 4) +
// 4j; for dK and dV the dims (t % 4) + 4i. Blocks: (window, head, 32 keys).
template <int DP, bool kShifted, bool kRecompute>
__global__ void __launch_bounds__(kF32Threads) window_attention_dkv_kernel(Args a) {
  constexpr int ld = DP + 1, lw = kF32Tile + 1;
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, c = a.heads * d;
  float* ks = smem;
  float* vs = ks + kF32Rows * ld;
  float* qs = vs + kF32Rows * ld;
  float* dos = qs + kF32Tile * ld;
  float* pt = dos + kF32Tile * ld;   // P^T [key][query]
  float* dst = pt + kF32Rows * lw;   // dS^T
  float* st_delta = dst + kF32Rows * lw;
  float* st_m = st_delta + kF32Tile;
  float* st_il = st_m + kF32Tile;
  int* ids_s = reinterpret_cast<int*>(st_il + kF32Tile);

  const int t = blockIdx.x, h = blockIdx.y, n0 = blockIdx.z * kF32Rows;
  const int r = threadIdx.x / kLanesPerRow, g = threadIdx.x % kLanesPerRow;
  const int key = n0 + r, kc = min(key, n - 1);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const int64_t stats_n = static_cast<int64_t>(a.total) * a.heads * n;
  const int64_t stats0 = (static_cast<int64_t>(t) * a.heads + h) * n;
  const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
  auto offset = [&](int x) { return window_row(a, win, x) * row_stride; };
  auto do_offset = [&](int x) { return window_row(a, win, x) * c; };
  const float* q_src = static_cast<const float*>(a.qkv) + h * d;
  const float* do_src = static_cast<const float*>(a.dout) + h * d;
  const float* bias_h = kRecompute ? a.bias + static_cast<int64_t>(h) * n * n : nullptr;
  const float* p_tile = kRecompute ? nullptr : static_cast<const float*>(a.p) + stats0 * n;
  // q is the score operand recomputing (scale * log2(e)), else dK's (scale)
  const float q_mul = kRecompute ? a.q_mul : a.scale;

  if (kShifted && kRecompute) {
    const int* ids = a.ids + static_cast<int64_t>(win.w) * n;
    for (int x = threadIdx.x; x < n; x += kF32Threads) ids_s[x] = ids[x];
  }
  if (kRecompute) load_rows_f32<DP, kF32Rows>(ks, q_src + c, offset, n0, n, d, 1.f);
  load_rows_f32<DP, kF32Rows>(vs, q_src + 2 * c, offset, n0, n, d, 1.f);

  constexpr int kDimsPerLane = DP / kLanesPerRow;
  float acc_dv[kDimsPerLane], acc_dk[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  float s[kColsPerLane], dp[kColsPerLane];
  for (int q0 = 0; q0 < n; q0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<DP, kF32Tile>(qs, q_src, offset, q0, n, d, q_mul);
    load_rows_f32<DP, kF32Tile>(dos, do_src, do_offset, q0, n, d, 1.f);
    for (int qq = threadIdx.x; qq < kF32Tile; qq += kF32Threads) {
      const bool in = q0 + qq < n;
      st_delta[qq] = in ? a.stats[stats0 + q0 + qq] : 0.f;
      if (kRecompute) {
        st_m[qq] = in ? a.stats[stats_n + stats0 + q0 + qq] : 0.f;
        st_il[qq] = in ? a.stats[2 * stats_n + stats0 + q0 + qq] : 0.f;  // 0: no probability for pad rows
      }
    }
    if (!kRecompute) {  // P^T tile; neighbouring threads read neighbouring keys of one query row
      for (int idx = threadIdx.x; idx < kF32Tile * kF32Rows; idx += kF32Threads) {
        const int qq = idx / kF32Rows, kr = idx - qq * kF32Rows;
        pt[kr * lw + qq] = q0 + qq < n && n0 + kr < n ? p_tile[static_cast<int64_t>(q0 + qq) * n + n0 + kr] : 0.f;
      }
    }
    __syncthreads();
    row_dots<DP>(vs, dos, r, g, dp);  // dP[query, key] = dO[query] . v[key]
    if (kRecompute) row_dots<DP>(ks, qs, r, g, s);
    const int my_id = kShifted && kRecompute ? ids_s[kc] : 0;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int qq = g + j * kLanesPerRow;
      float p;
      if (kRecompute) {
        const int query = min(q0 + qq, n - 1);
        float x = s[j] + bias_h[static_cast<int64_t>(query) * n + kc] * kLog2e;
        if (kShifted && ids_s[query] != my_id) x += kMaskValue;
        p = key < n ? exp2f(x - st_m[qq]) * st_il[qq] : 0.f;
        pt[r * lw + qq] = p;
      } else {
        p = pt[r * lw + qq];
      }
      dst[r * lw + qq] = p * (dp[j] - st_delta[qq]);
    }
    __syncthreads();
    const int cols = min(kF32Tile, n - q0);
    accumulate_rows<DP>(pt, dos, r, g, cols, acc_dv);  // dV[key] += P[query, key] dO[query]
    accumulate_rows<DP>(dst, qs, r, g, cols, acc_dk);  // dK[key] += dS[query, key] q'[query]
  }
  if (key < n) {
    float* out = static_cast<float*>(a.dqkv) + window_row(a, win, key) * row_stride + h * d;
    const float dk_mul = kRecompute ? kInvLog2e : 1.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) {
        out[c + dd] = acc_dk[i] * dk_mul;
        out[2 * c + dd] = acc_dv[i];
      }
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

template <int DP, bool kShifted, bool kRecompute>
cudaError_t launch_f32(const Args& a, float* dbias, cudaStream_t stream) {
  return launch(window_attention_bwd_kernel<DP, kShifted, kRecompute>, kThreads, smem_bytes<DP>(a.n), a,
                dbias, stream);
}

template <int DP, bool kShifted, bool kRecompute>
cudaError_t launch_tc(const Args& a, float* dbias, cudaStream_t stream) {
  auto kernel = window_attention_bwd_tc_kernel<DP, kShifted, kRecompute>;
  // as much of the SM's memory as shared memory as it takes for three blocks
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return launch(kernel, kTcThreads, TcSmem<DP, kShifted, kRecompute>::bytes(a.n), a, dbias, stream);
}

// N > 64: the dq and dkv kernels, then the dbias sum. f32: dq on a grid of
// (run of windows, head, run of rows), dkv on (window, head, run of rows);
// bf16: both on (run of windows, head, run of rows).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, size_t bytes, const Args& a, cudaStream_t stream) {
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool kShifted, bool kRecompute>
cudaError_t launch_large(const Args& a, float* dbias, int dtype, cudaStream_t stream) {
  const int n_chunks = (a.total + a.per_chunk - 1) / a.per_chunk;
  cudaError_t err;
  if (dtype == 0) {
    const int blocks = (a.n + kF32Rows - 1) / kF32Rows;
    err = launch_one(window_attention_dq_kernel<DP, kShifted, kRecompute>, dim3(n_chunks, a.heads, blocks),
                     kF32Threads, dq_f32_bytes<DP>(a.n), a, stream);
    if (err != cudaSuccess) return err;
    err = launch_one(window_attention_dkv_kernel<DP, kShifted, kRecompute>, dim3(a.total, a.heads, blocks),
                     kF32Threads, dkv_f32_bytes<DP>(), a, stream);
  } else {
    const dim3 grid(n_chunks, a.heads, (a.n + wtc::kRows - 1) / wtc::kRows);
    err = launch_one(window_attention_dq_tc_kernel<DP, kShifted, kRecompute>, grid, wtc::kThreads,
                     DqSmem<DP, kShifted, kRecompute>::bytes(), a, stream);
    if (err != cudaSuccess) return err;
    err = launch_one(window_attention_dkv_tc_kernel<DP, kShifted, kRecompute>, grid, wtc::kThreads,
                     DkvSmem<DP, kShifted, kRecompute>::bytes(), a, stream);
  }
  if (err != cudaSuccess) return err;
  const int count = a.heads * a.n * a.n;
  dbias_sum_kernel<<<(count + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      a.dbias_part, dbias, n_chunks, count);
  return cudaGetLastError();
}

// The occupancy of one bf16 tiled kernel (N > 64): its threads a block,
// dynamic shared memory a block and blocks an SM.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t bytes, int* blocks_per_sm) {
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, bytes);
}

template <int DP, bool kShifted, bool kRecompute>
cudaError_t tiled_occupancy(int which, int n, int* threads, int* smem_bytes, int* blocks_per_sm) {
  *threads = wtc::kThreads;
  const size_t bytes = which == 0 ? DqSmem<DP, kShifted, kRecompute>::bytes() : DkvSmem<DP, kShifted, kRecompute>::bytes();
  *smem_bytes = static_cast<int>(bytes);
  return which == 0 ? occupancy(window_attention_dq_tc_kernel<DP, kShifted, kRecompute>, *threads, bytes, blocks_per_sm)
                    : occupancy(window_attention_dkv_tc_kernel<DP, kShifted, kRecompute>, *threads, bytes, blocks_per_sm);
}

// float32 -> the CUDA-core kernels, bfloat16 -> the tensor-core kernels; N
// above 64 -> the tiled ones; DP is the head-dim bucket, then the variant:
// from P unshifted, from P shifted (the stash holds the mask; only the
// addresses wrap), recompute with shift regions, recompute without.
template <int DP>
cudaError_t dispatch(const Args& a, float* dbias, int dtype, cudaStream_t s) {
  if (a.n > kMaxN) {
    if (a.p != nullptr) {
      return a.shift > 0 ? launch_large<DP, true, false>(a, dbias, dtype, s)
                         : launch_large<DP, false, false>(a, dbias, dtype, s);
    }
    if (a.ids != nullptr) return launch_large<DP, true, true>(a, dbias, dtype, s);
    return launch_large<DP, false, true>(a, dbias, dtype, s);
  }
  if (dtype == 0) {
    if (a.p != nullptr) return a.shift > 0 ? launch_f32<DP, true, false>(a, dbias, s) : launch_f32<DP, false, false>(a, dbias, s);
    if (a.ids != nullptr) return launch_f32<DP, true, true>(a, dbias, s);
    return launch_f32<DP, false, true>(a, dbias, s);
  }
  if (a.p != nullptr) return a.shift > 0 ? launch_tc<DP, true, false>(a, dbias, s) : launch_tc<DP, false, false>(a, dbias, s);
  if (a.ids != nullptr) return launch_tc<DP, true, true>(a, dbias, s);
  return launch_tc<DP, false, true>(a, dbias, s);
}

}  // namespace

// qkv: [b, h_img, w_img, 3 * heads * head_dim], dout: [b, h_img, w_img, heads *
// head_dim], dqkv: like qkv, p: [b, nW, heads, ws^2, ws^2] (the forward's
// stash) or NULL to recompute the probabilities from bias (f32 [heads, ws^2,
// ws^2]) and ids (int32 [nW, ws^2] region ids, or NULL for unshifted
// windows); shift: the cyclic shift of shifted windows, 0 <= shift < ws,
// which takes p or ids (0: the caller rolled the map, or unshifted); qkv,
// dout, dqkv and p of `dtype` (0: float32, 1: bfloat16), all
// contiguous, on the current device. dbias_part: f32 [ceil(b * nW /
// per_chunk), heads, ws^2, ws^2] scratch; dbias: f32 [heads, ws^2, ws^2].
// stats: for ws^2 > 64, f32 [3, b * nW, heads, ws^2] scratch (else NULL).
// q_mul = scale * log2(e). per_chunk: windows each block of the dbias-
// carrying kernel takes, in batch-row-major order. Takes ws <= 16 and
// head_dim <= 64 (ws <= 8 on the bodies above, 8 < ws <= 16 on the tiled
// ones). Launches the backward kernels, then the dbias sum, on `stream`.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int vdk_fused_window_attention_bwd(const void* qkv, const float* bias, const int* ids,
                                              const void* p, const void* dout, void* dqkv,
                                              float* dbias_part, float* dbias, float* stats, int b, int h_img,
                                              int w_img, int heads, int head_dim, int ws, int shift,
                                              int per_chunk, float q_mul, float scale, int dtype,
                                              void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || head_dim < 1 || head_dim > 64 ||
      ws < 1 || ws * ws > kLargeMaxN || h_img < ws || w_img < ws || h_img % ws || w_img % ws ||
      shift < 0 || shift >= ws || (shift > 0 && p == nullptr && ids == nullptr) ||
      per_chunk < 1 || dbias_part == nullptr || dbias == nullptr || (ws * ws > kMaxN && stats == nullptr) ||
      (p == nullptr && bias == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_win_x = w_img / ws;
  const int n_win = (h_img / ws) * n_win_x;
  const int c = heads * head_dim;
  const int aligned = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dqkv) % 16 == 0 && head_dim % 8 == 0 && c % 8 == 0;
  const int p_aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0 && ws * ws % 8 == 0;
  const Args a{qkv,       bias,    ids,   p,         dout,      dqkv,  dbias_part, h_img,   w_img,
               heads,     head_dim, ws,   ws * ws,   n_win_x,   n_win, b * n_win,  per_chunk, shift,
               q_mul,     scale,   aligned, stats, p_aligned};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = head_dim <= 32 ? dispatch<32>(a, dbias, dtype, s) : dispatch<64>(a, dbias, dtype, s);
  return static_cast<int>(err);
}

// The bf16 tiled kernel `which` (0: dq, 1: dkv) at head dim `head_dim` in
// one of its variants (shifted windows or not; recompute or from P), for
// windows of n tokens: its threads a block, dynamic shared
// memory a block, and blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the CUDA error code (0 on success).
extern "C" int vdk_fused_window_attention_bwd_tiled_occupancy(int which, int head_dim, int masked, int recompute,
                                                              int n, int* threads, int* smem_bytes,
                                                              int* blocks_per_sm) {
  if ((which != 0 && which != 1) || head_dim < 1 || head_dim > 64 || n <= kMaxN || n > kLargeMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
#define VDK_CASE(DP)                                                                                        \
  err = masked ? (recompute ? tiled_occupancy<DP, true, true>(which, n, threads, smem_bytes, blocks_per_sm)    \
                            : tiled_occupancy<DP, true, false>(which, n, threads, smem_bytes, blocks_per_sm))  \
               : (recompute ? tiled_occupancy<DP, false, true>(which, n, threads, smem_bytes, blocks_per_sm)   \
                            : tiled_occupancy<DP, false, false>(which, n, threads, smem_bytes, blocks_per_sm));
  if (head_dim <= 32) {
    VDK_CASE(32)
  } else {
    VDK_CASE(64)
  }
#undef VDK_CASE
  return static_cast<int>(err);
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
