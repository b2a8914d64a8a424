// Fused window attention, forward: qkv [B, H, W, 3C] -> O [B, H, W, C], for
// Hopper (sm_90a), with an optional stash of the probabilities
// P [B, nW, heads, N, N] for the backward.
//
// Replaces the Pallas TPU kernel visiondk_tpu/ops/pallas/window_attention.py::
// _wattn_fwd_kernel (:246-290, scores by _scores :224-243) in both of its
// launches: by _wattn_fwd (:467; K2, the no-stash forward of
// fused_window_attention) and by _wattn_vjp_fwd (:521; K2s, the training
// forward, which also writes p_ref; the window pairing of VDK_WATTN_PAIR > 1
// is TPU layout machinery and is not ported). It keeps that kernel's layout
// contract and does the window partition itself: row r of window (wy, wx) is
// pixel (wy*ws + r / ws, wx*ws + r % ws) of the [B, H, W, 3C] buffer, read by
// strides (q at column h*d, k at C + h*d, v at 2C + h*d), and O is written
// back to the same pixel of [B, H, W, C]. Shifted windows (shift s > 0) also
// do the cyclic shift that the reference's block does with two jnp.rolls
// around the kernel: row r of window (wy, wx) is then pixel
// ((wy*ws + r / ws + s) mod H, (wx*ws + r % ws + s) mod W) (window_tc.cuh).
// No partition, reverse or roll copy ever reaches device memory.
//
// Math, per (window, head, batch row), as the reference does it, in f32 from
// the input dtype's values:
//   S = (q . k^T) * scale * log2(e) + bias_h * log2(e)      (log2 domain)
//   S += -100 * log2(e) where the region ids of query and key differ
//        (shifted windows only, kShifted; the unshifted variants do no mask
//        work and no wrap of their addresses)
//   P = exp2(S - rowmax) * (1 / rowsum), rounded to the input dtype
//   O = P . v, summed in f32, rounded to the input dtype
// The reference scales q before the product; the kernels scale the f32 sum
// after it (a last-bit difference in S, which flips P's rounding by one ulp
// now and then: tests/test_torch_port_window_rounding.py models it). With
// the stash (kStash), P is written from where it is formed, the rounded value
// that multiplies V; the stash only adds stores, so O is bit-for-bit the
// no-stash kernel's.
//
// What bounds it on the H100: bytes. A window is tiny (Swin: N = 49 tokens,
// d = 32); per (window, head) the work is two products of 49 x 49 x 32 and
// 49^2 exp2, and the bytes are q, k, v in, O out and, with the stash, P out.
// At Swin-B stage 0 (bs 80, 56^2, 4 heads, bf16) that is 256.9 MB (0.077 ms
// at 3.35 TB/s) against 6.3 GFLOP (0.006 ms at the bf16 tensor-core peak);
// the stash adds 98.3 MB (0.106 ms in all).
//
// bfloat16 (the main path): tensor cores. The first design (the f32 kernel
// below, once also bf16's: one block per (window, head, batch row), products
// on CUDA cores out of f32 shared memory) issued about one shared-memory load
// per multiply-add, loaded each window synchronously with 2-byte loads and
// computed only after a barrier: shared-memory issue and each window's load
// latency, not the bytes, set its time (10% and 14% of the bound). This
// design, the window backward's (fused_window_attention_bwd.cu) applied to
// the forward:
//   - a block takes one head and a fixed run of `per_chunk` consecutive
//     windows (batch-row-major); the wrapper sizes the runs so that one wave
//     of blocks covers the call. A window's rows and keys pad to 64 = four
//     16-row MMA tiles, one warp each (4 warps a block).
//   - a two-stage cp.async ring: window t + 1's q, k, v head slices (16-byte
//     chunks when rows are 16-byte aligned and d is a multiple of 8, else
//     element by element) and region ids arrive while window t computes; one
//     barrier a window. Rows past N are never loaded: their ldmatrix
//     addresses read row N - 1.
//   - S = q . k^T on mma.sync m16n8k16 (bf16 in, f32 sum) from ldmatrix
//     fragments; a warp's 16 rows x 64 keys stay in registers (32 f32 a
//     thread), so the softmax takes one pass with no running max. The head's
//     bias x log2(e), with -inf at keys past N, is read once per block into
//     the same fragment positions (32 registers).
//   - row max and row sum by xor-shuffles across the four lanes of a fragment
//     row, every lane taking part; P rounded once to bf16 and repacked C -> A
//     in registers for O += P . V, V's B fragments by ldmatrix.trans.
//   - O's fragment rows go straight to the pixels' head slices (4-byte stores
//     where aligned); rows past N are never stored.
//   - the stash: a 49 x 49 tile is 2,401 bf16, so every other tile starts on
//     a 2-byte boundary and no row is 16-byte aligned, and no store may touch
//     a neighbouring tile's bytes. Each warp writes its rows of P, in the
//     tile's own order, into its staging strip of shared memory at the tile's
//     16-byte phase, then copies the strip out: 16-byte stores for the pieces
//     inside its rows, element stores for the (at most two) pieces that its
//     range cuts. A __syncwarp and no block barrier. (Direct 2-byte global
//     stores from the fragments would be 32 scattered stores a thread.)
//   - each thread's pixel offsets (row r of a window is r / ws image rows and
//     r % ws columns from the window's first pixel) are divided out once per
//     block, as in the backward; shifted windows wrap them with two compares
//     a row, once a window.
// Tried on the card and dropped, none faster at Swin-B's stages 0 and 2: the
// stash stored straight from the fragments (2-byte stores; far slower), a 3-
// or 4-stage ring, runs sized for 2, 5 or 8 blocks an SM, the bias held in
// shared memory instead of registers, and ex2.approx in place of exp2f.
//
// float32: the first design's CUDA-core kernel, kept for the f32 bars (O
// 1e-4, P 1e-5); TF32 products would not hold them. 256 threads, one block
// per (window, head, batch row); thread t owns window row t / 4 and the keys
// (t % 4) + 4j, j < 16; for P . V the output dims (t % 4) + 4i. A bf16 tensor
// never reaches it.
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
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -144.26950408889634f;  // -100 * log2(e), the reference's region mask

struct Args {
  const void* qkv;    // [B, H, W, 3C]
  const float* bias;  // [heads, N, N]
  const int* ids;     // [nW, N] region ids, or NULL (unshifted)
  void* out;          // [B, H, W, C]
  void* p;            // [B, nW, heads, N, N], or NULL (no stash)
  int h_img, w_img, heads, d, ws, n, n_win_x, n_win, total, per_chunk;
  int shift;    // the cyclic shift s of shifted windows (0 where the caller rolled the map)
  float q_mul;  // scale * log2(e)
  int aligned;  // bf16: qkv and out start on 16 bytes, d and C multiples of 8
  int p_aligned;  // bf16, N > 64: the stash's rows start on 16 bytes
};

// Window t (batch-row-major) of the call: its first pixel and, shifted, where
// its rows wrap.
template <bool kShifted>
__device__ __forceinline__ wtc::WindowWalk<kShifted> window_at(const Args& a, int t) {
  return wtc::WindowWalk<kShifted>(t, a.n_win, a.n_win_x, a.ws, a.h_img, a.w_img, a.shift);
}

// Row r of a window, as a row index of [B * H * W] (one division: the f32
// bodies').
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

// Shared memory in floats: q and k [N][DP + 1] (the pad puts the column reads
// of the score loop in distinct banks), v [N][DP], P [N][N + 1], then N ints
// of region ids.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (2 * n * (DP + 1) + n * DP + n * (n + 1)) + sizeof(int) * n;
}

template <int DP, bool kShifted, bool kStash>
__global__ void __launch_bounds__(kThreads) window_attention_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n, d = a.d;
  const int lp = n + 1;
  float* qs = smem;
  float* ks = qs + n * (DP + 1);
  float* vs = ks + n * (DP + 1);
  float* ps = vs + n * DP;
  int* id_s = reinterpret_cast<int*>(ps + n * lp);

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = a.heads * d;
  const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, b * a.n_win + w);
  // the pixel of window row r, as an index into the [B, H, W] grid
  auto pixel = [&](int r) -> int64_t { return window_row(a, win, r); };

  const float* qkv = static_cast<const float*>(a.qkv);
  for (int idx = threadIdx.x; idx < n * DP; idx += kThreads) {
    const int r = idx / DP;
    const int cc = idx - r * DP;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (cc < d) {
      const float* src = qkv + pixel(r) * (3 * static_cast<int64_t>(c)) + h * d + cc;
      qv = src[0] * a.q_mul;
      kv = src[c];
      vv = src[2 * c];
    }
    qs[r * (DP + 1) + cc] = qv;
    ks[r * (DP + 1) + cc] = kv;
    vs[r * DP + cc] = vv;
  }
  if (kShifted) {
    for (int r = threadIdx.x; r < n; r += kThreads) id_s[r] = a.ids[static_cast<int64_t>(w) * n + r];
  }
  __syncthreads();

  const int r = threadIdx.x / kLanesPerRow;
  const int g = threadIdx.x % kLanesPerRow;
  const bool live = r < n;
  const int rr = live ? r : n - 1;  // idle rows read a real row and discard it

  // Scores of row r against keys g + 4j (key rows past N read row N - 1).
  float s[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < DP; ++kd) {
    const float q = qs[rr * (DP + 1) + kd];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      s[j] = fmaf(q, ks[min(g + j * kLanesPerRow, n - 1) * (DP + 1) + kd], s[j]);
    }
  }
  const float* bias_row = a.bias + (static_cast<int64_t>(h) * n + rr) * n;
  const int my_id = kShifted ? id_s[rr] : 0;
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int key = g + j * kLanesPerRow;
    if (key < n) {
      float sj = s[j] + bias_row[key] * kLog2e;
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
    s[j] = key < n ? exp2f(s[j] - m) : 0.f;
    l += s[j];
  }
  const float inv_l = 1.f / row_sum(l);
  if (live) {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int key = g + j * kLanesPerRow;
      if (key < n) ps[r * lp + key] = s[j] * inv_l;
    }
  }
  __syncthreads();

  if (kStash) {
    // this (window, head)'s N x N tile of P, contiguous in [B, nW, heads, N, N]
    float* p_tile = static_cast<float*>(a.p) + ((static_cast<int64_t>(b) * a.n_win + w) * a.heads + h) * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
      const int pr = idx / n;
      p_tile[idx] = ps[pr * lp + idx - pr * n];
    }
  }

  constexpr int kDimsPerLane = DP / kLanesPerRow;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
  if (live) {
    for (int key = 0; key < n; ++key) {
      const float p = ps[r * lp + key];
      const float* vrow = vs + key * DP;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[i] = fmaf(p, vrow[g + i * kLanesPerRow], acc[i]);
    }
    float* o = static_cast<float*>(a.out) + pixel(r) * c + h * d;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) o[dd] = acc[i];
    }
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int kTcWarps = 4;                    // one per 16-row tile of a window padded to 64
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kNP = kTcWarps * tc::kWarpRows;  // 64: a window's rows and keys, padded
constexpr int kNT = kNP / 8;                   // n-tiles of 8 keys
constexpr int kStages = 2;                     // windows in a block's cp.async ring
static_assert(kLanesPerRow == 4, "row_max and row_sum also reduce the four lanes of an MMA fragment row");

// Shared memory of the tensor-core kernel, in this order: kStages stages of
// q, k, v [N][DP + 8] bf16; with the stash, each warp's staging strip for its
// rows of the P tile (16 rows of N, shifted by up to 7 to the tile's 16-byte
// phase); with shift regions, kStages stages of the window's region ids
// [kNP] int.
template <int DP, bool kShifted, bool kStash>
struct TcSmem {
  static constexpr int kLd = DP + tc::kPad;
  __host__ __device__ static constexpr int ops(int n) { return 3 * n * kLd; }  // bf16 elements of one stage
  __host__ __device__ static constexpr int strip(int n) {
    return kStash ? (tc::kWarpRows * n + 7 + 7) / 8 * 8 : 0;
  }
  static constexpr size_t bytes(int n) {
    return sizeof(tc::bf16) * (kStages * ops(n) + kTcWarps * strip(n)) +
           (kShifted ? sizeof(int) * kStages * kNP : 0);
  }
};

// Blocks an SM: four at head dim 32, three at 64; the wrapper sizes its runs
// of windows for four.
template <int DP, bool kShifted, bool kStash>
__global__ void __launch_bounds__(kTcThreads, DP <= 32 ? 4 : 3) window_attention_fwd_tc_kernel(Args a) {
  using namespace tc;
  using Smem = TcSmem<DP, kShifted, kStash>;
  constexpr int kLd = Smem::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, d = a.d, ws = a.ws, c = a.heads * d;
  bf16* ops = reinterpret_cast<bf16*>(smem_raw);
  bf16* strips = ops + kStages * Smem::ops(n);                            // with the stash
  int* ids_s = reinterpret_cast<int*>(strips + kTcWarps * Smem::strip(n));  // shifted windows

  const int chunk = blockIdx.x, h = blockIdx.y;
  const int t0 = chunk * a.per_chunk;
  const int count = min(a.per_chunk, a.total - t0);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  bf16* out = static_cast<bf16*>(a.out);

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

  // Window t0 + i into stage i % kStages: q, k, v rows [0, n) with zeros
  // past d; the region ids.
  auto load = [&](int i) {
    const int t = t0 + i, s = i % kStages;
    const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
    bf16* dst = ops + s * Smem::ops(n) + lc;
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int r = lr + kRowStep * k;
      if (r >= n) break;
      const bf16* row = qkv + (win.base + win.at(load_px[k], hw, a.w_img)) * row_stride + h * d + lc;
#pragma unroll
      for (int op = 0; op < 3; ++op) {
        const bf16* src = row + op * c;
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
    if (kShifted) {
      for (int r = threadIdx.x; r < n; r += kTcThreads) {
        cp_async4(ids_s + s * kNP + r, a.ids + static_cast<int64_t>(win.w) * n + r, 4);
      }
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = warp * kWarpRows;  // this warp's 16 query rows
  const int rowc[2] = {min(row0 + g, n - 1), min(row0 + g + 8, n - 1)};  // rows past N: row N - 1's, never stored
  const int store_px[2] = {pixel_offset(row0 + g), pixel_offset(row0 + g + 8)};

  // bias * log2(e) at this thread's fragment positions (rows row0 + g (+ 8),
  // keys 8j + 2tq (+ 1)), -inf at keys past N: out of the row
  float bias2[kNT][4];
  const float* bias_h = a.bias + static_cast<int64_t>(h) * n * n;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * tq + (e & 1);
      bias2[j][e] = key < n ? __ldg(bias_h + rowc[e >> 1] * n + key) * kLog2e : -INFINITY;
    }
  }

  // One commit group per window, empty past the run, so that window i's is
  // always kStages - 2 groups before the newest.
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // window i has arrived, and every warp is done with window i - 1
    if (i + kStages - 1 < count) load(i + kStages - 1);  // into window i - 1's stage
    cp_async_commit();
    if (row0 >= n) continue;  // a warp with no rows (N <= 48)
    const int t = t0 + i, s = i % kStages;
    const bf16* qs = ops + s * Smem::ops(n);
    const bf16* ks = qs + n * kLd;
    const bf16* vs = ks + n * kLd;

    // S = q . k^T, scaled after the sum, + bias [+ region mask]; row max
    float sc[kNT][4];
    product_nt_rows<DP, kNT>(sc, qs, row0, ks, kLd, n, lane);
    const int* ids = ids_s + s * kNP;
    const int id_row[2] = {kShifted ? ids[rowc[0]] : 0, kShifted ? ids[rowc[1]] : 0};
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * a.q_mul + bias2[j][e];
        // ids past N hold no window's ids, but x is -inf there whatever is added
        if (kShifted && ids[j * 8 + 2 * tq + (e & 1)] != id_row[e >> 1]) x += kMaskValue;
        sc[j][e] = x;
        m[e >> 1] = fmaxf(m[e >> 1], x);
      }
    }
    // P = exp2(S - m) * (1 / l), rounded to bf16 into A fragments: pa[kk]
    // holds keys [16 kk, 16 kk + 16). Every lane of the warp shuffles.
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = row_max(m[r]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = 1.f / row_sum(l[r]);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= l[e >> 1];
    }
    uint32_t pa[kNP / 16][4];
#pragma unroll
    for (int kk = 0; kk < kNP / 16; ++kk) a_from_c(pa[kk], sc[2 * kk], sc[2 * kk + 1]);

    if (kStash) {
      // this (window, head)'s N x N tile, contiguous in [B, nW, heads, N, N];
      // the warp's rows are its elements [e0, e0 + len), staged at the
      // strip's index ph + (e - e0), so that strip index 8k is 16-byte
      // aligned in the tile exactly where it is in the strip
      bf16* tile = static_cast<bf16*>(a.p) + (static_cast<int64_t>(t) * a.heads + h) * n * n;
      const int e0 = row0 * n, len = (min(row0 + kWarpRows, n) - row0) * n;
      const int ph = static_cast<int>(((reinterpret_cast<uintptr_t>(tile) >> 1) + e0) & 7);
      bf16* strip = strips + warp * Smem::strip(n);
      uint16_t* strip16 = reinterpret_cast<uint16_t*>(strip) + ph;
#pragma unroll
      for (int kk = 0; kk < kNP / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {  // a0..a3: (row g or g + 8, keys 16kk + 2tq (+ 8), + 1)
          const int row = g + 8 * (x & 1), key = kk * 16 + 8 * (x >> 1) + 2 * tq;
          if (row0 + row < n) {
            if (key < n) strip16[row * n + key] = static_cast<uint16_t>(pa[kk][x] & 0xffffu);
            if (key + 1 < n) strip16[row * n + key + 1] = static_cast<uint16_t>(pa[kk][x] >> 16);
          }
        }
      }
      __syncwarp();
      bf16* dst = tile + e0 - ph;  // 16-byte aligned; only [ph, ph + len) is this warp's
      for (int k = 8 * lane; k < ph + len; k += 8 * 32) {
        if (k >= ph && k + 8 <= ph + len) {
          *reinterpret_cast<uint4*>(dst + k) = *reinterpret_cast<const uint4*>(strip + k);
        } else {
          for (int x = max(k, ph); x < min(k + 8, ph + len); ++x) dst[x] = strip[x];
        }
      }
    }

    // O = P . V, rounded to bf16 into the rows' pixels
    float o[DP / 8][4];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kNP / 16; ++kk) {
      if (kk * 16 < n) accumulate_tn_rows<DP, false>(o, pa[kk], pa[kk], vs, kLd, kk, n, lane);
    }
    const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + g + 8 * r >= n) continue;
      bf16* dst = out + (win.base + win.at(store_px[r], hw, a.w_img)) * c + h * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * tq;
        if (a.aligned) {
          if (col < d) *reinterpret_cast<uint32_t*>(dst + col) = pack(o[j][2 * r], o[j][2 * r + 1]);
        } else {
          if (col < d) dst[col] = __float2bfloat16(o[j][2 * r]);
          if (col + 1 < d) dst[col + 1] = __float2bfloat16(o[j][2 * r + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- windows of N > 64
//
// ws 9 to 16 (N up to 256: swinv2_large_window12to16_192to256 attends in 16 x
// 16 windows in stages 0-2). Replaces the same Pallas kernel
// (_wattn_fwd_kernel, window_attention.py:246-290) for those windows, in both
// launches (K2 and K2s). A window's f32 scores no longer fit one warp's
// registers nor, in the f32 design above, shared memory (about 356 KB at
// N = 256), so these bodies split a window's query rows over blocks.
//
// What bounds it on the H100: bytes by the roofline; in practice the rate
// of instructions for the per-score work. At SwinV2-L stage 0 (bs 32, 64^2,
// ws 16 shifted by 8, 6 heads, d 32, bf16) q, k, v and the bias in and O out
// are 203 MB (0.061 ms at 3.35 TB/s) against 25.8 GFLOP (0.026 ms at the bf16
// peak); the stash adds 403 MB. But each of the 201 M scores also takes a scale and bias add,
// a max, an exp2, a sum, a normalisation and a rounding: about 7 instructions
// a score, and the 128 scores a thread holds leave registers for 8 warps an
// SM, so the instruction rate, not a unit's throughput, sets the time.
//
// bfloat16 (the main path). The first design (one block a window, the f32
// bias read from L2 at every score, two passes over 16 barrier-separated
// 32-key tiles so that P rounds where the reference rounds it) took 1.12 ms
// (K2) and 1.34 ms (K2s) at stage 0 (PERF.md). This design, against each of
// its limits:
//   - the bias at every score: a block takes one head, a run of 64 query rows
//     (4 warps of 16) and a fixed run of `per_chunk` windows in batch-row-
//     major order; the bias rows of its queries times log2(e) (-inf past N)
//     are read once a block into shared memory in fragment order, each
//     thread's own values in 16-byte pieces that neighbouring lanes read side
//     by side (64 KB): no bias byte comes from L2 after the first window.
//   - two passes: a warp forms each score once. Its 16 rows x 256 keys stay in
//     registers (128 f32 a thread), so the row max, exp2, row sum,
//     normalisation and bf16 rounding of P follow with no second product,
//     bias add, mask or exp2. P = exp2(S - max) * (1 / sum) is rounded to bf16
//     after normalisation, where the reference rounds it, and repacked C -> A
//     in registers for O += P . V. Maxima and sums over four partials a row,
//     P . V over two: no long dependent chains.
//   - one window a block: the wrapper sizes the runs so that one wave of two
//     blocks an SM covers the call (stage 0: 11 runs x 6 heads x 4 runs of
//     rows). Two barriers a window overlap the loads with the products: V of
//     window t arrives during its Q . K^T and softmax, q and K of window
//     t + 1 during its P . V.
//   - every window takes 256 keys (past N: zero K and V, -inf bias), so every
//     loop is unrolled with no bound to test; each lane's ldmatrix offsets
//     are computed once (window_tc.cuh), every tile offset an immediate. With
//     N and the swizzled addresses computed at run time, branches and integer
//     work were half of the instructions.
//   - the key order of window_tc.cuh puts a thread's P for eight consecutive
//     keys of a row in one register quad: the stash is written straight from
//     the fragments in 16-byte stores (N a multiple of 8; else element by
//     element). The stash adds only stores, so O is bit for bit the no-stash
//     kernel's.
//   - exp2 is ex2.approx.ftz (window_tc.cuh::exp2_ftz); the region mask is
//     added only in windows whose ids differ (a warp vote a window); a
//     __syncwarp() every few steps of the products keeps ptxas from hoisting
//     all their loads, which spilled.
// Tried on the card and dropped: exp2f in place of exp2_ftz, and no fences
// (chip_smoke.py --tiled-variants times both against this file); with no
// time kept here, all slower: a third barrier a window, so that q and K of
// window t + 1 are issued right after window t's Q . K^T (with a second
// buffer of ids; 255 registers); the bias read from L2 at every score for
// three blocks an SM at 170 registers (it spilled); each row tile split over
// a pair of warps with half the keys each (max, sum and O exchanged through
// shared memory; 8 warps a block; capped at 128 registers it spilled).
// float32: the CUDA-core structure of the fused QKV forward's f32 kernel (32
// query rows a block, 128 threads, key tiles of 64, two passes), for the f32
// bars.

constexpr int kLargeMaxN = wtc::kMaxN;  // ws <= 16
constexpr int kF32Rows = 32;            // query rows a block (f32)
constexpr int kF32Tile = 64;            // keys a tile (f32)
constexpr int kF32Threads = 128;        // four a row

// Shared memory of the bf16 kernel: the bias in fragment order (per warp and
// group of 32 keys, 2 row halves x 2 pieces x 32 lanes of float4), the q
// rows [64][DP], K and V [256][DP] in the key order (keys past N zeros), the
// rows' pixel offsets [N] int (row_offset), then the window's region ids [N]
// int (shifted).
template <int DP>
struct LargeSmem {
  static constexpr size_t bytes(bool masked) {
    return sizeof(float4) * wtc::kMaxWarps * wtc::kMaxGroups * 128 +
           sizeof(tc::bf16) * (wtc::kRows + 2 * wtc::kMaxN) * DP + sizeof(int) * kLargeMaxN * (masked ? 2 : 1);
  }
};

template <int DP, bool kShifted, bool kStash>
__global__ void __launch_bounds__(wtc::kThreads, 2) window_attention_fwd_large_tc_kernel(Args a) {
  using namespace tc;
  constexpr int kNT = wtc::kNT, kG = wtc::kMaxGroups, kKeys = wtc::kMaxN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* bias_s = reinterpret_cast<float4*>(smem_raw);                          // [4][kG][2][2][32]
  bf16* qs = reinterpret_cast<bf16*>(bias_s + wtc::kMaxWarps * kG * 128);       // [64][DP]
  bf16* ks = qs + wtc::kRows * DP;                                               // [256][DP], key order
  bf16* vs = ks + kKeys * DP;                                                    // [256][DP], key order
  int* off_s = reinterpret_cast<int*>(vs + kKeys * DP);                          // [N]
  int* ids_s = off_s + kLargeMaxN;                                               // [N], shifted

  const int n = a.n, d = a.d, c = a.heads * d;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int m_block = blockIdx.z * wtc::kRows, m0 = m_block + warp * kWarpRows;  // the block's and the warp's first row
  const bool active = m0 < n;
  const int t0 = blockIdx.x * a.per_chunk, count = min(a.per_chunk, a.total - t0);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const int hw = a.h_img * a.w_img;
  const bf16* src = static_cast<const bf16*>(a.qkv) + h * d;
  const wtc::Lanes<DP> lanes(lane);
  // the rows of this thread's fragments; rows past N take row N - 1's bias
  // and id (finite scores, never stored)
  const int rowc[2] = {min(m0 + g, n - 1), min(m0 + g + 8, n - 1)};

  // bias * log2(e) at this thread's fragment positions, read and written by
  // this thread alone: slot ((m * 2 + r) * 2 + jp) * 32 + lane holds keys
  // 32m + 8tq + 4jp .. + 3 of row half r (C tiles 4m + 2jp and 4m + 2jp + 1);
  // -inf past N
  float4* bias_t = bias_s + warp * kG * 128 + lane;
  if (active) {
    const float* bias_h = a.bias + static_cast<int64_t>(h) * n * n;
    for (int m = 0; m < kG; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int key = m * wtc::kGroup + 8 * tq + 4 * jp;
          const float* row = bias_h + static_cast<int64_t>(rowc[r]) * n + key;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = key + e < n ? __ldg(row + e) * kLog2e : -INFINITY;
          bias_t[((m * 2 + r) * 2 + jp) * 32] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
  wtc::fill_offsets<kShifted>(off_s, n, a.ws, a.w_img);
  __syncthreads();

  // a window's q rows and K (and its region ids), and its V
  using Walk = wtc::WindowWalk<kShifted>;
  auto load_qk = [&](const Walk& win_t) {
    const bf16* win = src + win_t.base * row_stride;
    auto offset = [&](int r) { return win_t.at(off_s[r], hw, a.w_img); };
    wtc::stage<DP, wtc::kRows>(qs, win, offset, row_stride, [&](int r) { return m_block + r; }, n, d, a.aligned);
    wtc::stage<DP, kKeys>(ks, win + c, offset, row_stride, [](int r) { return wtc::perm(r); }, n, d, a.aligned);
    if (kShifted) {
      const int* ids = a.ids + static_cast<int64_t>(win_t.w) * n;
      for (int r = threadIdx.x; r < n; r += wtc::kThreads) cp_async4(ids_s + r, ids + r, 4);
    }
  };
  auto load_v = [&](const Walk& win_t) {
    const bf16* win = src + win_t.base * row_stride;
    auto offset = [&](int r) { return win_t.at(off_s[r], hw, a.w_img); };
    wtc::stage<DP, kKeys>(vs, win + 2 * c, offset, row_stride, [](int r) { return wtc::perm(r); }, n, d, a.aligned);
  };

  // Two barriers a window: V of window t arrives during its Q . K^T and
  // softmax, q and K of window t + 1 during its P . V.
  Walk walk = window_at<kShifted>(a, t0);  // window t
  load_qk(walk);
  cp_async_commit();
  for (int i = 0; i < count; ++i) {
    const int t = t0 + i;
    const int* ids = ids_s;
    Walk next = walk;
    next.next(a.n_win, a.n_win_x, a.ws, a.h_img, a.w_img, a.shift);
    cp_async_wait<0>();
    __syncthreads();  // q, K and ids of window t have arrived; every warp is done with V of window t - 1
    load_v(walk);
    cp_async_commit();

    float s[kNT][4];  // this warp's scores, then P, in the key order
    bool mixed = false;  // region ids that differ within the window
    int id_row[2] = {0, 0};
    if (active) {
      uint32_t qa[DP / 16][4];
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qa[kk], qs + lanes.a[kk] + warp * kWarpRows * DP);
      if (kShifted) {
        const int id0 = ids[0];
        bool diff = false;
        for (int r = lane; r < n; r += 32) diff |= ids[r] != id0;
        mixed = __any_sync(0xffffffffu, diff);
        id_row[0] = ids[rowc[0]];
        id_row[1] = ids[rowc[1]];
      }
      // S = q . K^T in the key order
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
          if ((np & 3) == 3) __syncwarp();  // keeps ptxas from hoisting every step's loads
        }
      }
    }

    uint32_t pa[kNT / 2][4];  // P in A fragments, 16 positions of the key order each
    if (active) {
      // scaled after the sum, + bias [+ region mask]; row max over four
      // partial maxima (past N the bias is -inf, whatever the ids there add)
      float mp[2][4] = {{-INFINITY, -INFINITY, -INFINITY, -INFINITY}, {-INFINITY, -INFINITY, -INFINITY, -INFINITY}};
#pragma unroll
      for (int m = 0; m < kG; ++m) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            const float4 b = bias_t[((m * 2 + r) * 2 + jp) * 32];
            const float bv[4] = {b.x, b.y, b.z, b.w};
            const int j = 4 * m + 2 * jp;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& x = s[j + (e >> 1)][2 * r + (e & 1)];
              x = x * a.q_mul + bv[e];
            }
            if (kShifted && mixed) {
              const int4 v = *reinterpret_cast<const int4*>(ids + m * wtc::kGroup + 8 * tq + 4 * jp);
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
      // P = exp2(S - max) * (1 / sum) over four partial sums, rounded to bf16
      // into A fragments
      float mx[2], lp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
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
      float il[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) il[r] = 1.f / row_sum((lp[r][0] + lp[r][1]) + (lp[r][2] + lp[r][3]));
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[2 * kk][e] *= il[e >> 1];
          s[2 * kk + 1][e] *= il[e >> 1];
        }
        a_from_c(pa[kk], s[2 * kk], s[2 * kk + 1]);
      }

      if (kStash) {  // this (window, head)'s N x N tile, contiguous in [B, nW, heads, N, N]
        bf16* ptile = static_cast<bf16*>(a.p) + (static_cast<int64_t>(t) * a.heads + h) * n * n;
        if (a.p_aligned) {  // N a multiple of 8: a piece's 8 keys are all < N or all past it
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = m0 + g + 8 * r;
            bf16* dst = ptile + static_cast<int64_t>(row) * n + 8 * tq;
#pragma unroll
            for (int m = 0; m < kG; ++m) {
              if (row < n && m * wtc::kGroup + 8 * tq < n) {
                *reinterpret_cast<uint4*>(dst + m * wtc::kGroup) = wtc::p_piece(pa, m, r);
              }
            }
          }
        } else {
#pragma unroll
          for (int m = 0; m < kG; ++m) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = m0 + g + 8 * r, key = m * wtc::kGroup + 8 * tq;
              const uint4 v = wtc::p_piece(pa, m, r);
              const uint32_t w[4] = {v.x, v.y, v.z, v.w};
              bf16* dst = ptile + static_cast<int64_t>(row) * n + key;
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                if (row < n && key + e < n) {
                  dst[e] = __ushort_as_bfloat16(static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1))));
                }
              }
            }
          }
        }
      }
    }

    cp_async_wait<0>();
    __syncthreads();  // V of window t has arrived; every warp is done with q, K and ids of window t
    if (i + 1 < count) load_qk(next);
    cp_async_commit();

    if (active) {  // O = P . V over two partial sums, rounded to bf16 into the rows' pixels
      float o[2][DP / 8][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) o[x][j][0] = o[x][j][1] = o[x][j][2] = o[x][j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        wtc::accumulate<DP, false>(o[kk & 1], pa[kk], pa[kk], vs, lanes, kk);
        if ((kk & 3) == 3) __syncwarp();
      }
      bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + g + 8 * r;
        if (row >= n) continue;
        bf16* dst = out + (walk.base + walk.at(off_s[row], hw, a.w_img)) * c + h * d;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + 2 * tq;
          const float x0 = o[0][j][2 * r] + o[1][j][2 * r], x1 = o[0][j][2 * r + 1] + o[1][j][2 * r + 1];
          if (a.aligned) {
            if (col < d) *reinterpret_cast<uint32_t*>(dst + col) = pack(x0, x1);
          } else {
            if (col < d) dst[col] = __float2bfloat16(x0);
            if (col + 1 < d) dst[col + 1] = __float2bfloat16(x1);
          }
        }
      }
    }
    walk = next;
  }
}

// Rows [r0, r0 + ROWS) of a window's q, k or v head slice (src = its column
// in row 0's pixel; offset(r) the element offset of row r's pixel) into
// shared memory as f32 times mul (row stride ld), zeros past N and past d.
template <int DP, int ROWS, typename Offset>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld, const float* src, Offset offset, int r0, int n,
                                              int d, float mul) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += blockDim.x) {
    const int r = idx / DP, cc = idx - r * DP;
    const int row = r0 + r;
    dst[r * ld + cc] = row < n && cc < d ? src[offset(row) + cc] * mul : 0.f;
  }
}

// Shared memory of the f32 kernel, in floats: q [32][DP + 1] (scaled by
// scale * log2(e)), K [64][DP + 1], V [64][DP], P [32][65], then the
// window's region ids [kLargeMaxN] int.
template <int DP>
struct F32LargeSmem {
  static constexpr int kQ = kF32Rows * (DP + 1), kK = kF32Tile * (DP + 1), kV = kF32Tile * DP;
  static constexpr int kP = kF32Rows * (kF32Tile + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP) + sizeof(int) * kLargeMaxN;
};

// Thread t owns query row t / 4 and, of each key tile, the keys (t % 4) + 4j,
// j < 16; for P . V the dims (t % 4) + 4i.
template <int DP, bool kShifted, bool kStash>
__global__ void __launch_bounds__(kF32Threads) window_attention_fwd_large_kernel(Args a) {
  using S = F32LargeSmem<DP>;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + S::kQ;
  float* vs = ks + S::kK;
  float* ps = vs + S::kV;
  int* ids_s = reinterpret_cast<int*>(ps + S::kP);
  constexpr int kLdP = kF32Tile + 1;

  const int n = a.n, d = a.d, c = a.heads * d;
  const int t = blockIdx.x, h = blockIdx.y, m0 = blockIdx.z * kF32Rows;
  const int r = threadIdx.x / kLanesPerRow, g = threadIdx.x % kLanesPerRow;
  const int row = m0 + r, rr = min(row, n - 1);
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const wtc::WindowWalk<kShifted> win = window_at<kShifted>(a, t);
  const float* q_src = static_cast<const float*>(a.qkv) + h * d;
  auto offset = [&](int x) { return window_row(a, win, x) * row_stride; };

  if (kShifted) {
    const int* ids = a.ids + static_cast<int64_t>(t % a.n_win) * n;
    for (int x = threadIdx.x; x < n; x += kF32Threads) ids_s[x] = ids[x];
  }
  load_rows_f32<DP, kF32Rows>(qs, DP + 1, q_src, offset, m0, n, d, a.q_mul);
  const float* bias_row = a.bias + (static_cast<int64_t>(h) * n + rr) * n;

  // log2-domain scores of row r against the keys k0 + g + 4j (keys past N:
  // -inf)
  float s[kColsPerLane];
  auto scores = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < DP; ++kd) {
      const float q = qs[r * (DP + 1) + kd];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) s[j] = fmaf(q, ks[(g + j * kLanesPerRow) * (DP + 1) + kd], s[j]);
    }
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

  // Pass 1: this thread's running max and sum of exp2 over its keys.
  float m_loc = -INFINITY, l_loc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kF32Tile) {
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32<DP, kF32Tile>(ks, DP + 1, q_src + c, offset, k0, n, d, 1.f);
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
  const float m_row = row_max(m_loc);
  const float inv_l = 1.f / row_sum(m_loc == -INFINITY ? 0.f : l_loc * exp2f(m_loc - m_row));

  // Pass 2: P, then O += P . V.
  constexpr int kDimsPerLane = DP / kLanesPerRow;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
  float* p_tile = kStash ? static_cast<float*>(a.p) + ((static_cast<int64_t>(t) * a.heads + h) * n + m0) * n : nullptr;
  for (int k0 = 0; k0 < n; k0 += kF32Tile) {
    __syncthreads();
    load_rows_f32<DP, kF32Tile>(ks, DP + 1, q_src + c, offset, k0, n, d, 1.f);
    load_rows_f32<DP, kF32Tile>(vs, DP, q_src + 2 * c, offset, k0, n, d, 1.f);
    __syncthreads();
    scores(k0);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) ps[r * kLdP + g + j * kLanesPerRow] = exp2f(s[j] - m_row) * inv_l;
    __syncthreads();
    const int kn = min(kF32Tile, n - k0);
    if (kStash) {
      for (int idx = threadIdx.x; idx < kF32Rows * kF32Tile; idx += kF32Threads) {
        const int pr = idx / kF32Tile, pc = idx - pr * kF32Tile;
        if (m0 + pr < n && pc < kn) p_tile[static_cast<int64_t>(pr) * n + k0 + pc] = ps[pr * kLdP + pc];
      }
    }
    for (int cc = 0; cc < kn; ++cc) {
      const float p = ps[r * kLdP + cc];
      const float* vrow = vs + cc * DP;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[i] = fmaf(p, vrow[g + i * kLanesPerRow], acc[i]);
    }
  }
  if (row < n) {
    float* o = static_cast<float*>(a.out) + window_row(a, win, row) * c + h * d;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) o[dd] = acc[i];
    }
  }
}

// ---------------------------------------------------------------- launches

template <int DP, bool kShifted, bool kStash>
cudaError_t launch_f32_large(const Args& a, cudaStream_t stream) {
  auto kernel = window_attention_fwd_large_kernel<DP, kShifted, kStash>;
  constexpr size_t bytes = F32LargeSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.total, a.heads, (a.n + kF32Rows - 1) / kF32Rows), kF32Threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The bf16 tiled kernel's block: threads and shared-memory bytes, with the
// attributes that let two blocks share an SM set.
template <int DP, bool kShifted, bool kStash>
cudaError_t prepare_tc_large(int* threads, size_t* bytes) {
  auto kernel = window_attention_fwd_large_tc_kernel<DP, kShifted, kStash>;
  *threads = wtc::kThreads;
  *bytes = LargeSmem<DP>::bytes(kShifted);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*bytes));
}

// A grid of (run of windows, head, run of query rows).
template <int DP, bool kShifted, bool kStash>
cudaError_t launch_tc_large(const Args& a, cudaStream_t stream) {
  int threads;
  size_t bytes;
  const cudaError_t err = prepare_tc_large<DP, kShifted, kStash>(&threads, &bytes);
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.total + a.per_chunk - 1) / a.per_chunk;
  window_attention_fwd_large_tc_kernel<DP, kShifted, kStash>
      <<<dim3(n_chunks, a.heads, (a.n + wtc::kRows - 1) / wtc::kRows), threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, bool kShifted, bool kStash>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  auto kernel = window_attention_fwd_kernel<DP, kShifted, kStash>;
  const size_t bytes = smem_bytes<DP>(a.n);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_win, a.heads, a.total / a.n_win), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// A grid of (run of windows, head).
template <int DP, bool kShifted, bool kStash>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  auto kernel = window_attention_fwd_tc_kernel<DP, kShifted, kStash>;
  const size_t bytes = TcSmem<DP, kShifted, kStash>::bytes(a.n);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.total + a.per_chunk - 1) / a.per_chunk;
  kernel<<<dim3(n_chunks, a.heads), kTcThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// float32 -> the CUDA-core kernel, bfloat16 -> the tensor-core kernel; DP is
// the head-dim bucket, then shift regions or none, stash or none.
template <int DP, bool kShifted>
cudaError_t dispatch_stash(const Args& a, int dtype, cudaStream_t s) {
  if (a.n > kMaxN) {  // ws 9 to 16
    if (dtype == 0) {
      return a.p != nullptr ? launch_f32_large<DP, kShifted, true>(a, s) : launch_f32_large<DP, kShifted, false>(a, s);
    }
    return a.p != nullptr ? launch_tc_large<DP, kShifted, true>(a, s) : launch_tc_large<DP, kShifted, false>(a, s);
  }
  if (dtype == 0) return a.p != nullptr ? launch_f32<DP, kShifted, true>(a, s) : launch_f32<DP, kShifted, false>(a, s);
  return a.p != nullptr ? launch_tc<DP, kShifted, true>(a, s) : launch_tc<DP, kShifted, false>(a, s);
}

template <int DP>
cudaError_t dispatch(const Args& a, int dtype, cudaStream_t s) {
  if (a.ids != nullptr) return dispatch_stash<DP, true>(a, dtype, s);
  return dispatch_stash<DP, false>(a, dtype, s);
}

}  // namespace

// qkv: [b, h_img, w_img, 3 * heads * head_dim] of `dtype` (0: float32, 1:
// bfloat16); bias: f32 [heads, ws^2, ws^2]; ids: int32 [nW, ws^2] region ids
// (nW = (h_img / ws) * (w_img / ws), windows row-major) or NULL for unshifted
// windows; shift: the cyclic shift of shifted windows, 0 <= shift < ws, which
// takes ids (0: the caller rolled the map, or unshifted);
// out: [b, h_img, w_img, heads * head_dim] of `dtype`; p: [b, nW,
// heads, ws^2, ws^2] of `dtype` or NULL (no stash). All contiguous, on the
// current device. per_chunk: windows each bf16 block takes, in batch-row-major
// order, for one head (and, for N > 64, one run of query rows; the f32
// kernels take one).
// q_mul = scale * log2(e). Takes ws <= 16 and head_dim <= 64 (ws <= 8 on the
// bodies above, 8 < ws <= 16 on the tiled ones). Returns the CUDA error code
// of the launch (0 on success).
extern "C" int vdk_fused_window_attention_fwd(const void* qkv, const float* bias, const int* ids,
                                              void* out, void* p, int b, int h_img, int w_img,
                                              int heads, int head_dim, int ws, int shift, int per_chunk,
                                              float q_mul, int dtype, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || head_dim < 1 || head_dim > 64 ||
      ws < 1 || ws * ws > kLargeMaxN || h_img < ws || w_img < ws || h_img % ws || w_img % ws ||
      shift < 0 || shift >= ws || (shift > 0 && ids == nullptr) ||
      per_chunk < 1 || bias == nullptr || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_win_x = w_img / ws;
  const int n_win = (h_img / ws) * n_win_x;
  const int c = heads * head_dim;
  const int aligned = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      head_dim % 8 == 0 && c % 8 == 0;
  const int p_aligned = reinterpret_cast<uintptr_t>(p) % 16 == 0 && ws * ws % 8 == 0;
  const Args a{qkv,   bias,    ids,   out,       p,         h_img, w_img,   heads,     head_dim, ws,
               ws * ws, n_win_x, n_win, b * n_win, per_chunk, shift, q_mul, aligned, p_aligned};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = head_dim <= 32 ? dispatch<32>(a, dtype, s) : dispatch<64>(a, dtype, s);
  return static_cast<int>(err);
}

// The bf16 tiled body (N > 64) at head dim `head_dim`, shift regions or none,
// stash or none, for windows of n tokens: its threads a block, dynamic shared
// memory a block, and blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns the CUDA error code (0 on success).
extern "C" int vdk_fused_window_attention_fwd_tiled_occupancy(int head_dim, int masked, int stash, int n,
                                                              int* threads, int* smem_bytes, int* blocks_per_sm) {
  if (head_dim < 1 || head_dim > 64 || n <= kMaxN || n > kLargeMaxN) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = 0;
  cudaError_t err;
  const void* kernel;
#define VDK_CASE(DP, M, S)                                                                  \
  err = prepare_tc_large<DP, M, S>(threads, &bytes);                                        \
  kernel = reinterpret_cast<const void*>(window_attention_fwd_large_tc_kernel<DP, M, S>);
  if (head_dim <= 32) {
    if (masked) {
      if (stash) { VDK_CASE(32, true, true) } else { VDK_CASE(32, true, false) }
    } else {
      if (stash) { VDK_CASE(32, false, true) } else { VDK_CASE(32, false, false) }
    }
  } else {
    if (masked) {
      if (stash) { VDK_CASE(64, true, true) } else { VDK_CASE(64, true, false) }
    } else {
      if (stash) { VDK_CASE(64, false, true) } else { VDK_CASE(64, false, false) }
    }
  }
#undef VDK_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = static_cast<int>(bytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, *threads, bytes));
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
