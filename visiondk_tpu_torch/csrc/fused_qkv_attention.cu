// Fused attention, forward, for Hopper (sm_90a): one stride-generic kernel
// per dtype behind two entries, with an optional stash of the probabilities
// P [B, H, N, N] for the backward.
//
// (K1) vdk_fused_qkv_attention_fwd: [B, N, 3C] -> [B, N, C]. Replaces the
// Pallas TPU kernel visiondk_tpu/ops/pallas/attention.py::_fused_fwd_kernel
// (:198-260) in both of its launches: by _fused_attention_padded (the
// no-stash forward of fused_qkv_attention) and by _fused_vjp_fwd (the
// training forward, which also writes p_ref; K1s here). q, k and v are read
// by strides straight out of the packed QKV-projection buffer (row stride 3C;
// q at column h*d, k at C + h*d, v at 2C + h*d) and O is written at column
// h*d of a [B, N, C] output, so no [B, H, N, D] transpose reaches device
// memory.
//
// (K3) vdk_vision_attention_fwd: q, k, v [B, H, N, D] -> O [B, H, N, D].
// Replaces attention.py::_fwd_kernel (:55-65, launched by _attn_fwd_padded
// under vision_attention). Same kernel: q, k and v are read through any
// (batch, head, token) strides with a unit-stride head dim, O is written
// contiguous, no stash, n_valid = N. The JAX wrapper pads N up to a multiple
// of 128 and masks the padded keys; this kernel computes exactly N rows and
// keys, which is the same result.
//
// Math, per (b, h), as the reference does it (attention.py:229-260):
//   S = scale * log2(e) * (q . k^T) in f32   (log2-domain scores)
//   S[:, j] = -1e30 for keys j >= n_valid
//   P = exp2(S - rowmax) * (1 / rowsum), rounded to the input dtype
//   O = P . v, accumulated in f32, rounded to the input dtype
// Rows >= n_valid hold finite values that callers never read. With the stash
// (kStash), P[b, h, :N, :N] is written exactly as pass 2 forms it: the
// rounded value that multiplies V, 0 at masked keys. The stash only adds
// stores, so O is bit-for-bit the no-stash kernel's. The JAX kernel pads P to
// a multiple of 8 rows and columns; this one writes N x N.
//
// Two passes over the key tiles: pass 1 finds each row's max and sum of
// exp2 (a running max per thread, rescaled as it grows, combined over the
// row's four lanes at the end); pass 2 recomputes the scores, forms the
// normalised P, rounds it and multiplies by V. That rounds P where the
// reference rounds it; a single-pass online softmax would round a P
// normalised by a running sum and rescale O, and is not taken.
//
// What bounds it on the H100, at ViT-B/16 (B 128, N 197, 12 heads, d 64,
// bf16): bytes. q, k, v read once and O written once are 154.9 MB, 46 us at
// 3.35 TB/s; the stash adds 119.2 MB (274.1 MB, 82 us). The products are
// 15.3 GFLOP (30.5 with pass 1's scores twice), 15-31 us at the bf16
// tensor-core peak of 989 TFLOP/s.
//
// bfloat16 (the main path): tensor cores. Each warp owns 16 query rows (the
// M of the MMA); the rows of a (head, batch row) are split over blocks of up
// to 7 warps, as evenly as the 16-row tiles go (tc::split_rows: 2 blocks of
// 7 warps at N = 197, 208 rows computed, 5.3% of them past N; 64-row blocks
// would compute 256, 23%). For d <= 64 three such blocks fit an SM (80
// registers a thread, with a few spills: faster on the H100 than two blocks
// without). Keys go in tiles of 32. S = q . k^T and O = P . v
// are mma.sync m16n8k16 (bf16 in, f32 accumulation); q's fragments stay in
// registers, k's come by ldmatrix and v's by ldmatrix.trans; P goes from the
// score accumulators straight into the A fragments of P . v (attention_tc.cuh)
// and never touches shared memory, unless stashed. q, k and v tiles stay
// bf16 in shared memory, the head dim padded to 32, 64, 80 or 128 with
// zeros (any d <= 128). They arrive by cp.async, 16 bytes a thread, into a
// ring of two stages, so the next key tile loads while this one multiplies;
// a view whose rows are not 16-byte aligned (or d not a multiple of 8) is
// staged element by element into the same bytes, so the result does not
// depend on the path. The stash goes through a per-warp shared tile and is
// stored a row at a time with neighbouring threads on neighbouring keys
// (16-byte stores need rows that start on 16 bytes, which P's row of N = 197
// elements does not give); O goes through the warp's q rows and out in
// 16-byte stores where aligned. Rounding against the reference: the scores
// are the f32 product of the bf16 q and k, scaled by scale * log2(e) in f32
// after the product (the reference scales the upcast q first): the two agree
// within f32 rounding; P is rounded to bf16 before P . v, as the reference's
// .astype(v.dtype) does (attention.py:62, :253).
//
// float32: a CUDA-core kernel, kept for the f32 bars (O 1e-4,
// P 1e-5, the one-step train comparison); TF32 products would not hold them.
// One block per (32 query rows, head, batch row), 128 threads, products out
// of f32 shared memory; scale * log2(e) folded into the q tile. run()
// dispatches on dtype: a bf16 tensor never reaches this kernel.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC --split-compile=0 (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

using tc::View;

constexpr int kThreads = 128;
constexpr int kBlockM = 32;                           // query rows per block
constexpr int kBlockN = 64;                           // keys per tile
constexpr int kLanesPerRow = kThreads / kBlockM;      // 4
constexpr int kColsPerLane = kBlockN / kLanesPerRow;  // 16
constexpr float kMaskValue = -1e30f;                  // the reference's key mask

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

struct FwdArgs {
  View q, k, v, o;
  void* p;  // [B, H, N, N] stash, or null
  int n, heads, d, n_valid;
  float q_mul;  // head_dim**-0.5 * log2(e)
  int p_aligned;  // the stash's rows start on 16 bytes (bf16 kernel)
};

// ---------------------------------------------------------------- float32

// Shared-memory layout in floats; DP is the head dim rounded up to 32, 64 or
// 128. Q and K rows are padded by one float so the column reads of the score
// loop fall in distinct banks.
template <int DP>
struct Smem {
  static constexpr int kQ = kBlockM * (DP + 1);
  static constexpr int kK = kBlockN * (DP + 1);
  static constexpr int kV = kBlockN * DP;
  static constexpr int kP = kBlockM * (kBlockN + 1);
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

// Copies rows [row0, row0 + ROWS) of one head's q, k or v slice into shared
// memory as f32 times `mul`, with zeros for rows >= n and dims >= d.
// Thread t keeps column t % DP and reads rows t / DP + i * kThreads / DP,
// i < ROWS * DP / kThreads. Every load is unconditional: a row >= n reads the
// last real row and a dim >= d the last real dim, and a select stores 0 for
// them. So every thread makes the same, compile-time number of loads with no
// branch between them, and the unrolled loop issues eight before their first
// use (faster on the H100 than a predicated load or 2, 4, 16 or full unrolls;
// PERF.md). row0 < n.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t row_stride,
                                          int row0, int n, int d, float mul) {
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
    dst[r * ld + c] = r < valid ? x * mul : 0.f;
  }
}

// Log2-domain scores of query row r against the keys g + 4j of the K tile.
template <int DP>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks, int r, int g,
                                            float (&s)[kColsPerLane]) {
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) s[j] = 0.f;
#pragma unroll 4
  for (int kd = 0; kd < DP; ++kd) {
    const float q = qs[r * (DP + 1) + kd];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      s[j] = fmaf(q, ks[(g + j * kLanesPerRow) * (DP + 1) + kd], s[j]);
    }
  }
}

template <typename T, int DP, bool kStash>
__global__ void __launch_bounds__(kThreads)
    fused_attention_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + Smem<DP>::kQ;
  float* vs = ks + Smem<DP>::kK;
  float* ps = vs + Smem<DP>::kV;

  const int n = a.n, d = a.d, n_valid = a.n_valid;
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const T* q_src = a.q.head<const T>(b, h);
  const T* k_src = a.k.head<const T>(b, h);
  const T* v_src = a.v.head<const T>(b, h);

  const int r = threadIdx.x / kLanesPerRow;
  const int g = threadIdx.x % kLanesPerRow;

  load_tile<T, DP, kBlockM>(qs, DP + 1, q_src, a.q.sn, m0, n, d, a.q_mul);

  // Pass 1: this thread's running max and sum of exp2 over its keys.
  float s[kColsPerLane];
  float m_loc = -INFINITY;
  float l_loc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP, kBlockN>(ks, DP + 1, k_src, a.k.sn, k0, n, d, 1.f);
    __syncthreads();
    tile_scores<DP>(qs, ks, r, g, s);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int key = k0 + g + j * kLanesPerRow;
      if (key >= n) continue;
      const float sj = key < n_valid ? s[j] : kMaskValue;
      if (sj > m_loc) {
        l_loc = l_loc * exp2f(m_loc - sj) + 1.f;
        m_loc = sj;
      } else {
        l_loc += exp2f(sj - m_loc);
      }
    }
  }
  // Combine the row's four lanes.
  float m_row = m_loc;
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    m_row = fmaxf(m_row, __shfl_xor_sync(0xffffffffu, m_row, off));
  }
  float l_row = m_loc == -INFINITY ? 0.f : l_loc * exp2f(m_loc - m_row);
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    l_row += __shfl_xor_sync(0xffffffffu, l_row, off);
  }
  const float inv_l = 1.f / l_row;

  // Pass 2: P rounded to T, then O += P . V in f32.
  constexpr int kDimsPerLane = DP / kLanesPerRow;
  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    __syncthreads();
    load_tile<T, DP, kBlockN>(ks, DP + 1, k_src, a.k.sn, k0, n, d, 1.f);
    load_tile<T, DP, kBlockN>(vs, DP, v_src, a.v.sn, k0, n, d, 1.f);
    __syncthreads();
    tile_scores<DP>(qs, ks, r, g, s);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int key = k0 + g + j * kLanesPerRow;
      float p = 0.f;
      if (key < n) {
        const float sj = key < n_valid ? s[j] : kMaskValue;
        p = to_float(from_float<T>(exp2f(sj - m_row) * inv_l));
      }
      ps[r * (kBlockN + 1) + g + j * kLanesPerRow] = p;
    }
    __syncthreads();
    const int kn = min(kBlockN, n - k0);
    if (kStash) {
      // P[b, h, m0 + rr, k0 + cc] for the tile's real rows and keys
      T* p_tile = static_cast<T*>(a.p) + ((static_cast<int64_t>(b) * a.heads + h) * n + m0) * n + k0;
      for (int idx = threadIdx.x; idx < kBlockM * kBlockN; idx += kThreads) {
        const int rr = idx / kBlockN;
        const int cc = idx - rr * kBlockN;
        if (m0 + rr < n && cc < kn) {
          p_tile[static_cast<int64_t>(rr) * n + cc] = from_float<T>(ps[rr * (kBlockN + 1) + cc]);
        }
      }
    }
    for (int cc = 0; cc < kn; ++cc) {
      const float p = ps[r * (kBlockN + 1) + cc];
      const float* vrow = vs + cc * DP;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[i] = fmaf(p, vrow[g + i * kLanesPerRow], acc[i]);
    }
  }

  const int row = m0 + r;
  if (row < n) {
    T* o = a.o.head<T>(b, h) + row * a.o.sn;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) o[dd] = from_float<T>(acc[i]);
    }
  }
}

template <int DP, bool kStash>
cudaError_t launch(const FwdArgs& a, int b, cudaStream_t stream) {
  auto kernel = fused_attention_fwd_kernel<float, DP, kStash>;
  constexpr size_t bytes = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBlockM - 1) / kBlockM, a.heads, b);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <bool kStash>
cudaError_t dispatch_dim(const FwdArgs& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch<32, kStash>(a, b, stream);
  if (a.d <= 64) return launch<64, kStash>(a, b, stream);
  return launch<128, kStash>(a, b, stream);
}

// ---------------------------------------------------------------- bfloat16

constexpr int kFwdTile = 32;  // keys per inner tile (a multiple of 16)

// Shared memory of the tensor-core kernel, in bf16 elements: the block's q
// rows (later each warp's O tile), two stages of K and of V, and each warp's
// P tile for the stash.
template <int DP>
struct TcSmem {
  static constexpr int kLd = DP + tc::kPad;
  static constexpr int kLdP = kFwdTile + tc::kPad;
  static constexpr size_t bytes(int warps, bool stash) {
    return sizeof(tc::bf16) * (warps * tc::kWarpRows * kLd + 4 * kFwdTile * kLd +
                               (stash ? warps * tc::kWarpRows * kLdP : 0));
  }
};

// s = q . k^T for a warp's 16 rows and the keys of a K tile in shared memory.
template <int DP>
__device__ __forceinline__ void tile_scores_tc(float (&s)[kFwdTile / 8][4], const uint32_t (&qa)[DP / 16][4],
                                               const tc::bf16* kt, int lane) {
  constexpr int kLd = DP + tc::kPad;
#pragma unroll
  for (int j = 0; j < kFwdTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kFwdTile / 16; ++np) {
      uint32_t kb[4];
      tc::ldmatrix_x4(kb, kt + (np * 16 + tc::b_row(lane)) * kLd + kk * 16 + tc::b_col(lane));
      tc::mma(s[2 * np], qa[kk], kb[0], kb[1]);
      tc::mma(s[2 * np + 1], qa[kk], kb[2], kb[3]);
    }
  }
}

template <int DP, bool kStash>
__global__ void __launch_bounds__(tc::kMaxWarps * 32, DP <= 64 ? 3 : 1)
    fused_attention_fwd_tc_kernel(FwdArgs a) {
  using namespace tc;
  constexpr int kLd = TcSmem<DP>::kLd;
  constexpr int kLdP = TcSmem<DP>::kLdP;
  constexpr int kNT = kFwdTile / 8;  // 8-key n-tiles of a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x >> 5;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + warps * kWarpRows * kLd;  // [2][kFwdTile][kLd]
  bf16* vs = ks + 2 * kFwdTile * kLd;          // [2][kFwdTile][kLd]
  bf16* ps = vs + 2 * kFwdTile * kLd;          // [warps][16][kLdP]

  const int n = a.n, d = a.d, n_valid = a.n_valid;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m_block = blockIdx.x * warps * kWarpRows;
  const int m0 = m_block + warp * kWarpRows;  // this warp's first row
  const bool active = m0 < n;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* k_src = a.k.head<const bf16>(b, h);
  const bf16* v_src = a.v.head<const bf16>(b, h);
  bf16* q_w = qs + warp * kWarpRows * kLd;
  bf16* p_w = ps + warp * kWarpRows * kLdP;

  // Stage i of 2 * tiles: pass 1 (i < tiles) needs the K tile, pass 2 K and V.
  const int tiles = (n + kFwdTile - 1) / kFwdTile;
  auto load = [&](int i) {
    const int k0 = (i < tiles ? i : i - tiles) * kFwdTile;
    stage(ks + (i & 1) * kFwdTile * kLd, kLd, k_src + k0 * a.k.sn, a.k.sn, kFwdTile, DP, n - k0, d, a.k.aligned);
    if (i >= tiles) {
      stage(vs + (i & 1) * kFwdTile * kLd, kLd, v_src + k0 * a.v.sn, a.v.sn, kFwdTile, DP, n - k0, d, a.v.aligned);
    }
  };
  stage(qs, kLd, a.q.head<const bf16>(b, h) + m_block * a.q.sn, a.q.sn, warps * kWarpRows, DP, n - m_block, d,
        a.q.aligned);
  load(0);
  cp_async_commit();

  uint32_t qa[DP / 16][4];
  float m_loc[2] = {-INFINITY, -INFINITY}, l_loc[2] = {0.f, 0.f};  // rows g, g + 8
  float m_row[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
  float o[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < 2 * tiles; ++i) {
    if (i + 1 < 2 * tiles) {
      load(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) ldmatrix_x4(qa[kk], q_w + a_row(lane) * kLd + kk * 16 + a_col(lane));
    }
    if (i == tiles) {  // combine the row's four lanes
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
    if (active) {
      const int k0 = (i < tiles ? i : i - tiles) * kFwdTile;
      float s[kNT][4];
      tile_scores_tc<DP>(s, qa, ks + (i & 1) * kFwdTile * kLd, lane);
      // log2-domain scores: scaled in f32 after the product; masked keys at
      // -1e30 as the reference; keys past N out of the row (-inf)
      if (k0 + kFwdTile <= n_valid) {  // every key of the tile is real and unmasked
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= a.q_mul;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            s[j][e] = key >= n ? -INFINITY : key >= n_valid ? kMaskValue : s[j][e] * a.q_mul;
          }
        }
      }
      if (i < tiles) {  // pass 1: running max and sum of exp2 of this thread's keys
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
      } else {  // pass 2: P rounded to bf16 as A fragments, O += P . V
        uint32_t pa[kFwdTile / 16][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - m_row[e >> 1]) * inv_l[e >> 1];
        }
#pragma unroll
        for (int kk = 0; kk < kFwdTile / 16; ++kk) a_from_c(pa[kk], s[2 * kk], s[2 * kk + 1]);
        if (kStash) {
#pragma unroll
          for (int kk = 0; kk < kFwdTile / 16; ++kk) {
            const int c = kk * 16 + 2 * t;
            *reinterpret_cast<uint32_t*>(p_w + g * kLdP + c) = pa[kk][0];
            *reinterpret_cast<uint32_t*>(p_w + (g + 8) * kLdP + c) = pa[kk][1];
            *reinterpret_cast<uint32_t*>(p_w + g * kLdP + c + 8) = pa[kk][2];
            *reinterpret_cast<uint32_t*>(p_w + (g + 8) * kLdP + c + 8) = pa[kk][3];
          }
          __syncwarp();
          bf16* p_dst = static_cast<bf16*>(a.p) + ((static_cast<int64_t>(b) * a.heads + h) * n + m0) * n + k0;
          unstage(p_dst, n, p_w, kLdP, min(kWarpRows, n - m0), n - k0, kFwdTile, a.p_aligned, lane, 32);
          __syncwarp();
        }
        const bf16* vt = vs + (i & 1) * kFwdTile * kLd;
#pragma unroll
        for (int kk = 0; kk < kFwdTile / 16; ++kk) accumulate_tn<DP, false>(o, pa[kk], pa[kk], vt, kLd, kk, lane);
      }
    }
    __syncthreads();  // this stage's buffers are free for stage i + 2
  }

  if (active) {  // O through the warp's q rows, then out
    c_to_smem<DP / 8>(q_w, kLd, o, 1.f, lane);
    __syncwarp();
    unstage(a.o.head<bf16>(b, h) + m0 * a.o.sn, a.o.sn, q_w, kLd, min(kWarpRows, n - m0), d, DP, a.o.aligned,
            lane, 32);
  }
}

template <int DP, bool kStash>
cudaError_t launch_tc(const FwdArgs& a, int b, cudaStream_t stream) {
  auto kernel = fused_attention_fwd_tc_kernel<DP, kStash>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(TcSmem<DP>::bytes(tc::kMaxWarps, kStash)));
  if (err != cudaSuccess) return err;
  const tc::Split sp = tc::split_rows(a.n);
  kernel<<<dim3(sp.blocks, a.heads, b), sp.warps * 32, TcSmem<DP>::bytes(sp.warps, kStash), stream>>>(a);
  return cudaGetLastError();
}

template <bool kStash>
cudaError_t dispatch_dim_tc(const FwdArgs& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch_tc<32, kStash>(a, b, stream);
  if (a.d <= 64) return launch_tc<64, kStash>(a, b, stream);
  if (a.d <= 80) return launch_tc<80, kStash>(a, b, stream);
  return launch_tc<128, kStash>(a, b, stream);
}

// float32 -> the CUDA-core kernel, bfloat16 -> the tensor-core kernel.
int run(FwdArgs a, int b, int dtype, void* stream) {
  if (b < 1 || b > 65535 || a.n < 1 || a.heads < 1 || a.heads > 65535 || a.d < 1 || a.d > 128 ||
      a.n_valid < 1 || a.n_valid > a.n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stash = a.p != nullptr;
  switch (dtype) {
    case 0:
      return static_cast<int>(stash ? dispatch_dim<true>(a, b, s) : dispatch_dim<false>(a, b, s));
    case 1:
      tc::mark_aligned(a.q, a.d);
      tc::mark_aligned(a.k, a.d);
      tc::mark_aligned(a.v, a.d);
      tc::mark_aligned(a.o, a.d);
      a.p_aligned = reinterpret_cast<uintptr_t>(a.p) % 16 == 0 && a.n % 8 == 0;
      return static_cast<int>(stash ? dispatch_dim_tc<true>(a, b, s) : dispatch_dim_tc<false>(a, b, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

size_t elem_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// qkv: [b, n, 3 * heads * head_dim] contiguous, out: [b, n, heads * head_dim]
// contiguous, p: [b, heads, n, n] contiguous or NULL (no stash), all of
// `dtype` (0: float32, 1: bfloat16), on the current device. q_mul =
// head_dim**-0.5 * log2(e). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int vdk_fused_qkv_attention_fwd(const void* qkv, void* out, void* p, int b, int n,
                                           int heads, int head_dim, int n_valid, float q_mul,
                                           int dtype, void* stream) {
  const int64_t c = static_cast<int64_t>(heads) * head_dim;
  const int64_t rs = 3 * c;  // row stride of the packed buffer
  const char* base = static_cast<const char*>(qkv);
  const size_t col = c * elem_bytes(dtype);
  const FwdArgs a{{base, n * rs, head_dim, rs},
                  {base + col, n * rs, head_dim, rs},
                  {base + 2 * col, n * rs, head_dim, rs},
                  {out, n * c, head_dim, c},
                  p, n, heads, head_dim, n_valid, q_mul};
  return run(a, b, dtype, stream);
}

// q, k, v: [b, heads, n, head_dim] with element strides (sb, sh, sn) each and a
// unit-stride head dim; out: [b, heads, n, head_dim] contiguous; all of
// `dtype` (0: float32, 1: bfloat16), on the current device. No stash, no key
// mask. q_mul = head_dim**-0.5 * log2(e). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int vdk_vision_attention_fwd(const void* q, int64_t q_sb, int64_t q_sh, int64_t q_sn,
                                        const void* k, int64_t k_sb, int64_t k_sh, int64_t k_sn,
                                        const void* v, int64_t v_sb, int64_t v_sh, int64_t v_sn,
                                        void* out, int b, int n, int heads, int head_dim,
                                        float q_mul, int dtype, void* stream) {
  const int64_t nd = static_cast<int64_t>(n) * head_dim;
  const FwdArgs a{{q, q_sb, q_sh, q_sn},
                  {k, k_sb, k_sh, k_sn},
                  {v, v_sb, v_sh, v_sn},
                  {out, heads * nd, nd, head_dim},
                  nullptr, n, heads, head_dim, n, q_mul};
  return run(a, b, dtype, stream);
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
