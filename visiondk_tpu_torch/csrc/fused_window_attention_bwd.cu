// Fused window attention, backward: (qkv [B, H, W, 3C], dO [B, H, W, C], P)
// -> (dqkv [B, H, W, 3C], dbias [heads, N, N] f32), for Hopper (sm_90a), in
// two variants.
//
// Replaces the Pallas TPU kernels of visiondk_tpu/ops/pallas/window_attention.py::
// _wattn_vjp_bwd: _wattn_bwd_from_p_kernel (K2b, the default, which reads the
// probabilities the forward stashed) and _wattn_bwd_kernel (K2r, the
// recompute backward, chosen by VDK_ATTN_NO_PCACHE=1). Same layout contract
// as the forward: row r of window (wy, wx) is pixel (wy*ws + r / ws,
// wx*ws + r % ws); q, k, v are read by strides out of [B, H, W, 3C], dO out
// of [B, H, W, C], and dq, dk, dv are written to the same pixel's column
// blocks of dqkv (q at h*d, k at C + h*d, v at 2C + h*d) in the input dtype.
//
// Math, per (window, head, batch row), as the reference does it
// (window_attention.py:293-396), all in f32 from upcast operands:
//   from P:     P = the stash, upcast (the region mask is implicit in it)
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
// What bounds it. Per window: four products of depth d over N^2 pairs (five
// when recomputing P), and qkv, dO, P in and dqkv out (Swin-B stage 0, bf16,
// bs 80: 193 + 64 + 98 MB in, 193 MB out, about 0.16 ms of HBM traffic). A
// block's windows run one after another, each a load, two synchronisations
// and a few thousand multiply-adds per thread, so the latency of each
// window's loads is hidden only by the other blocks on the SM. What the
// design does: dS, P and the partition never leave the SM; the run length is
// chosen so that about eight blocks fall on each SM; shared memory is sized
// by N (about 46 KB at N = 49, d = 32). Tensor-core products and overlapping
// one window's loads with the previous window's work are later work.
//
// Threads: 256 per block. In the first phase thread t owns query row t / 4
// and keys (t % 4) + 4j, j < 16, as the forward; in the second it owns row
// t / 4 as a query (dQ) and as a key (dK, dV), and the dims (t % 4) + 4i.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;                           // ws <= 8
constexpr int kLanesPerRow = kThreads / kMaxN;      // 4
constexpr int kColsPerLane = kMaxN / kLanesPerRow;  // 16
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskValue = -144.26950408889634f;  // -100 * log2(e), the reference's region mask

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
};

// Shared memory in floats: q, k, v, dO [N][DP + 1], P and dS [N][N + 1],
// then N ints of region ids.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (4 * n * (DP + 1) + 2 * n * (n + 1)) + sizeof(int) * n;
}

template <typename T, int DP, bool kMasked, bool kRecompute>
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
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* dout = static_cast<const T*>(a.dout);
  T* dqkv = static_cast<T*>(a.dqkv);

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
        const T* src = qkv + px * row_stride + h * d + cc;
        qv = to_float(src[0]);
        kv = to_float(src[c]);
        vv = to_float(src[2 * c]);
        dv = to_float(dout[px * c + h * d + cc]);
      }
      qs[row * ld + cc] = qv;
      ks[row * ld + cc] = kv;
      vs[row * ld + cc] = vv;
      dos[row * ld + cc] = dv;
    }
    if (!kRecompute) {
      const T* p_tile = static_cast<const T*>(a.p) +
                        ((static_cast<int64_t>(b) * a.n_win + w) * a.heads + h) * n * n;
      for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
        const int pr = idx / n;
        ps[pr * lp + idx - pr * n] = to_float(p_tile[idx]);
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
      T* dst = dqkv + pixel(r) * row_stride + h * d;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const int dd = g + i * kLanesPerRow;
        if (dd < d) {
          dst[dd] = from_float<T>(aq[i] * a.scale);
          dst[c + dd] = from_float<T>(ak[i] * a.scale);
          dst[2 * c + dd] = from_float<T>(av[i]);
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

template <typename T, int DP, bool kMasked, bool kRecompute>
cudaError_t launch(const Args& a, float* dbias, cudaStream_t stream) {
  auto kernel = window_attention_bwd_kernel<T, DP, kMasked, kRecompute>;
  const size_t bytes = smem_bytes<DP>(a.n);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int n_chunks = (a.total + a.per_chunk - 1) / a.per_chunk;
  kernel<<<dim3(n_chunks, a.heads), kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = a.heads * a.n * a.n;
  dbias_sum_kernel<<<(count + kSumThreads - 1) / kSumThreads, kSumThreads, 0, stream>>>(
      a.dbias_part, dbias, n_chunks, count);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dispatch_variant(const Args& a, float* dbias, cudaStream_t stream) {
  if (a.p != nullptr) return launch<T, DP, false, false>(a, dbias, stream);
  if (a.ids != nullptr) return launch<T, DP, true, true>(a, dbias, stream);
  return launch<T, DP, false, true>(a, dbias, stream);
}

template <typename T>
cudaError_t dispatch_dim(const Args& a, float* dbias, cudaStream_t stream) {
  if (a.d <= 32) return dispatch_variant<T, 32>(a, dbias, stream);
  return dispatch_variant<T, 64>(a, dbias, stream);
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
      (p == nullptr && bias == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_win_x = w_img / ws;
  const int n_win = (h_img / ws) * n_win_x;
  const Args a{qkv,   bias,  ids,   p,        dout,    dqkv,  dbias_part, h_img,     w_img,
               heads, head_dim, ws, ws * ws, n_win_x, n_win, b * n_win,  per_chunk, q_mul,
               scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_dim<float>(a, dbias, s));
    case 1:
      return static_cast<int>(dispatch_dim<__nv_bfloat16>(a, dbias, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
