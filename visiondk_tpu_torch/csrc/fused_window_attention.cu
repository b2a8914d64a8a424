// Fused window attention, forward: qkv [B, H, W, 3C] -> O [B, H, W, C], for
// Hopper (sm_90a), with an optional stash of the probabilities
// P [B, nW, heads, N, N] for the backward.
//
// Replaces the Pallas TPU kernel visiondk_tpu/ops/pallas/window_attention.py::
// _wattn_fwd_kernel in both of its launches: by _wattn_fwd (K2, the no-stash
// forward of fused_window_attention) and by _wattn_vjp_fwd (K2s, the training
// forward, which also writes p_ref; the window pairing of VDK_WATTN_PAIR > 1
// is TPU layout machinery and is not ported). It keeps that kernel's layout
// contract and does the window partition itself: row r of window (wy, wx) is
// pixel (wy*ws + r / ws, wx*ws + r % ws) of the [B, H, W, 3C] buffer, read by
// strides (q at column h*d, k at C + h*d, v at 2C + h*d), and O is written
// back to the same pixel of [B, H, W, C]. No partition or reverse copy ever
// reaches device memory.
//
// Math, per (window, head, batch row), as the reference does it
// (window_attention.py:224-290), all in f32 from upcast operands:
//   S = (q * scale * log2(e)) . k^T + bias_h * log2(e)      (log2 domain)
//   S += -100 * log2(e) where the region ids of query and key differ
//        (shifted windows only; the unshifted variant does no mask work)
//   P = exp2(S - rowmax) * (1 / rowsum), rounded to the input dtype
//   O = P . v, accumulated in f32, rounded to the input dtype
// With the stash (kStash), P is written from where it is formed, the rounded
// value that multiplies V; the stash only adds stores, so O is bit-for-bit
// the no-stash kernel's.
//
// What bounds it. A window is tiny (Swin: N = 49 tokens, d = 32), so the
// whole (window, head) fits in one block: q, k, v take 3 * 49 * 32 values
// and the scores 49 * 49. The work per block is two products of depth 32 over
// 49^2 pairs and the softmax's exp2 on each pair; the bytes are qkv in, O out
// and, with the stash, P out (Swin-B stage 0, bf16, bs 80: 193 MB in, 64 MB
// out, 98 MB of P). So on this card it is memory-bound at the sizes Swin
// runs (about 0.1 ms of HBM traffic at stage 0), provided enough windows are
// in flight to hide each block's load latency. What the design does: one
// pass over the row (a whole row of scores fits in registers, so there is no
// running max and no second pass); the scores, the mask and the partition
// never leave the SM; the bias tile is read from global memory, where every
// block of a head reads the same [N, N] f32 tile out of L2; shared memory is
// sized by N (about 32 KB at N = 49, d = 32), so several blocks share an SM.
// Products run on CUDA cores out of shared memory; tensor-core products and
// several windows per block are later work.
//
// Grid: one block per (window, head, batch row); 256 threads. Thread t owns
// window row t / 4 and the keys (t % 4) + 4j, j < 16; for P . V it owns the
// output dims (t % 4) + 4i. The four threads of a row are adjacent lanes, so
// row reductions are two xor-shuffles. Rows >= N idle (N = 49: 15 of 64).
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
  const void* qkv;    // [B, H, W, 3C]
  const float* bias;  // [heads, N, N]
  const int* ids;     // [nW, N] region ids, or NULL (unshifted)
  void* out;          // [B, H, W, C]
  void* p;            // [B, nW, heads, N, N], or NULL (no stash)
  int h_img, w_img, heads, d, ws, n, n_win_x, n_win;
  float q_mul;  // scale * log2(e)
};

// Shared memory in floats: q and k [N][DP + 1] (the pad puts the column reads
// of the score loop in distinct banks), v [N][DP], P [N][N + 1], then N ints
// of region ids.
template <int DP>
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return sizeof(float) * (2 * n * (DP + 1) + n * DP + n * (n + 1)) + sizeof(int) * n;
}

template <typename T, int DP, bool kMasked, bool kStash>
__global__ void __launch_bounds__(kThreads) window_attention_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int n = a.n, d = a.d, ws = a.ws;
  const int lp = n + 1;
  float* qs = smem;
  float* ks = qs + n * (DP + 1);
  float* vs = ks + n * (DP + 1);
  float* ps = vs + n * DP;
  int* id_s = reinterpret_cast<int*>(ps + n * lp);

  const int w = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wy = w / a.n_win_x;
  const int wx = w - wy * a.n_win_x;
  const int c = a.heads * d;
  // the pixel of window row r, as an index into the [B, H, W] grid
  auto pixel = [&](int r) -> int64_t {
    const int ry = r / ws;
    return (static_cast<int64_t>(b) * a.h_img + wy * ws + ry) * a.w_img + wx * ws + (r - ry * ws);
  };

  const T* qkv = static_cast<const T*>(a.qkv);
  for (int idx = threadIdx.x; idx < n * DP; idx += kThreads) {
    const int r = idx / DP;
    const int cc = idx - r * DP;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (cc < d) {
      const T* src = qkv + pixel(r) * (3 * static_cast<int64_t>(c)) + h * d + cc;
      qv = to_float(src[0]) * a.q_mul;
      kv = to_float(src[c]);
      vv = to_float(src[2 * c]);
    }
    qs[r * (DP + 1) + cc] = qv;
    ks[r * (DP + 1) + cc] = kv;
    vs[r * DP + cc] = vv;
  }
  if (kMasked) {
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
  const int my_id = kMasked ? id_s[rr] : 0;
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int key = g + j * kLanesPerRow;
    if (key < n) {
      float sj = s[j] + bias_row[key] * kLog2e;
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
    s[j] = key < n ? exp2f(s[j] - m) : 0.f;
    l += s[j];
  }
  const float inv_l = 1.f / row_sum(l);
  if (live) {
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int key = g + j * kLanesPerRow;
      if (key < n) ps[r * lp + key] = to_float(from_float<T>(s[j] * inv_l));
    }
  }
  __syncthreads();

  if (kStash) {
    // this (window, head)'s N x N tile of P, contiguous in [B, nW, heads, N, N]
    T* p_tile = static_cast<T*>(a.p) +
                ((static_cast<int64_t>(b) * a.n_win + w) * a.heads + h) * n * n;
    for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
      const int pr = idx / n;
      p_tile[idx] = from_float<T>(ps[pr * lp + idx - pr * n]);
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
    T* o = static_cast<T*>(a.out) + pixel(r) * c + h * d;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) o[dd] = from_float<T>(acc[i]);
    }
  }
}

template <typename T, int DP, bool kMasked, bool kStash>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  auto kernel = window_attention_fwd_kernel<T, DP, kMasked, kStash>;
  const size_t bytes = smem_bytes<DP>(a.n);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_win, a.heads, b), kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP, bool kMasked>
cudaError_t dispatch_stash(const Args& a, int b, cudaStream_t stream) {
  if (a.p != nullptr) return launch<T, DP, kMasked, true>(a, b, stream);
  return launch<T, DP, kMasked, false>(a, b, stream);
}

template <typename T, int DP>
cudaError_t dispatch_mask(const Args& a, int b, cudaStream_t stream) {
  if (a.ids != nullptr) return dispatch_stash<T, DP, true>(a, b, stream);
  return dispatch_stash<T, DP, false>(a, b, stream);
}

template <typename T>
cudaError_t dispatch_dim(const Args& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return dispatch_mask<T, 32>(a, b, stream);
  return dispatch_mask<T, 64>(a, b, stream);
}

}  // namespace

// qkv: [b, h_img, w_img, 3 * heads * head_dim] of `dtype` (0: float32, 1:
// bfloat16); bias: f32 [heads, ws^2, ws^2]; ids: int32 [nW, ws^2] region ids
// (nW = (h_img / ws) * (w_img / ws), windows row-major) or NULL for unshifted
// windows; out: [b, h_img, w_img, heads * head_dim] of `dtype`; p: [b, nW,
// heads, ws^2, ws^2] of `dtype` or NULL (no stash). All contiguous, on the
// current device. q_mul = scale * log2(e). Takes ws <= 8 and head_dim <= 64.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int vdk_fused_window_attention_fwd(const void* qkv, const float* bias, const int* ids,
                                              void* out, void* p, int b, int h_img, int w_img,
                                              int heads, int head_dim, int ws, float q_mul,
                                              int dtype, void* stream) {
  if (b < 1 || b > 65535 || heads < 1 || heads > 65535 || head_dim < 1 || head_dim > 64 ||
      ws < 1 || ws * ws > kMaxN || h_img < ws || w_img < ws || h_img % ws || w_img % ws ||
      bias == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_win_x = w_img / ws;
  const Args a{qkv,   bias,    ids,     out,     p,    h_img, w_img, heads, head_dim, ws, ws * ws,
               n_win_x, (h_img / ws) * n_win_x, q_mul};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_dim<float>(a, b, s));
    case 1:
      return static_cast<int>(dispatch_dim<__nv_bfloat16>(a, b, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
