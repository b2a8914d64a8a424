// Fused QKV attention, forward: [B, N, 3C] -> [B, N, C], for Hopper (sm_90a),
// with an optional stash of the probabilities P [B, H, N, N] for the backward.
//
// Replaces the Pallas TPU kernel visiondk_tpu/ops/pallas/attention.py::
// _fused_fwd_kernel in both of its launches: by _fused_attention_padded (the
// no-stash forward of fused_qkv_attention) and by _fused_vjp_fwd (the
// training forward, which also writes p_ref). It keeps that kernel's layout
// contract:
// q, k and v are read by strides straight out of the packed QKV-projection
// buffer (row stride 3C; q at column h*d, k at C + h*d, v at 2C + h*d) and O
// is written at column h*d of a [B, N, C] output, so no [B, H, N, D]
// transpose ever reaches device memory.
//
// Math, per (b, h), as the reference does it (attention.py:229-260):
//   S = (q * scale * log2(e)) . k^T in f32   (log2-domain scores; q, k upcast)
//   S[:, j] = -1e30 for keys j >= n_valid
//   P = exp2(S - rowmax) * (1 / rowsum), rounded to the input dtype
//   O = P . v, accumulated in f32, rounded to the input dtype
// Rows >= n_valid hold finite values that callers never read.
// With the stash (kStash), P[b, h, :N, :N] is written exactly as pass 2 forms
// it: the rounded value that multiplies V, 0 for masked keys. The stash only
// adds stores, so O is bit-for-bit the no-stash kernel's. The JAX kernel pads
// P to a multiple of 8 rows and columns; this one writes N x N.
//
// Softmax scheme: two passes over the key tiles. Pass 1 finds each row's max
// and sum of exp2; pass 2 recomputes the scores, forms the normalised P,
// rounds it to the input dtype and multiplies by V. That rounds P at the same
// place as the reference. The row sum is accumulated with a running max
// (rescaled as the max grows), so it may differ from the reference's
// sum-after-max in the last f32 bits; nothing else differs.
//
// What bounds it. At ViT shapes (N = 197, d = 64) the work is B*H*N^2 score
// elements: two small products of depth 64 and the softmax's exp2, max, sum
// and rounding on every element. With the products on tensor cores the
// elementwise softmax work would bound it, as it did on the TPU. This first
// version runs the products on CUDA cores out of shared memory (one fma and
// about one shared-memory load per multiply-add) and computes the scores
// twice, so those products bound it here; the stash adds B*H*N^2 stores
// (119 MB in bf16 at ViT-B/16, bs 128), written a tile row at a time from
// shared memory so that neighbouring threads store neighbouring keys. What
// the design does: without the stash, scores and probabilities never leave
// the SM (no [B, H, N, N] tensor in device memory);
// scale*log2(e) is folded into the [N, d] q tile once instead of into the
// N^2 scores; exp2 and a reciprocal multiply replace exp and division; shared
// memory is sized by the tile, not by N, so any N works (ViT-B/8 has 785
// tokens). Tensor-core products (mma / wgmma), TMA loads and a single-pass
// online softmax are later work.
//
// Grid: one block per (query tile of 32 rows, head, batch row); 128 threads.
// Thread t owns query row t / 4 of the tile and, within every 64-key tile,
// the keys (t % 4) + 4j, j < 16; for P . V it owns the output dims
// (t % 4) + 4i. The four threads of a row are adjacent lanes, so row
// reductions are two xor-shuffles.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   -shared -Xcompiler -fPIC (see visiondk_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockM = 32;                           // query rows per block
constexpr int kBlockN = 64;                           // keys per tile
constexpr int kLanesPerRow = kThreads / kBlockM;      // 4
constexpr int kColsPerLane = kBlockN / kLanesPerRow;  // 16
constexpr float kMaskValue = -1e30f;                  // the reference's key mask

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

// Copies rows [row0, row0 + rows) of one head's q, k or v slice into shared
// memory as f32 times `mul`, with zeros for rows >= n and dims >= d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int64_t row_stride,
                                          int row0, int rows, int n, int d, float mul) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int row = row0 + r;
    float val = 0.f;
    if (row < n && c < d) val = to_float(src[static_cast<int64_t>(row) * row_stride + c]) * mul;
    dst[r * ld + c] = val;
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
    fused_qkv_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                                   T* __restrict__ p_out, int n, int heads, int d, int n_valid,
                                   float q_mul) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + Smem<DP>::kQ;
  float* vs = ks + Smem<DP>::kK;
  float* ps = vs + Smem<DP>::kV;

  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = heads * d;
  const int64_t row_stride = 3 * static_cast<int64_t>(c);
  const T* base = qkv + static_cast<int64_t>(b) * n * row_stride;
  const T* q_src = base + h * d;
  const T* k_src = base + c + h * d;
  const T* v_src = base + 2 * c + h * d;

  const int r = threadIdx.x / kLanesPerRow;
  const int g = threadIdx.x % kLanesPerRow;

  load_tile<T, DP>(qs, DP + 1, q_src, row_stride, m0, kBlockM, n, d, q_mul);

  // Pass 1: this thread's running max and sum of exp2 over its keys.
  float s[kColsPerLane];
  float m_loc = -INFINITY;
  float l_loc = 0.f;
  for (int k0 = 0; k0 < n; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DP>(ks, DP + 1, k_src, row_stride, k0, kBlockN, n, d, 1.f);
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
    load_tile<T, DP>(ks, DP + 1, k_src, row_stride, k0, kBlockN, n, d, 1.f);
    load_tile<T, DP>(vs, DP, v_src, row_stride, k0, kBlockN, n, d, 1.f);
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
      T* p_tile = p_out + ((static_cast<int64_t>(b) * heads + h) * n + m0) * n + k0;
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
    T* o = out + (static_cast<int64_t>(b) * n + row) * c + h * d;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int dd = g + i * kLanesPerRow;
      if (dd < d) o[dd] = from_float<T>(acc[i]);
    }
  }
}

template <typename T, int DP, bool kStash>
cudaError_t launch(const void* qkv, void* out, void* p, int b, int n, int heads, int d,
                   int n_valid, float q_mul, cudaStream_t stream) {
  auto kernel = fused_qkv_attention_fwd_kernel<T, DP, kStash>;
  constexpr size_t bytes = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockM - 1) / kBlockM, heads, b);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out),
                                            static_cast<T*>(p), n, heads, d, n_valid, q_mul);
  return cudaGetLastError();
}

template <typename T, bool kStash>
cudaError_t dispatch_dim(const void* qkv, void* out, void* p, int b, int n, int heads, int d,
                         int n_valid, float q_mul, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32, kStash>(qkv, out, p, b, n, heads, d, n_valid, q_mul, stream);
  if (d <= 64) return launch<T, 64, kStash>(qkv, out, p, b, n, heads, d, n_valid, q_mul, stream);
  return launch<T, 128, kStash>(qkv, out, p, b, n, heads, d, n_valid, q_mul, stream);
}

template <typename T>
cudaError_t dispatch_stash(const void* qkv, void* out, void* p, int b, int n, int heads, int d,
                           int n_valid, float q_mul, cudaStream_t stream) {
  if (p != nullptr) return dispatch_dim<T, true>(qkv, out, p, b, n, heads, d, n_valid, q_mul, stream);
  return dispatch_dim<T, false>(qkv, out, p, b, n, heads, d, n_valid, q_mul, stream);
}

}  // namespace

// qkv: [b, n, 3 * heads * head_dim] contiguous, out: [b, n, heads * head_dim]
// contiguous, p: [b, heads, n, n] contiguous or NULL (no stash), all of
// `dtype` (0: float32, 1: bfloat16), on the current device. q_mul =
// head_dim**-0.5 * log2(e). Returns the CUDA error code of the launch (0 on
// success).
extern "C" int vdk_fused_qkv_attention_fwd(const void* qkv, void* out, void* p, int b, int n,
                                           int heads, int head_dim, int n_valid, float q_mul,
                                           int dtype, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || heads < 1 || heads > 65535 || head_dim < 1 ||
      head_dim > 128 || n_valid < 1 || n_valid > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          dispatch_stash<float>(qkv, out, p, b, n, heads, head_dim, n_valid, q_mul, s));
    case 1:
      return static_cast<int>(dispatch_stash<__nv_bfloat16>(qkv, out, p, b, n, heads, head_dim,
                                                            n_valid, q_mul, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* vdk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
