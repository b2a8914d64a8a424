// Fused attention, forward, for Hopper (sm_90a): one stride-generic kernel
// behind two entries, with an optional stash of the probabilities P
// [B, H, N, N] for the backward.
//
// (K1) vdk_fused_qkv_attention_fwd: [B, N, 3C] -> [B, N, C]. Replaces the
// Pallas TPU kernel visiondk_tpu/ops/pallas/attention.py::_fused_fwd_kernel
// in both of its launches: by _fused_attention_padded (the no-stash forward
// of fused_qkv_attention) and by _fused_vjp_fwd (the training forward, which
// also writes p_ref). It keeps that kernel's layout contract: q, k and v are
// read by strides straight out of the packed QKV-projection buffer (row
// stride 3C; q at column h*d, k at C + h*d, v at 2C + h*d) and O is written
// at column h*d of a [B, N, C] output, so no [B, H, N, D] transpose ever
// reaches device memory.
//
// (K3) vdk_vision_attention_fwd: q, k, v [B, H, N, D] -> O [B, H, N, D].
// Replaces visiondk_tpu/ops/pallas/attention.py::_fwd_kernel (launched by
// _attn_fwd_padded under vision_attention). Same kernel: q, k and v are
// read through any (batch, head, token) strides with a unit-stride head dim
// (a strided view of a packed buffer costs no copy), O is written
// contiguous, no stash, n_valid = N. The JAX wrapper pads N up to a multiple
// of 128 and masks the padded keys; this kernel computes exactly N rows and
// keys, which is the same result. The reference scales its f32 scores by
// D^-0.5 and takes exp; this kernel folds D^-0.5 * log2(e) into q and takes
// exp2, which agrees within f32 rounding. P is rounded to the input dtype
// before P . V, as the reference's .astype(v.dtype) does.
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
// What bounds it. On the H100 the least time is set by bytes: q, k, v read
// once and O written once (155 MB in bf16 at ViT-B/16, bs 128, 46 us at
// 3.35 TB/s) against 15 GFLOP of products (15 us at the bf16 tensor-core
// peak); the stash adds B*H*N^2 stores (119 MB). This first version runs the
// products on CUDA cores out of shared memory (one fma and about one
// shared-memory load per multiply-add) and computes the scores twice, so
// those products bound it here, far above the bytes. What the design does:
// without the stash, scores and probabilities never leave the SM (no
// [B, H, N, N] tensor in device memory); the stash is written a tile row at
// a time from shared memory so that neighbouring threads store neighbouring
// keys; scale*log2(e) is folded into the [N, d] q tile once instead of into
// the N^2 scores; exp2 and a reciprocal multiply replace exp and division;
// shared memory is sized by the tile, not by N, so any N works (ViT-B/8 has
// 785 tokens); K3 shares every line of K1's kernel. Tensor-core products (mma / wgmma), TMA loads and a
// single-pass online softmax are later work.
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

struct FwdArgs {
  View q, k, v, o;
  void* p;  // [B, H, N, N] stash, or null
  int n, heads, d, n_valid;
  float q_mul;  // head_dim**-0.5 * log2(e)
};

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

template <typename T, int DP, bool kStash>
cudaError_t launch(const FwdArgs& a, int b, cudaStream_t stream) {
  auto kernel = fused_attention_fwd_kernel<T, DP, kStash>;
  constexpr size_t bytes = Smem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + kBlockM - 1) / kBlockM, a.heads, b);
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kStash>
cudaError_t dispatch_dim(const FwdArgs& a, int b, cudaStream_t stream) {
  if (a.d <= 32) return launch<T, 32, kStash>(a, b, stream);
  if (a.d <= 64) return launch<T, 64, kStash>(a, b, stream);
  return launch<T, 128, kStash>(a, b, stream);
}

template <typename T>
cudaError_t dispatch_stash(const FwdArgs& a, int b, cudaStream_t stream) {
  if (a.p != nullptr) return dispatch_dim<T, true>(a, b, stream);
  return dispatch_dim<T, false>(a, b, stream);
}

int run(const FwdArgs& a, int b, int dtype, void* stream) {
  if (b < 1 || b > 65535 || a.n < 1 || a.heads < 1 || a.heads > 65535 || a.d < 1 || a.d > 128 ||
      a.n_valid < 1 || a.n_valid > a.n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(dispatch_stash<float>(a, b, s));
    case 1:
      return static_cast<int>(dispatch_stash<__nv_bfloat16>(a, b, s));
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
