// Tensor-core building blocks of the bfloat16 attention kernels
// (fused_qkv_attention.cu, fused_qkv_attention_bwd.cu): asynchronous tile
// loads into shared memory, ldmatrix fragments, the m16n8k16 bf16 MMA with
// f32 accumulation, and tile stores.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// for lane = 4 * g + t (g < 8, t < 4):
//   A (16 x 16, row): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                     a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, same cols)
//   B (16 x 8, col):  b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g)
//   C (16 x 8, f32):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same)
// Two C tiles side by side (16 x 16) are exactly the A fragment of the next
// product after packing to bf16 (c0c1 -> a0, c2c3 -> a1 of the left tile,
// a2, a3 of the right), so P and dS never pass through shared memory.
//
// Shared-memory tiles are row-major bf16 with a row stride of (width + 8)
// elements: the 16-byte pad puts the eight rows an ldmatrix phase reads in
// eight distinct bank groups.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWarpRows = 16;  // rows of one MMA tile, owned by one warp
constexpr int kMaxWarps = 7;   // warps (row tiles) per block: 224 threads, so three forward blocks fit an SM
constexpr int kPad = 8;        // bf16 elements of padding per shared-memory row
constexpr float kMaskValue = -1e30f;  // the reference's key mask

// Row tiles of 16 split over ceil(tiles / 7) blocks per (head, batch row) as
// evenly as they go: N = 197 gives 13 tiles, 2 blocks of 7 warps (208 rows
// computed, 5.3% of them past N) where 64-row blocks would compute 256.
struct Split {
  int blocks, warps;
};
inline Split split_rows(int n) {
  const int tiles = (n + kWarpRows - 1) / kWarpRows;
  const int blocks = (tiles + kMaxWarps - 1) / kMaxWarps;
  return {blocks, (tiles + blocks - 1) / blocks};
}

// A [B, H, N, d] operand seen through element strides of its batch row, head
// and token; the head dim has unit stride. `aligned`: every row starts on 16
// bytes and d is a multiple of 8, so rows move as whole 16-byte chunks.
// (The float32 kernels read the same struct and ignore `aligned`.)
struct View {
  const void* ptr;
  int64_t sb, sh, sn;
  int aligned;
  template <typename T>
  __device__ __forceinline__ T* head(int b, int h) const {
    return static_cast<T*>(const_cast<void*>(ptr)) + b * sb + h * sh;
  }
};

// Sets v.aligned for bf16 elements and head dim d.
inline void mark_aligned(View& v, int d) {
  v.aligned = reinterpret_cast<uintptr_t>(v.ptr) % 16 == 0 && v.sb % 8 == 0 && v.sh % 8 == 0 &&
              v.sn % 8 == 0 && d % 8 == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a . b on the tensor cores (bf16 operands, f32 accumulation).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even, as torch's .to(bfloat16)); the
// first in the low half, as the fragments order columns.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float lo_of(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_of(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), for a pair: a product of
// both parts carries x to about 16 significant bits instead of 8.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack(x0, x1);
  lo = pack(x0 - lo_of(hi), x1 - hi_of(hi));
}

// The A fragment of a 16 x 16 block from its two 16 x 8 C tiles (left, right).
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&l)[4], const float (&r)[4]) {
  a[0] = pack(l[0], l[1]);
  a[1] = pack(l[2], l[3]);
  a[2] = pack(r[0], r[1]);
  a[3] = pack(r[2], r[3]);
}
// The same split into hi and lo fragments.
__device__ __forceinline__ void a_from_c_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&l)[4],
                                               const float (&r)[4]) {
  split(l[0], l[1], hi[0], lo[0]);
  split(l[2], l[3], hi[1], lo[1]);
  split(r[0], r[1], hi[2], lo[2]);
  split(r[2], r[3], hi[3], lo[3]);
}

// Lane offsets into a row-major tile for ldmatrix_x4. a_*: the A fragment of
// the 16 x 16 block at the pointer (rows x cols). b_*: the B fragments of two
// 8-column n-tiles (16 rows of the stored [n][k] matrix) x 16 k, regs {0, 1}
// for the first n-tile, {2, 3} for the second. bt_*: with .trans, B fragments
// from a stored [k][n] matrix: 16 k rows x two 8-column n-tiles. With
// .trans, the b_* offsets also give the A fragment of the transpose of a
// stored [k][m] block (16 k rows x 16 m columns): A = (m rows, k cols).
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) << 3; }
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) << 3; }

// c = A . B^T on a warp: A its 16 rows of a row-major tile in shared memory,
// B NT * 8 rows of another (both DP wide, row stride ld): c[j] holds the
// products with B's rows [8 j, 8 j + 8).
template <int DP, int NT>
__device__ __forceinline__ void product_nt(float (&c)[NT][4], const bf16* a, const bf16* b, int ld, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + a_row(lane) * ld + kk * 16 + a_col(lane));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (np * 16 + b_row(lane)) * ld + kk * 16 + b_col(lane));
      mma(c[2 * np], af, bf[0], bf[1]);
      mma(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += A . B for one 16-deep step kk: A a 16 x 16 fragment (with kSplit,
// the sum of two: hi and lo), B rows [16 kk, 16 kk + 16) of a row-major
// [k][DP] tile in shared memory (row stride ld), read by ldmatrix.trans.
template <int DP, bool kSplit>
__device__ __forceinline__ void accumulate_tn(float (&acc)[DP / 8][4], const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4], const bf16* b, int ld, int kk,
                                              int lane) {
#pragma unroll
  for (int dp = 0; dp < DP / 16; ++dp) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, b + (kk * 16 + bt_row(lane)) * ld + dp * 16 + bt_col(lane));
    mma(acc[2 * dp], hi, bf[0], bf[1]);
    mma(acc[2 * dp + 1], hi, bf[2], bf[3]);
    if (kSplit) {
      mma(acc[2 * dp], lo, bf[0], bf[1]);
      mma(acc[2 * dp + 1], lo, bf[2], bf[3]);
    }
  }
}

// The inverse of a_from_c for bf16 values: the two C tiles of an A fragment.
__device__ __forceinline__ void c_from_a(float (&l)[4], float (&r)[4], const uint32_t (&a)[4]) {
  l[0] = lo_of(a[0]);
  l[1] = hi_of(a[0]);
  l[2] = lo_of(a[1]);
  l[3] = hi_of(a[1]);
  r[0] = lo_of(a[2]);
  r[1] = hi_of(a[2]);
  r[2] = lo_of(a[3]);
  r[3] = hi_of(a[3]);
}

// Stages rows [0, rows) x cols [0, cols) (cols a multiple of 8) of a
// row-major bf16 matrix at src (row stride src_ld elements) into shared
// memory at dst (row stride ld), with zeros for rows >= n_rows and
// cols >= n_cols. Aligned: cp.async of 16 bytes a thread (wait with
// cp_async_wait). Otherwise element by element, synchronously, into the same
// bytes: the shared-memory content does not depend on the path.
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src, int64_t src_ld, int rows,
                                      int cols, int n_rows, int n_cols, bool aligned) {
  const int chunks = cols >> 3;
  for (int c = threadIdx.x; c < rows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int col = (c - r * chunks) << 3;
    bf16* d = dst + r * ld + col;
    const bool row_in = r < n_rows;
    if (aligned) {
      const bool in = row_in && col < n_cols;
      cp_async16(d, in ? src + r * src_ld + col : src, in ? 16 : 0);
    } else {
      const bf16* s = src + (row_in ? r : 0) * src_ld + col;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bf16 zero = __float2bfloat16(0.f);
        const bf16 x0 = row_in && col + 2 * e < n_cols ? s[2 * e] : zero;
        const bf16 x1 = row_in && col + 2 * e + 1 < n_cols ? s[2 * e + 1] : zero;
        w[e] = static_cast<uint32_t>(__bfloat16_as_ushort(x0)) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(x1)) << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Writes rows [0, n_rows) x cols [0, n_cols) of a shared-memory tile (row
// stride ld, cols a multiple of 8 wide) to a row-major bf16 matrix at dst
// (row stride dst_ld): 16 bytes a thread where aligned, else one element a
// thread with neighbouring threads on neighbouring columns. The calling
// threads (count `threads`, index `tid`) cover the tile.
__device__ __forceinline__ void unstage(bf16* dst, int64_t dst_ld, const bf16* src, int ld, int n_rows,
                                        int n_cols, int cols, bool aligned, int tid, int threads) {
  if (aligned) {
    const int chunks = cols >> 3;
    for (int c = tid; c < n_rows * chunks; c += threads) {
      const int r = c / chunks;
      const int col = (c - r * chunks) << 3;
      if (col < n_cols) {
        *reinterpret_cast<uint4*>(dst + r * dst_ld + col) = *reinterpret_cast<const uint4*>(src + r * ld + col);
      }
    }
  } else {
    for (int e = tid; e < n_rows * cols; e += threads) {
      const int r = e / cols;
      const int col = e - r * cols;
      if (col < n_cols) dst[r * dst_ld + col] = src[r * ld + col];
    }
  }
}

// A warp's 16-row C tiles (16 x 8 each, `tiles` of them) rounded to bf16 into
// its shared-memory rows (stride ld), for unstage.
template <int TILES>
__device__ __forceinline__ void c_to_smem(bf16* dst, int ld, const float (&c)[TILES][4], float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < TILES; ++j) {
    *reinterpret_cast<uint32_t*>(dst + g * ld + j * 8 + 2 * t) = pack(c[j][0] * mul, c[j][1] * mul);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * ld + j * 8 + 2 * t) = pack(c[j][2] * mul, c[j][3] * mul);
  }
}

}  // namespace tc
