// Building blocks of the window-attention kernels: the shifted windows'
// addressing, which every body of fused_window_attention.cu and
// fused_window_attention_bwd.cu uses, and the parts of the tiled bfloat16
// bodies (windows of 64 < N <= 256 tokens: the forward and the backward's dq
// and dkv kernels).
//
// Shifted windows (Swin's SW-MSA). A shifted block attends over its map
// rolled by (-s, -s), 0 <= s < ws. The kernels roll nothing: row r of window
// (wy, wx) is read from, and written to, the pixel
// ((wy ws + r / ws + s) mod H, (wx ws + r % ws + s) mod W). Since s < ws, only
// the windows of the last row (column) of windows wrap, and in them only the
// rows with r / ws >= H - wy ws - s (columns r % ws >= W - wx ws - s). So a
// window's first pixel moves on by s W + s, and a row's offset from it (r / ws
// image rows and r % ws columns) drops by H W where its row wraps and by W
// where its column does: two compares a row, once a window. The kernels keep
// such offsets packed with their column, (offset << 4) | r % ws (ws <= 16),
// so that one int says both (row_offset, WindowWalk::at). Each pixel's head
// slice stays one contiguous run, so the loads and stores keep their width.
//
// The tiled bodies' blocks are 4
// warps of 16 rows (or keys) and every window takes 256 keys, those past N
// zeros, so that every loop over keys is unrolled with no bound to test.
//
// The key order. Within each group of 32 keys the tiles of K and V in shared
// memory hold key 8a + 2b + e at position 8b + 2a + e (a, b < 4, e < 2): a
// swap of two 2-bit fields, so the order is its own inverse (perm). A product
// Q . K^T over the tile then puts, in thread (g, t)'s C fragments of the four
// n-tiles 4m .. 4m + 3, the eight consecutive keys 32m + 8t .. 32m + 8t + 7 of
// rows g and g + 8. So the thread reads its bias and its stashed P, and writes
// its P to the stash, as 16- or 32-byte pieces of a row in device memory with
// neighbouring lanes on neighbouring pieces, where the natural order would
// scatter them in 4-byte pieces 16 bytes apart. Any product over keys (P . V,
// dS . K) reads K and V in the same order, so it sums the same terms.
//
// Tiles [rows][DP] bf16 (DP = 32 or 64) are unpadded: the 16-byte chunks of
// a row are XOR-swizzled (sw) so that the eight rows one ldmatrix phase reads
// fall in eight distinct bank groups. A tile of 256 keys x 32 is 16 KB where
// the padded layout of attention_tc.cuh would take 20 KB: what keeps two
// blocks of the tiled kernels on an SM beside their 64 KB of bias or dbias.

#pragma once

#include "attention_tc.cuh"

namespace wtc {

using tc::bf16;

constexpr int kMaxN = 256;                   // ws <= 16
constexpr int kGroup = 32;                   // keys a group of the key order
constexpr int kMaxGroups = kMaxN / kGroup;   // 8
constexpr int kNT = kMaxN / 8;               // n-tiles of a whole row of scores
constexpr int kMaxWarps = 4;                 // 16-row tiles a block
constexpr int kThreads = kMaxWarps * 32;
constexpr int kRows = kMaxWarps * 16;        // rows (or keys) a block

// Position <-> key within the key order (an involution).
__host__ __device__ __forceinline__ constexpr int perm(int x) {
  return (x & ~0x1e) | ((x >> 2) & 0x6) | ((x << 2) & 0x18);
}

// Element offset of 16-byte chunk c of row r of a swizzled [rows][DP] tile.
template <int DP>
__device__ __forceinline__ int sw(int r, int c) {
  static_assert(DP == 32 || DP == 64, "the swizzle covers rows of 4 or 8 chunks");
  const int x = DP == 32 ? (r >> 1) & 3 : r & 7;
  return r * DP + ((c ^ x) << 3);
}

// Each lane's element offsets into a swizzled [rows][DP] tile for the
// ldmatrix of rows [0, 16), computed once: rows [16 i, 16 i + 16) are 16 i DP
// further on, since the swizzle reads only a row's lowest three bits, so in
// an unrolled loop every tile offset is an immediate. a: the A fragment of
// columns [16 kk, 16 kk + 16). b: the B fragments of two 8-row n-tiles (a
// stored [n][k] matrix) x k [16 kk, 16 kk + 16). bt: with .trans, the B
// fragments of 16 k rows x the two 8-column n-tiles [16 dp, 16 dp + 16) of a
// stored [k][n] matrix.
template <int DP>
struct Lanes {
  int a[DP / 16], b[DP / 16], bt[DP / 16];
  __device__ __forceinline__ explicit Lanes(int lane) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      a[kk] = sw<DP>(tc::a_row(lane), 2 * kk + (lane >> 4));
      b[kk] = sw<DP>(tc::b_row(lane), 2 * kk + ((lane >> 3) & 1));
      bt[kk] = sw<DP>(tc::bt_row(lane), 2 * kk + (lane >> 4));
    }
  }
};

// c[0], c[1] (16 rows x 16 cols) = A . B^T over DP: A the fragments a[DP / 16]
// of a warp's rows, B rows [16 i, 16 i + 16) of a swizzled [rows][DP] tile.
template <int DP>
__device__ __forceinline__ void product16(float (&c)[2][4], const uint32_t (&a)[DP / 16][4], const bf16* tile,
                                          const Lanes<DP>& l, int i) {
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t b[4];
    tc::ldmatrix_x4(b, tile + l.b[kk] + i * 16 * DP);
    tc::mma(c[0], a[kk], b[0], b[1]);
    tc::mma(c[1], a[kk], b[2], b[3]);
  }
}

// acc += A . B for k rows [16 i, 16 i + 16) of a swizzled [k][DP] tile: A a
// 16 x 16 fragment (with kSplit, the sum of hi and lo).
template <int DP, bool kSplit>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                                           const bf16* tile, const Lanes<DP>& l, int i) {
#pragma unroll
  for (int dp = 0; dp < DP / 16; ++dp) {
    uint32_t b[4];
    tc::ldmatrix_x4_trans(b, tile + l.bt[dp] + i * 16 * DP);
    tc::mma(acc[2 * dp], hi, b[0], b[1]);
    tc::mma(acc[2 * dp + 1], hi, b[2], b[3]);
    if (kSplit) {
      tc::mma(acc[2 * dp], lo, b[0], b[1]);
      tc::mma(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// Stages a swizzled [kRows][DP] tile with the kThreads threads of a block:
// tile row r holds source row row_of(r), at win + offset(row_of(r)) * stride
// elements (win: the tensor's column of the window's first pixel; offset: a
// row's pixel offset from it); source rows at or past n_rows and columns at or past
// n_cols are zeros. Thread t copies 16-byte chunk t % (DP / 8) of rows
// t / (DP / 8) + k * (a multiple of 8). Aligned: cp.async (wait with
// cp_async_wait); otherwise element by element, synchronously, into the same
// bytes.
template <int DP, int kRows, typename Offset, typename RowOf>
__device__ __forceinline__ void stage(bf16* dst, const bf16* win, Offset offset, int64_t stride, RowOf row_of,
                                      int n_rows, int n_cols, bool aligned) {
  constexpr int kChunks = DP / 8, kStep = kThreads / kChunks;
  static_assert(kRows % kStep == 0 && kStep % 8 == 0, "whole steps of rows, each keeping the swizzle");
  const int r0 = threadIdx.x / kChunks, ch = threadIdx.x % kChunks, col = ch * 8;
  bf16* d0 = dst + sw<DP>(r0, ch);
#pragma unroll
  for (int k = 0; k < kRows / kStep; ++k) {
    const int sr = row_of(r0 + k * kStep);
    const bool row_in = sr < n_rows;
    const bf16* s = win + (row_in ? static_cast<int64_t>(offset(sr)) * stride : 0) + col;
    bf16* d = d0 + k * kStep * DP;
    if (aligned) {
      const bool in = row_in && col < n_cols;
      tc::cp_async16(d, in ? s : win, in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x0 = row_in && col + 2 * e < n_cols ? __bfloat16_as_ushort(s[2 * e]) : 0u;
        const uint32_t x1 = row_in && col + 2 * e + 1 < n_cols ? __bfloat16_as_ushort(s[2 * e + 1]) : 0u;
        w[e] = x0 | (x1 << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The P fragments of a row's eight keys 32m + 8t .. + 7 (row g: half 0, row
// g + 8: half 1) in the A fragments p[][4] of the key order (16 keys each), as
// one 16-byte piece, and back.
template <int KK>
__device__ __forceinline__ uint4 p_piece(const uint32_t (&p)[KK][4], int m, int half) {
  return make_uint4(p[2 * m][half], p[2 * m][2 + half], p[2 * m + 1][half], p[2 * m + 1][2 + half]);
}
template <int KK>
__device__ __forceinline__ void set_p_piece(uint32_t (&p)[KK][4], int m, int half, uint4 v) {
  p[2 * m][half] = v.x;
  p[2 * m][2 + half] = v.y;
  p[2 * m + 1][half] = v.z;
  p[2 * m + 1][2 + half] = v.w;
}

// The offset of row r of a window from its first pixel (r / ws image rows and
// r % ws columns); for shifted windows packed with its column (see above).
template <bool kShift>
__host__ __device__ __forceinline__ int row_offset(int r, int ws, int w_img) {
  const int ry = r / ws, rx = r - ry * ws;
  return kShift ? ((ry * w_img + rx) << 4) | rx : ry * w_img + rx;
}

// off[r] = row_offset<kShift>(r), r < n: the divisions made once a block, not
// at every staged row. The caller syncs before reading it.
template <bool kShift>
__device__ __forceinline__ void fill_offsets(int* off, int n, int ws, int w_img) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) off[r] = row_offset<kShift>(r, ws, w_img);
}

// 2^x on the special-function unit (ex2.approx, as exp2f compiles, with
// subnormal inputs and results flushed to 0: they lie 2^-126 below a
// probability of 1, far under its bf16 rounding).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Window t (batch-row-major) of a call, and a block's walk over consecutive
// windows: the window's first pixel, as a row index of [B * H * W], and its
// index among its image's windows, advanced from one window to the next with
// no division. Shifted (kShift, by s): the first pixel moves on by s W + s, and
// wrap_row / wrap_col say where the window's rows wrap (see above).
template <bool kShift>
struct WindowWalk {
  int64_t base;
  int w, wx;  // the window's index in its image, and its column of windows
  int wrap_row;  // shifted: offsets at or past (H - wy ws - s) W wrap to the map's top
  int wrap_col;  // shifted: columns at or past W - wx ws - s wrap to its left edge
  __device__ __forceinline__ WindowWalk(int t, int n_win, int n_win_x, int ws, int h_img, int w_img, int s) {
    const int b = t / n_win;
    w = t - b * n_win;
    const int wy = w / n_win_x;
    wx = w - wy * n_win_x;
    base = (static_cast<int64_t>(b) * h_img + wy * ws) * w_img + wx * ws;
    wrap_row = wrap_col = 0;
    if constexpr (kShift) {
      base += static_cast<int64_t>(s) * w_img + s;
      wrap_row = (h_img - wy * ws - s) * w_img;
      wrap_col = w_img - wx * ws - s;
    }
  }
  // to the next window: ws pixels right, or from the end of a row of windows
  // to the start of the next (of the next image after the last)
  __device__ __forceinline__ void next(int n_win, int n_win_x, int ws, int h_img, int w_img, int s) {
    base += ws;
    w = w + 1 == n_win ? 0 : w + 1;
    if constexpr (kShift) wrap_col -= ws;
    if (++wx == n_win_x) {
      wx = 0;
      base += static_cast<int64_t>(ws - 1) * w_img;
      if constexpr (kShift) {
        wrap_col = w_img - s;
        wrap_row = w == 0 ? (h_img - s) * w_img : wrap_row - ws * w_img;
      }
    }
  }
  // The offset from base of the pixel of the row whose row_offset<kShift> is
  // `e` (hw = H W): e itself unshifted; shifted, its offset less H W where its
  // row wraps and less W where its column does.
  __device__ __forceinline__ int at(int e, int hw, int w_img) const {
    if constexpr (!kShift) {
      return e;
    } else {
      const int off = e >> 4;
      return off - (off >= wrap_row ? hw : 0) - ((e & 15) >= wrap_col ? w_img : 0);
    }
  }
};

}  // namespace wtc
