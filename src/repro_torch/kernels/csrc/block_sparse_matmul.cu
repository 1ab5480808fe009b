// Block-sparse matmul for NVIDIA Hopper (sm_90a) -- the SPE arbiter at tile
// granularity: a pruned weight is multiplied under its static schedule of
// non-zero tiles.
//
// Replaces the TPU kernel `block_sparse_matmul` (body `_kernel`, index maps
// `x_map` / `w_map`) of src/repro/kernels/block_sparse_matmul.py:
//     out (M, N) f32 = x (M, K) @ w (K, N), visiting for the output tile
//     column j only the K-tiles indices[j, 0 .. counts[j]).
// A tile that the schedule leaves out contributes exactly zero even where w
// is non-zero there, because it is never read; a column with counts[j] == 0
// gives zeros. f32 inputs are multiplied with plain FP32 FMAs (no TF32, no
// tensor cores), bf16 inputs are widened and accumulated in f32.
//
// What bounds it on this card: operations. The least work is 2 * M * (the
// scheduled tiles' real rows x columns) flops, tens of flops per byte of the
// operands, above the card's FP32 balance point (67 TFLOP/s over 3.35 TB/s),
// so the FP32 rate is the limit for f32 inputs.
//
// The design. The TPU version runs a sequential grid axis of max_nnz steps
// per output tile. Here the host builds, once per weight and row count M, a
// work plan (block_sparse_matmul.py, `make_plan`): an output tile from a
// small fixed set (128 x 64, 64 x 128, 16 x 128; BM x BN below)
// and, where the output tiles alone are too few for the 132 SMs, a split of
// each column's scheduled K-tiles, as a run of 16-deep chunks, into
// contiguous chunk ranges. One block runs one work item (m-tile, n-tile,
// chunks [c0, c1) of the column's schedule, slot). With one piece
// per column the block writes out (M, N) directly. Otherwise every item
// writes its partial sum to slab `slot` of an f32 workspace and a second
// small kernel adds the slabs of each column in slot order: the result does
// not depend on which block finishes first, and two calls are bit-equal.
//
// Inside a block: 16-deep chunks of the scheduled K-tiles pass through a
// ring of 4 stages in shared memory, filled by cp.async, so the loads of
// three chunks are in flight while one is multiplied. A is kept as loaded,
// row-major, and read as 4-deep float4 runs along k; B is row-major. Each
// thread owns an 8 x 8 block of the output in registers (rows {ty*4..+4}
// and {BM/2+ty*4..+4}, columns likewise with tx): 16 shared memory reads per
// 256 FMAs. The 32 lanes of a warp form a 4 x 8 patch of the thread grid, so
// one read of B is 8 float4 side by side (one 128-byte wavefront) and one
// read of A hits 4 rows; for f32 the 4-float groups of an A row are stored
// XOR-swizzled by the row's (r / 4) % 4, so those 4 rows fall on distinct
// banks (bf16 rows are padded by 16 bytes instead). x is read in place, unpadded: rows >= M and
// columns >= K are zero-filled by the copy (src-size 0), rows >= M and
// columns >= N are not stored. Where K or x's address do not allow 16-byte
// copies of x (the stem's K = 147) f32 takes 4-byte cp.async, bf16 plain
// loads. w is the weight padded once to whole (bk, bn) tiles, so its copies
// are never masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;         // depth of one chunk
constexpr int STAGES = 4;      // ring of chunks in shared memory
constexpr int ITEM = 5;        // ints per work item

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> struct Ty;
template <> struct Ty<float> {
  static constexpr int kVec = 4;   // elements per 16 bytes
  static constexpr int kPad = 0;   // A rows swizzled, not padded
  static __device__ __forceinline__ float zero() { return 0.0f; }
  // where element k of A row r lies in the row (k: 0..BK-1)
  static __device__ __forceinline__ int a_col(int r, int k) {
    return (((k >> 2) ^ ((r >> 2) & 3)) << 2) | (k & 3);
  }
  // four consecutive elements of shared memory, widened to f32
  static __device__ __forceinline__ void load4(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Ty<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kPad = 8;   // 16 bytes of padding per A row
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.0f);
  }
  static __device__ __forceinline__ int a_col(int, int k) { return k; }
  // a bf16 widens to f32 by a 16-bit shift; the low half of a word is first
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float* f) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

template <typename T, int BM, int BN>
struct Tile {
  static constexpr int NT = BM * BN / 64;   // threads, 8 x 8 outputs each
  static constexpr int TX = BN / 8, TY = BM / 8;
  // lanes of a warp: LY x LX threads of the TY x TX grid
  static constexpr int LX = TY >= 4 ? 8 : 32 / TY, LY = 32 / LX;
  static constexpr int LDA = BK + Ty<T>::kPad;
  static constexpr int A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * BN;
  static constexpr int SMEM = STAGES * (A_ELEMS + B_ELEMS) * (int)sizeof(T);
};

// Copy the chunk at depth k0 (16 rows of one scheduled K-tile) into one
// stage.
template <typename T, int BM, int BN>
__device__ __forceinline__ void load_chunk(
    T* As, T* Bs, const T* __restrict__ x, const T* __restrict__ w,
    long long M, long long K, long long ldw, long long m0, long long n0,
    long long k0, int narrow, int t) {
  using TT = Tile<T, BM, BN>;
  constexpr int V = Ty<T>::kVec;
  if (!narrow) {
    constexpr int PER_ROW = BK / V;
    for (int q = t; q < BM * PER_ROW; q += TT::NT) {
      const int r = q / PER_ROW, kc = (q - r * PER_ROW) * V;
      const long long gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;     // K % V == 0: all or nothing
      cp_async16(As + r * TT::LDA + Ty<T>::a_col(r, kc),
                 ok ? x + gm * K + gk : x, ok ? 16 : 0);
    }
  } else if (sizeof(T) == 4) {
    for (int q = t; q < BM * BK; q += TT::NT) {
      const int r = q / BK, kc = q - r * BK;
      const long long gm = m0 + r, gk = k0 + kc;
      const bool ok = gm < M && gk < K;
      cp_async4(As + r * TT::LDA + Ty<T>::a_col(r, kc),
                ok ? x + gm * K + gk : x, ok ? 4 : 0);
    }
  } else {
    for (int q = t; q < BM * BK; q += TT::NT) {
      const int r = q / BK, kc = q - r * BK;
      const long long gm = m0 + r, gk = k0 + kc;
      As[r * TT::LDA + Ty<T>::a_col(r, kc)] =
          (gm < M && gk < K) ? x[gm * K + gk] : Ty<T>::zero();
    }
  }
  constexpr int B_ROW = BN / V;
  for (int q = t; q < BK * B_ROW; q += TT::NT) {
    const int r = q / B_ROW, nc = (q - r * B_ROW) * V;
    cp_async16(Bs + r * BN + nc, w + (k0 + r) * ldw + n0 + nc, 16);
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(Tile<T, BM, BN>::NT)
block_sparse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const int* __restrict__ indices,
                           const int* __restrict__ items,
                           float* __restrict__ dst, long long M, long long K,
                           long long N, long long ldw, int bk, int bn,
                           int max_nnz, int narrow, int vec_out) {
  using TT = Tile<T, BM, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + STAGES * TT::A_ELEMS;

  const int t = threadIdx.x;
  const int wid = t >> 5, lane = t & 31;
  constexpr int WX = TT::TX / TT::LX;        // warps across the grid
  const int ty = (wid / WX) * TT::LY + lane / TT::LX;
  const int tx = (wid % WX) * TT::LX + lane % TT::LX;
  const int* it = items + (long long)blockIdx.x * ITEM;
  const long long m0 = (long long)it[0] * BM, n0 = (long long)it[1] * BN;
  const int c0 = it[2], n_chunks = it[3] - c0, slot = it[4];
  const int* __restrict__ idx = indices + (n0 / bn) * max_nnz;
  const int cpt = bk / BK;                   // chunks per K-tile

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  auto k_of = [&](int c) -> long long {   // depth of the item's chunk c
    const int s = (c0 + c) / cpt;
    return (long long)__ldg(idx + s) * bk + (c0 + c - s * cpt) * BK;
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks)
      load_chunk<T, BM, BN>(As + s * TT::A_ELEMS, Bs + s * TT::B_ELEMS, x, w,
                            M, K, ldw, m0, n0, k_of(s), narrow, t);
    cp_async_commit();
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();           // chunk c is in; stage (c - 1) % STAGES is free
    const int nc = c + STAGES - 1;
    if (nc < n_chunks) {
      const int st = nc % STAGES;
      load_chunk<T, BM, BN>(As + st * TT::A_ELEMS, Bs + st * TT::B_ELEMS, x,
                            w, M, K, ldw, m0, n0, k_of(nc), narrow, t);
    }
    cp_async_commit();

    const T* A = As + (c % STAGES) * TT::A_ELEMS;
    const T* B = Bs + (c % STAGES) * TT::B_ELEMS;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float a[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = r < 4 ? ty * 4 + r : BM / 2 + ty * 4 + (r - 4);
        Ty<T>::load4(A + row * TT::LDA + Ty<T>::a_col(row, kq * 4), a[r]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[8];
        const T* brow = B + (kq * 4 + kk) * BN;
        Ty<T>::load4(brow + tx * 4, b);
        Ty<T>::load4(brow + BN / 2 + tx * 4, b + 4);
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            acc[r][cc] = fmaf(a[r][kk], b[cc], acc[r][cc]);
      }
    }
  }
  cp_async_wait<0>();

  float* o = dst + (long long)slot * M * N;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long row = m0 + (r < 4 ? ty * 4 + r : BM / 2 + ty * 4 + (r - 4));
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = n0 + h * (BN / 2) + tx * 4;
      float* p = o + row * N + col;
      if (vec_out) {
        if (col < N)        // N % 4 == 0: the four columns are in or out
          *reinterpret_cast<float4*>(p) =
              make_float4(acc[r][h * 4], acc[r][h * 4 + 1], acc[r][h * 4 + 2],
                          acc[r][h * 4 + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < N) p[i] = acc[r][h * 4 + i];
      }
    }
  }
}

// out[m, n] = sum over s < splits[n / bn] of ws[s, m, n], in slot order.
__global__ void split_reduce_kernel(const float* __restrict__ ws, const int* __restrict__ splits,
                    float* __restrict__ out, long long M, long long N, int bn,
                    int vec) {
  const long long MN = M * N;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
    float4* o4 = reinterpret_cast<float4*>(out);
    const long long n4 = MN / 4;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < n4; e += stride) {
      const int p = __ldg(splits + (int)((e * 4) % N / bn));
      float4 s = w4[e];
      for (int k = 1; k < p; ++k) {
        const float4 v = w4[k * n4 + e];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      o4[e] = s;
    }
  } else {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < MN; e += stride) {
      const int p = __ldg(splits + (int)(e % N / bn));
      float s = ws[e];
      for (int k = 1; k < p; ++k) s += ws[k * MN + e];
      out[e] = s;
    }
  }
}

template <typename T, int BM, int BN>
int launch_items(const T* x, const T* w, const int* indices, const int* items,
                 float* dst, long long M, long long K, long long N,
                 long long ldw, int bk, int bn, int max_nnz, int n_items,
                 int narrow, int vec_out, cudaStream_t stream) {
  using TT = Tile<T, BM, BN>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_sparse_matmul_kernel<T, BM, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TT::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  block_sparse_matmul_kernel<T, BM, BN><<<n_items, TT::NT, TT::SMEM, stream>>>(
      x, w, indices, items, dst, M, K, N, ldw, bk, bn, max_nnz, narrow,
      vec_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* wv, const int* indices,
           const int* items, const int* splits, float* out, float* ws,
           long long M, long long K, long long N, long long ldw, int bk,
           int bn, int max_nnz, int n_items, int tile_m, int tile_n,
           int max_splits, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  constexpr int V = Ty<T>::kVec;
  if (M <= 0 || K <= 0 || N <= 0 || n_items <= 0 || max_nnz < 1 ||
      tile_n <= 0 || bk % BK || bn % tile_n || ldw < N || ldw % V ||
      reinterpret_cast<uintptr_t>(w) % 16 || max_splits < 1 ||
      (max_splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const int narrow = (K % V != 0) || (reinterpret_cast<uintptr_t>(x) % 16 != 0);
  float* dst = max_splits > 1 ? ws : out;
  const int vec_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  int err;
  if (tile_m == 128 && tile_n == 64)
    err = launch_items<T, 128, 64>(x, w, indices, items, dst, M, K, N, ldw,
                                   bk, bn, max_nnz, n_items, narrow, vec_out,
                                   stream);
  else if (tile_m == 64 && tile_n == 128)
    err = launch_items<T, 64, 128>(x, w, indices, items, dst, M, K, N, ldw,
                                   bk, bn, max_nnz, n_items, narrow, vec_out,
                                   stream);
  else if (tile_m == 16 && tile_n == 128)
    err = launch_items<T, 16, 128>(x, w, indices, items, dst, M, K, N, ldw,
                                   bk, bn, max_nnz, n_items, narrow, vec_out,
                                   stream);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || max_splits == 1) return err;
  const int vec = N % 4 == 0 && bn % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  const long long work = vec ? M * N / 4 : M * N;
  long long blocks = (work + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  split_reduce_kernel<<<(unsigned)blocks, 256, 0, stream>>>(ws, splits, out, M,
                                                            N, bn, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface. x: (M, K) row-major, any K; w: the weight padded to
// whole (bk, bn) tiles, row stride ldw, 16-byte aligned; indices: (N/bn
// rounded up, max_nnz) int32; items: (n_items, 5) int32 work items (m-tile,
// n-tile, first chunk, end chunk, slot; chunk c is rows (c % (bk/16)) * 16
// of the column's scheduled K-tile c / (bk/16)) of a plan with tile (tile_m, tile_n)
// and max_splits slots; splits: pieces per schedule column; out: (M, N) f32;
// ws: (max_splits, M, N) f32 when max_splits > 1, else unused. Launches one
// kernel (max_splits == 1) or two on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError() (or cudaErrorInvalidValue for what
// it does not take).
extern "C" int hass_block_sparse_matmul_f32(
    const void* x, const void* w, const int* indices, const int* items,
    const int* splits, float* out, float* ws, long long M, long long K,
    long long N, long long ldw, int bk, int bn, int max_nnz, int n_items,
    int tile_m, int tile_n, int max_splits, void* stream) {
  return launch<float>(x, w, indices, items, splits, out, ws, M, K, N, ldw, bk,
                       bn, max_nnz, n_items, tile_m, tile_n, max_splits,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int hass_block_sparse_matmul_bf16(
    const void* x, const void* w, const int* indices, const int* items,
    const int* splits, float* out, float* ws, long long M, long long K,
    long long N, long long ldw, int bk, int bn, int max_nnz, int n_items,
    int tile_m, int tile_n, int max_splits, void* stream) {
  return launch<__nv_bfloat16>(x, w, indices, items, splits, out, ws, M, K, N,
                               ldw, bk, bn, max_nnz, n_items, tile_m, tile_n,
                               max_splits, static_cast<cudaStream_t>(stream));
}
