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
// The TPU version runs a third, sequential grid axis of max_nnz steps and
// masks the steps past counts[j]. A GPU grid has no sequential axis: here one
// block owns one 128 x 128 piece of the output, keeps its sums in registers
// (8 x 8 per thread, 256 threads) and runs the loop over the scheduled
// K-tiles itself, so steps past counts[j] do not exist. The block reads its
// own counts[j] and indices[j, s] (no scalar prefetch).
//
// What bounds it on this card: operations. The kernel's own work, on operands
// padded to whole tiles (the least work of the product counts the unpadded
// rows and columns, which is less where M, K or N is not a multiple of 128), is
// 2 * 128 * bk * bn * sum_j(counts[j]) * (M / 128) flops against the bytes of
// the tiles actually read (x tiles of the scheduled K-tiles, w tiles once per
// row block, the f32 output once); at 128-wide tiles that is tens of flops
// per byte, above the card's FP32 (non tensor core) balance point, so the
// FP32 rate is the limit for f32 inputs. The design stages (128 x 16) and
// (16 x 128) sub-chunks of the named tiles through shared memory, with the
// next chunk's global loads issued into registers before the current chunk is
// multiplied, and reads shared memory as float4. Tensor cores (wgmma on bf16,
// TF32 where the tolerance allows), TMA loads by computed coordinate and a
// multi-stage ring are left to a later redesign.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;        // output rows per block
constexpr int TN = 128;        // output columns per block
constexpr int TK = 16;         // depth of one staged chunk
constexpr int NT = 256;        // threads per block, 16 x 16, 8 x 8 outputs each
constexpr int AS_LD = TM + 4;  // padded: the transposed store of A conflicts less

template <typename T> struct Stage;

// f32: A chunk 128 x 16 = 512 float4, B chunk 16 x 128 = 512 float4; two of
// each per thread.
template <> struct Stage<float> {
  float4 a[2], b[2];
  __device__ __forceinline__ void load(const float* __restrict__ x,
                                       const float* __restrict__ w,
                                       long long K, long long N, long long m0,
                                       long long n0, long long k0, int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = t + i * NT;
      const int am = q >> 2, ak = (q & 3) << 2;
      a[i] = *reinterpret_cast<const float4*>(x + (m0 + am) * K + k0 + ak);
      const int bk = q >> 5, bn = (q & 31) << 2;
      b[i] = *reinterpret_cast<const float4*>(w + (k0 + bk) * N + n0 + bn);
    }
  }
  __device__ __forceinline__ void store(float (*As)[AS_LD], float (*Bs)[TN],
                                        int t) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = t + i * NT;
      const int am = q >> 2, ak = (q & 3) << 2;
      As[ak + 0][am] = a[i].x;
      As[ak + 1][am] = a[i].y;
      As[ak + 2][am] = a[i].z;
      As[ak + 3][am] = a[i].w;
      const int bk = q >> 5, bn = (q & 31) << 2;
      *reinterpret_cast<float4*>(&Bs[bk][bn]) = b[i];
    }
  }
};

// bf16: A chunk 128 x 16 = 256 x (8 bf16), B chunk 16 x 128 = 256 x (8 bf16);
// one 16-byte load of each per thread, widened to f32 on the way to shared
// memory (a bf16 widens by a 16-bit shift; the low half of a word comes first).
template <> struct Stage<__nv_bfloat16> {
  uint4 a, b;
  static __device__ __forceinline__ void widen8(const uint4& v, float* f) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ x,
                                       const __nv_bfloat16* __restrict__ w,
                                       long long K, long long N, long long m0,
                                       long long n0, long long k0, int t) {
    const int am = t >> 1, ak = (t & 1) << 3;
    a = *reinterpret_cast<const uint4*>(x + (m0 + am) * K + k0 + ak);
    const int bk = t >> 4, bn = (t & 15) << 3;
    b = *reinterpret_cast<const uint4*>(w + (k0 + bk) * N + n0 + bn);
  }
  __device__ __forceinline__ void store(float (*As)[AS_LD], float (*Bs)[TN],
                                        int t) const {
    float f[8];
    const int am = t >> 1, ak = (t & 1) << 3;
    widen8(a, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) As[ak + i][am] = f[i];
    const int bk = t >> 4, bn = (t & 15) << 3;
    widen8(b, f);
    *reinterpret_cast<float4*>(&Bs[bk][bn]) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(&Bs[bk][bn + 4]) =
        make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
block_sparse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const int* __restrict__ counts,
                           const int* __restrict__ indices,
                           float* __restrict__ out, long long K, long long N,
                           int bk, int bn, int max_nnz) {
  __shared__ __align__(16) float As[TK][AS_LD];
  __shared__ __align__(16) float Bs[TK][TN];

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const long long m0 = (long long)blockIdx.x * TM;
  const long long n0 = (long long)blockIdx.y * TN;
  const int j = (int)(n0 / bn);               // schedule column of this block
  const int nnz = counts[j];
  const int* __restrict__ idx = indices + (long long)j * max_nnz;
  const int chunks_per_tile = bk / TK;
  const int n_chunks = nnz * chunks_per_tile;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  Stage<T> st;
  if (n_chunks > 0) st.load(x, w, K, N, m0, n0, (long long)idx[0] * bk, t);

  for (int ch = 0; ch < n_chunks; ++ch) {
    st.store(As, Bs, t);
    __syncthreads();
    if (ch + 1 < n_chunks) {
      const int s = (ch + 1) / chunks_per_tile;
      const int kk = ((ch + 1) - s * chunks_per_tile) * TK;
      st.load(x, w, K, N, m0, n0, (long long)idx[s] * bk + kk, t);
    }
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      // rows {ty*4..+4} and {64+ty*4..+4}; columns likewise with tx: a
      // quarter-warp's float4 reads then fall on distinct banks
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long row = m0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
    float* o = out + row * N + n0;
    *reinterpret_cast<float4*>(o + tx * 4) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(o + 64 + tx * 4) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* counts, const int* indices,
           float* out, long long M, long long K, long long N, int bk, int bn,
           int max_nnz, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % TM || N % TN || bn % TN || N % bn ||
      bk % TK || K % bk || max_nnz < 1 || N / TN > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(M / TM), (unsigned)(N / TN));
  block_sparse_matmul_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), counts, indices, out,
      K, N, bk, bn, max_nnz);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface. x: (M, K), w: (K, N) row-major and 16-byte aligned,
// counts: (N/bn,) int32, indices: (N/bn, max_nnz) int32, out: (M, N) f32.
// M % 128 == 0, bn % 128 == 0, N % bn == 0, bk % 16 == 0, K % bk == 0.
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int hass_block_sparse_matmul_f32(
    const void* x, const void* w, const int* counts, const int* indices,
    float* out, long long M, long long K, long long N, int bk, int bn,
    int max_nnz, void* stream) {
  return launch<float>(x, w, counts, indices, out, M, K, N, bk, bn, max_nnz,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int hass_block_sparse_matmul_bf16(
    const void* x, const void* w, const int* counts, const int* indices,
    float* out, long long M, long long K, long long N, int bk, int bn,
    int max_nnz, void* stream) {
  return launch<__nv_bfloat16>(x, w, counts, indices, out, M, K, N, bk, bn,
                               max_nnz, static_cast<cudaStream_t>(stream));
}
