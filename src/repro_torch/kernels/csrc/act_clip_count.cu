// Fused activation clip + zero count for NVIDIA Hopper (sm_90a) -- the SPE
// clip unit with its "dedicated counter" (Fig. 3 of the paper).
//
// Replaces the TPU kernel `act_clip_count` (body `_kernel`) of
// src/repro/kernels/act_clip.py:
//     y   = where(abs(x) >= tau, x, 0)          in x's dtype
//     cnt = number of y == 0 per (bm, bn) tile   int32, (M/bm, N/bn)
// tau = 0 keeps x as it is and still counts the zeros already there; -0.0
// counts as a zero. The compare is made in float32 after widening x, for
// bf16 inputs too: the TPU kernel holds tau as a float32 scalar, so its
// `abs(x) >= tau` promotes to float32 as well. The plain PyTorch version
// (kernels/ref.py) does the same, and the two are bit-equal.
//
// What bounds it on this card: bytes. Every element is read once and written
// once and the per-tile counts are negligible, so the least time is
// 2 * M * N * sizeof(T) over the memory rate. The design therefore does
// nothing but move bytes in 16-byte accesses with neighbouring threads on
// neighbouring addresses, and reduces the count in registers, then by warp
// shuffles, then through a few words of shared memory: one block per tile
// writes one int32, no atomics, so the counts are deterministic. The tile
// grid of the TPU version is kept because the wrapper and the calibration
// statistics read per-tile counts; a tile is the unit of parallelism here,
// so an input of few tiles fills only that many SMs (left to a later
// redesign: split a tile over several blocks and reduce in a second pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;              // elements in 16 bytes
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  // clip the 16-byte vector in place, return how many results are zero
  static __device__ __forceinline__ int clip_vec(uint4& v, float tau) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&v);
    int zeros = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f = __uint_as_float(u[i]);
      if (!(fabsf(f) >= tau)) { u[i] = 0u; f = 0.0f; }
      zeros += (f == 0.0f);
    }
    return zeros;
  }
};

template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float widen(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.0f);
  }
  static __device__ __forceinline__ int clip_vec(uint4& v, float tau) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&v);
    int zeros = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // two bf16 in one word; a bf16 widens to float32 by a 16-bit shift
      uint32_t lo = u[i] << 16, hi = u[i] & 0xffff0000u;
      float flo = __uint_as_float(lo), fhi = __uint_as_float(hi);
      if (!(fabsf(flo) >= tau)) { lo = 0u; flo = 0.0f; }
      if (!(fabsf(fhi) >= tau)) { hi = 0u; fhi = 0.0f; }
      zeros += (flo == 0.0f) + (fhi == 0.0f);
      u[i] = hi | (lo >> 16);
    }
    return zeros;
  }
};

// One block per (bm, bn) tile; tiles numbered row-major along blockIdx.x.
template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
act_clip_count_kernel(const T* __restrict__ x, float tau, T* __restrict__ y,
                      int* __restrict__ cnt, long long N, int bm, int bn,
                      int tiles_n) {
  const int tile = blockIdx.x;
  const long long ti = tile / tiles_n, tj = tile % tiles_n;
  const long long base = ti * bm * N + tj * bn;
  int zeros = 0;

  if (kVectorised) {
    constexpr int V = Elem<T>::kVec;
    const int vecs_per_row = bn / V;
    const int n_vecs = bm * vecs_per_row;
    for (int e = threadIdx.x; e < n_vecs; e += kThreads) {
      const int r = e / vecs_per_row, c = (e - r * vecs_per_row) * V;
      const long long off = base + r * N + c;
      uint4 v = *reinterpret_cast<const uint4*>(x + off);
      zeros += Elem<T>::clip_vec(v, tau);
      *reinterpret_cast<uint4*>(y + off) = v;
    }
  } else {
    const int n_elems = bm * bn;
    for (int e = threadIdx.x; e < n_elems; e += kThreads) {
      const int r = e / bn, c = e - r * bn;
      const long long off = base + r * N + c;
      const T v = x[off];
      const float f = Elem<T>::widen(v);
      const bool keep = fabsf(f) >= tau;
      // a kept value is copied bit for bit (so -0.0 stays -0.0 at tau = 0);
      // a clipped one becomes +0
      y[off] = keep ? v : Elem<T>::zero();
      zeros += (!keep) || (f == 0.0f);
    }
  }

  // block reduction: registers -> warp shuffles -> shared memory -> thread 0
  __shared__ int warp_sums[kThreads / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    zeros += __shfl_down_sync(0xffffffffu, zeros, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = zeros;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    cnt[tile] = total;
  }
}

template <typename T>
int launch(const void* x, float tau, void* y, int* cnt, long long M,
           long long N, int bm, int bn, int vectorised, cudaStream_t stream) {
  const long long tiles_m = M / bm, tiles_n = N / bn;
  const long long tiles = tiles_m * tiles_n;
  if (tiles <= 0 || tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (vectorised) {
    act_clip_count_kernel<T, true><<<(unsigned)tiles, kThreads, 0, stream>>>(
        xp, tau, yp, cnt, N, bm, bn, (int)tiles_n);
  } else {
    act_clip_count_kernel<T, false><<<(unsigned)tiles, kThreads, 0, stream>>>(
        xp, tau, yp, cnt, N, bm, bn, (int)tiles_n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface. x, y: (M, N) row-major, M % bm == N % bn == 0;
// cnt: (M/bm, N/bn) int32. `vectorised` != 0 promises 16-byte aligned x and y
// and N and bn multiples of the 16-byte vector width (4 f32 / 8 bf16).
// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError().
extern "C" int hass_act_clip_count_f32(const void* x, float tau, void* y,
                                       int* cnt, long long M, long long N,
                                       int bm, int bn, int vectorised,
                                       void* stream) {
  return launch<float>(x, tau, y, cnt, M, N, bm, bn, vectorised,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int hass_act_clip_count_bf16(const void* x, float tau, void* y,
                                        int* cnt, long long M, long long N,
                                        int bm, int bn, int vectorised,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, tau, y, cnt, M, N, bm, bn, vectorised,
                               static_cast<cudaStream_t>(stream));
}
