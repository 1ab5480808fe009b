// Fused activation clip + zero count for NVIDIA Hopper (sm_90a) -- the SPE
// clip unit with its "dedicated counter" (Fig. 3 of the paper).
//
// Replaces the TPU kernel `act_clip_count` (body `_kernel`) of
// src/repro/kernels/act_clip.py:
//     y   = where(abs(x) >= tau, x, 0)          in x's dtype
//     cnt = number of y == 0 per (bm, bn) tile   int32
// tau = 0 keeps x as it is and still counts the zeros already there; -0.0
// counts as a zero. The compare is made in float32 after widening x, for
// bf16 inputs too: the TPU kernel holds tau as a float32 scalar, so its
// `abs(x) >= tau` promotes to float32 as well. A kept value is copied bit for
// bit, a clipped one is written as +0. The plain PyTorch version
// (kernels/ref.py) does the same, and the two are bit-equal.
//
// Ragged inputs without a padded copy: the kernel takes the flat n elements
// of x as an (M, N) row-major view whose last row-block, and with N == bn
// whose last row, may be short. Elements past n are neither read nor
// written; they count as zeros of their tile (as the zeros of a padded copy
// did), and not in the whole-input total, which the same launch writes after
// the per-tile counts.
//
// What bounds it on this card: bytes. Every element is read once and written
// once and the counts are a few words, so the least time is
// 2 * n * sizeof(T) over the memory rate. The design: each (bm, bn) tile is
// cut into row slices, one block per slice, sized so that an input of a few
// MB puts some 200-400 blocks of 256 threads in flight on the 132 SMs and
// every thread has four 16-byte loads outstanding before it clips and
// stores. A block reduces its zero count in registers, by warp shuffles and
// through shared memory, and writes it to its own word of a scratch array;
// the block that draws the last number from a ticket counter adds those
// words per tile (a tile's padding in closed form), writes the
// per-tile counts and the total. The ticket is a word of the call's own
// buffer, zeroed by a 4-byte memset queued just before the kernel, so one
// call is two device operations, shares no state with any other call, and
// its counts are deterministic.
//
// The batched entry is the TPU kernel under `vmap` (one float32 tau per
// batch row, a batch axis on the grid): B proposals' activations in one
// launch, each proposal's tau read from device memory (a replayed CUDA graph
// sees each round's taus), one zero count per proposal. It takes the
// activations as the evaluator's grouped convolutions lay them out, channels
// of the B proposals side by side in each row, and counts each proposal's
// columns where they lie, without a copy into proposal-major order. Blocks,
// unrolled loads, the one-ticket last-block reduction and the memset of the
// ticket on the call's stream are those of the single entry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;         // 16-byte loads in flight per thread
constexpr int kTargetBlocks = 264; // two blocks per SM

template <typename T> struct Elem;

template <> struct Elem<float> {
  static constexpr int kVec = 4;              // elements in 16 bytes
  // clip one element; a kept value keeps its bits, a clipped one is +0
  static __device__ __forceinline__ int clip(float& v, float tau) {
    const bool keep = fabsf(v) >= tau;
    if (!keep) v = 0.0f;
    return (!keep) || (v == 0.0f);
  }
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
  static __device__ __forceinline__ int clip(__nv_bfloat16& v, float tau) {
    const float f = __bfloat162float(v);
    const bool keep = fabsf(f) >= tau;
    if (!keep) v = __float2bfloat16(0.0f);
    return (!keep) || (f == 0.0f);
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

// Sum of `v` over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  __syncthreads();
  return total;
}

// Block b clips rows [part * rows_per_part, +rows_per_part) of tile
// b / parts (tiles numbered row-major), columns [tj * bn, +bn).
template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
act_clip_count_kernel(const T* __restrict__ x, float tau, T* __restrict__ y,
                      int* __restrict__ cnt, int* __restrict__ partial,
                      unsigned* __restrict__ ticket, long long n, long long N,
                      int bm, int bn, int tiles_n, int n_tiles, int parts,
                      int rows_per_part) {
  constexpr int V = kVectorised ? Elem<T>::kVec : 1;
  const int tile = blockIdx.x / parts, part = blockIdx.x - tile * parts;
  const long long ti = tile / tiles_n, tj = tile - ti * tiles_n;
  const int r0 = part * rows_per_part;
  const int rows = min(bm - r0, rows_per_part);
  const long long row0 = ti * bm + r0, c0 = tj * bn;
  int zeros = 0;

  if (N == bn) {
    // the slice is one contiguous range of the flat input; what lies past n
    // is padding of the ragged last tile
    const long long start = row0 * N, len = (long long)rows * N;
    long long real = n - start;
    real = real < 0 ? 0 : (real > len ? len : real);
    const long long nv = real / V;
    const T* xs = x + start;
    T* ys = y + start;
    for (long long e0 = threadIdx.x; e0 < nv; e0 += kUnroll * kThreads) {
      if (kVectorised) {
        uint4 v[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long e = e0 + (long long)i * kThreads;
          if (e < nv) v[i] = reinterpret_cast<const uint4*>(xs)[e];
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long e = e0 + (long long)i * kThreads;
          if (e < nv) {
            zeros += Elem<T>::clip_vec(v[i], tau);
            reinterpret_cast<uint4*>(ys)[e] = v[i];
          }
        }
      } else {
        T v[kUnroll];
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long e = e0 + (long long)i * kThreads;
          if (e < nv) v[i] = xs[e];
        }
#pragma unroll
        for (int i = 0; i < kUnroll; ++i) {
          const long long e = e0 + (long long)i * kThreads;
          if (e < nv) {
            zeros += Elem<T>::clip(v[i], tau);
            ys[e] = v[i];
          }
        }
      }
    }
    // the elements of a last vector that n cuts short
    for (long long e = nv * V + threadIdx.x; e < real; e += kThreads) {
      T v = xs[e];
      zeros += Elem<T>::clip(v, tau);
      ys[e] = v;
    }
  } else {
    // a (rows, bn) window of a wider matrix: whole tiles only (n == M * N)
    const int per_row = bn / V;
    const int nv = rows * per_row;
    for (int e = threadIdx.x; e < nv; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * V;
      const long long off = (row0 + r) * N + c0 + c;
      if (kVectorised) {
        uint4 v = *reinterpret_cast<const uint4*>(x + off);
        zeros += Elem<T>::clip_vec(v, tau);
        *reinterpret_cast<uint4*>(y + off) = v;
      } else {
        T v = x[off];
        zeros += Elem<T>::clip(v, tau);
        y[off] = v;
      }
    }
  }

  __shared__ int warp_sums[kThreads / 32];
  __shared__ bool last;
  const int total = block_sum(zeros, warp_sums);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = total;
    __threadfence();             // the word is visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: per-tile counts, then the total. The blocks' words
  // are read side by side and added per tile in shared memory, up to
  // kThreads tiles a round (integer adds: the order does not matter).
  __threadfence();
  __shared__ int tile_sums[kThreads];
  int all = 0;
  for (int base = 0; base < n_tiles; base += kThreads) {
    const int nt = min(kThreads, n_tiles - base);
    if (threadIdx.x < nt) tile_sums[threadIdx.x] = 0;
    __syncthreads();
    for (int b = threadIdx.x; b < nt * parts; b += kThreads) {
      const int v = __ldcg(partial + base * parts + b);
      atomicAdd(tile_sums + b / parts, v);
      all += v;
    }
    __syncthreads();
    if (threadIdx.x < nt) {
      const int tl = base + threadIdx.x;
      // elements of the tile past n (only a contiguous view has them)
      long long real = n - (long long)(tl / tiles_n) * bm * N;
      const long long len = (long long)bm * bn;
      real = real < 0 ? 0 : (real > len ? len : real);
      cnt[tl] = tile_sums[threadIdx.x] + (int)(len - real);
    }
    __syncthreads();
  }
  const int sum = block_sum(all, warp_sums);
  if (threadIdx.x == 0) cnt[n_tiles] = sum;
}

template <typename T>
int launch(const void* x, float tau, void* y, int* cnt, unsigned* ticket,
           long long n, long long M, long long N, int bm, int bn,
           int vectorised, cudaStream_t stream) {
  const long long tiles_m = (M + bm - 1) / bm, tiles_n = N / bn;
  const long long tiles = tiles_m * tiles_n;
  if (n <= 0 || bm <= 0 || bn <= 0 || N % bn || tiles <= 0 ||
      n > M * N || (n < M * N && N != bn) || tiles > (1LL << 24) ||
      n > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // rows per block: 256 to 1024 16-byte vectors, fewer rows when the input
  // is small so that about kTargetBlocks blocks do the work
  const int V = vectorised ? (int)(16 / sizeof(T)) : 1;
  const long long vec_row = bn / V > 0 ? bn / V : 1;
  long long lo = (kThreads + vec_row - 1) / vec_row;
  long long hi = (kUnroll * kThreads) / vec_row;
  if (hi < lo) hi = lo;
  long long rpp = ((n + N - 1) / N) / kTargetBlocks;
  rpp = rpp < lo ? lo : (rpp > hi ? hi : rpp);
  if (rpp > bm) rpp = bm;
  const long long parts = (bm + rpp - 1) / rpp;
  const unsigned grid = (unsigned)(tiles * parts);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const cudaError_t zeroed = cudaMemsetAsync(ticket, 0, sizeof(unsigned),
                                             stream);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (vectorised) {
    act_clip_count_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xp, tau, yp, cnt, cnt + tiles + 1, ticket, n, N, bm, bn, (int)tiles_n,
        (int)tiles, (int)parts, (int)rpp);
  } else {
    act_clip_count_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xp, tau, yp, cnt, cnt + tiles + 1, ticket, n, N, bm, bn, (int)tiles_n,
        (int)tiles, (int)parts, (int)rpp);
  }
  return (int)cudaGetLastError();
}

// ---- the batched entry: B proposals' activations in one launch ---------- //
// x: (R, B, C) row-major -- R rows, each holding C channels of each of B
// proposals side by side (the evaluator's channel-stacked activations, as
// its grouped convolutions make them). Proposal b's elements are clipped at
// taus[b], read from device memory, and counted into cnt[b]. Block
// (part, b) takes rows [part * rows_per_part, +rows_per_part) of proposal
// b's columns; the last block to draw a ticket adds the blocks' words per
// proposal, as the kernel above adds them per tile.
template <typename T, bool kVectorised>
__global__ void __launch_bounds__(kThreads)
act_clip_count_batched_kernel(const T* __restrict__ x,
                              const float* __restrict__ taus,
                              T* __restrict__ y, int* __restrict__ cnt,
                              int* __restrict__ partial,
                              unsigned* __restrict__ ticket, long long R,
                              int B, int C, int rows_per_part) {
  constexpr int V = kVectorised ? Elem<T>::kVec : 1;
  const int part = blockIdx.x, b = blockIdx.y, parts = gridDim.x;
  const float tau = __ldg(taus + b);
  const long long r0 = (long long)part * rows_per_part;
  const long long rows_left = R - r0;
  const int rows = (int)(rows_left < rows_per_part ? rows_left
                                                   : rows_per_part);
  const long long stride = (long long)B * C;
  const T* xb = x + r0 * stride + (long long)b * C;
  T* yb = y + r0 * stride + (long long)b * C;
  const int per_row = C / V;
  const int nv = rows * per_row;
  int zeros = 0;
  for (int e0 = threadIdx.x; e0 < nv; e0 += kUnroll * kThreads) {
    long long off[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int e = e0 + i * kThreads;
      const int r = e / per_row;
      off[i] = r * stride + (long long)(e - r * per_row) * V;
    }
    if (kVectorised) {
      uint4 v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        if (e0 + i * kThreads < nv)
          v[i] = *reinterpret_cast<const uint4*>(xb + off[i]);
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        if (e0 + i * kThreads < nv) {
          zeros += Elem<T>::clip_vec(v[i], tau);
          *reinterpret_cast<uint4*>(yb + off[i]) = v[i];
        }
    } else {
      T v[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        if (e0 + i * kThreads < nv) v[i] = xb[off[i]];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i)
        if (e0 + i * kThreads < nv) {
          zeros += Elem<T>::clip(v[i], tau);
          yb[off[i]] = v[i];
        }
    }
  }

  __shared__ int warp_sums[kThreads / 32];
  __shared__ bool last;
  const int total = block_sum(zeros, warp_sums);
  if (threadIdx.x == 0) {
    partial[b * parts + part] = total;
    __threadfence();             // the word is visible before the ticket
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: each proposal's count, up to kThreads proposals a round
  __threadfence();
  __shared__ int sums[kThreads];
  for (int base = 0; base < B; base += kThreads) {
    const int nb = min(kThreads, B - base);
    if (threadIdx.x < nb) sums[threadIdx.x] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < nb * parts; i += kThreads)
      atomicAdd(sums + i / parts, __ldcg(partial + base * parts + i));
    __syncthreads();
    if (threadIdx.x < nb) cnt[base + threadIdx.x] = sums[threadIdx.x];
    __syncthreads();
  }
}

template <typename T>
int launch_batched(const void* x, const float* taus, void* y, int* cnt,
                   unsigned* ticket, long long R, int B, int C,
                   int rows_per_part, int vectorised, cudaStream_t stream) {
  const int V = vectorised ? (int)(16 / sizeof(T)) : 1;
  if (R <= 0 || B <= 0 || B > 65535 || C <= 0 || C % V ||
      rows_per_part <= 0 || R * C > 2147483647LL ||
      (long long)rows_per_part * (C / V) > 2147483647LL - 4LL * kThreads)
    return (int)cudaErrorInvalidValue;
  const long long parts = (R + rows_per_part - 1) / rows_per_part;
  if (parts * B > 2147483647LL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)parts, (unsigned)B);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const cudaError_t zeroed = cudaMemsetAsync(ticket, 0, sizeof(unsigned),
                                             stream);
  if (zeroed != cudaSuccess) return (int)zeroed;
  if (vectorised) {
    act_clip_count_batched_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xp, taus, yp, cnt, cnt + B, ticket, R, B, C, rows_per_part);
  } else {
    act_clip_count_batched_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xp, taus, yp, cnt, cnt + B, ticket, R, B, C, rows_per_part);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface. x, y: the first n elements of an (M, N) row-major view
// (n == M * N unless N == bn: then the last row and the last row-block may
// be short); N % bn == 0. cnt: tiles + 1 + tiles * bm int32, tiles =
// ceil(M/bm) * (N/bn) -- the per-tile zero counts (tiles row-major; elements
// past n count as zeros), the whole input's zero count, then scratch for the
// blocks' partial counts. ticket: one word of scratch, zeroed here.
// `vectorised` != 0 promises 16-byte aligned x and y and N and bn multiples
// of the 16-byte vector width (4 f32 / 8 bf16). Queues a 4-byte memset and
// one kernel on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not take).
extern "C" int hass_act_clip_count_f32(const void* x, float tau, void* y,
                                       int* cnt, unsigned* ticket,
                                       long long n, long long M, long long N,
                                       int bm, int bn, int vectorised,
                                       void* stream) {
  return launch<float>(x, tau, y, cnt, ticket, n, M, N, bm, bn, vectorised,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int hass_act_clip_count_bf16(const void* x, float tau, void* y,
                                        int* cnt, unsigned* ticket,
                                        long long n, long long M, long long N,
                                        int bm, int bn, int vectorised,
                                        void* stream) {
  return launch<__nv_bfloat16>(x, tau, y, cnt, ticket, n, M, N, bm, bn,
                               vectorised, static_cast<cudaStream_t>(stream));
}

// Batched entry (the TPU kernel under vmap: one float32 tau per batch row).
// x, y: (R, B, C) row-major, proposal b's elements at [r, b, :]. taus: B
// float32 in device memory, so that a captured CUDA graph reads each
// replay's taus. cnt: B + B * ceil(R / rows_per_part) int32 -- each
// proposal's zero count, then scratch for the blocks' partial counts.
// ticket: one word of scratch, zeroed here. `vectorised` != 0 promises
// 16-byte aligned x and y and C a multiple of the 16-byte vector width.
// Queues a 4-byte memset and one kernel on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int hass_act_clip_count_batched_f32(
    const void* x, const void* taus, void* y, int* cnt, unsigned* ticket,
    long long R, int B, int C, int rows_per_part, int vectorised,
    void* stream) {
  return launch_batched<float>(x, static_cast<const float*>(taus), y, cnt,
                               ticket, R, B, C, rows_per_part, vectorised,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int hass_act_clip_count_batched_bf16(
    const void* x, const void* taus, void* y, int* cnt, unsigned* ticket,
    long long R, int B, int C, int rows_per_part, int vectorised,
    void* stream) {
  return launch_batched<__nv_bfloat16>(
      x, static_cast<const float*>(taus), y, cnt, ticket, R, B, C,
      rows_per_part, vectorised, static_cast<cudaStream_t>(stream));
}
