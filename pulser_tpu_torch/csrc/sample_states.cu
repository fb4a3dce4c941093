// Measurement outcomes drawn from the kets of the trajectory-batched
// interaction-picture sesolve (ip_sesolve_batched.cu), for qubits measured
// in their own basis, 10 <= n <= 17.
//
// No TPU kernel: the JAX package draws these shots on the host, from the
// states fetched into host memory. The port's host pass
// (emulator/simulation.py, `_sample_ket_states`) works per (trajectory,
// evaluation time) entry: where the coarsened step asks for it, the state
// divided by its float32 norm (a multiply by the rounded reciprocal); the
// weights |a|^2 in float64, in bitstring order (the state's reversed for
// the ground-rydberg basis); divided by their total and summed
// cumulatively; each of the entry's uniforms drawn by a searchsorted-left,
// capped at the last outcome of positive weight. This kernel computes the
// same draws from the solve's output where it lies, with the uniforms the
// host drew from numpy's generator, and writes only the outcome indices.
//
// What bounds it on an H100: bytes. A batch of T trajectories at E
// evaluation times is T * E * 2^n * 8 bytes of real and imaginary
// planes (spd16: 20 * 101 * 2^16 * 8 = 1.06 GB); the draws themselves are
// a few per state (50 in spd16).
//
// What the design does about it: one 1024-thread block an entry, which
// reads its state from the solve's (T, S, 2, 2^n) planes at the entry's
// segment, so no gather, complex assembly, weight row or cumulative sum
// ever lands in device memory. Thread t owns the 2^n / 1024 consecutive
// outcomes [t C, (t + 1) C) in bitstring order (a contiguous run of the
// state either way round), read as float4 loads from both planes. Three
// passes over the state: the norm (where renormalized), the total weight,
// each thread's sum of its outcomes' normalized weights; then a block
// scan of those sums in shared memory, and each uniform found by a binary
// search over the 1024 chunk ends and a rescan of its one chunk.
//
// Cumulative weights in fixed point. The normalized weight w / total of
// each outcome is rounded once to an integer number of 2^-62 (as
// unsigned 64-bit, exact to well below float64's ulp of 1), so that every
// sum is exact: the chunk ends of the parallel scan equal what the rescan
// of a chunk adds up, bit for bit, the cumulative sum never decreases, and
// an outcome of zero weight adds nothing, so no uniform can draw it. A
// uniform u draws the first outcome whose cumulative integer reaches
// ceil(u 2^62), capped at the row's total (the last outcome of positive
// weight, as the host caps a uniform above a row's rounded total). This
// differs from the host's float64 sums only in rounding, below 1e-15 of a
// cumulative weight; the float32 norm (a float64 sum of float32 squares
// rounded once, numpy's float32 pairwise sum) can differ by an ulp or
// two, which moves a weight by about 1e-7 of itself.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// One unit of the fixed-point cumulative weights is 2^-62.
constexpr double kScale = 4611686018427387904.0;

std::atomic<unsigned long long> g_device_launches{0};

// Calls f(re, im) on a thread's C amplitudes in bitstring order. The
// thread's outcomes are the state indices [lo, lo + C), read upwards, or,
// reversed, downwards from lo + C - 1.
template <int C, typename F>
__device__ __forceinline__ void over_chunk(const float* __restrict__ re,
                                           const float* __restrict__ im,
                                           int lo, bool reverse, F&& f) {
  if constexpr (C >= 4) {
#pragma unroll 4
    for (int g = 0; g < C / 4; ++g) {
      const int s = reverse ? lo + C - 4 * (g + 1) : lo + 4 * g;
      const float4 r = __ldg(reinterpret_cast<const float4*>(re + s));
      const float4 i = __ldg(reinterpret_cast<const float4*>(im + s));
      if (reverse) {
        f(r.w, i.w);
        f(r.z, i.z);
        f(r.y, i.y);
        f(r.x, i.x);
      } else {
        f(r.x, i.x);
        f(r.y, i.y);
        f(r.z, i.z);
        f(r.w, i.w);
      }
    }
  } else {
    for (int j = 0; j < C; ++j) {
      const int s = reverse ? lo + C - 1 - j : lo + j;
      f(__ldg(re + s), __ldg(im + s));
    }
  }
}

// |a|^2 in float64 of one amplitude, after the multiply by the float32
// reciprocal norm where renormalized: hypot, then its square, as numpy's
// abs of a complex128 and its square.
__device__ __forceinline__ double weight(float r, float i, float inv,
                                         bool renormalize) {
  if (renormalize) {
    r = __fmul_rn(r, inv);
    i = __fmul_rn(i, inv);
  }
  const double h = hypot(static_cast<double>(r), static_cast<double>(i));
  return __dmul_rn(h, h);
}

// The normalized weight w / total in units of 2^-62, rounded to nearest.
__device__ __forceinline__ unsigned long long fixed(double w, double total) {
  return total > 0.0 ? __double2ull_rn(__dmul_rn(__ddiv_rn(w, total), kScale))
                     : 0ull;
}

// The block's sum of v, the same in every thread (a butterfly in each warp,
// then one over the warps' sums: each step adds two equal pairs, so every
// lane ends with the same bits).
__device__ __forceinline__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();  // the previous sum's reads of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = red[threadIdx.x & 31];
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  return t;
}

// The block's inclusive prefix sums of v in thread order, into incl.
__device__ __forceinline__ void block_scan(unsigned long long v,
                                           unsigned long long* incl,
                                           unsigned long long* warp_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_end[warp] = v;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = warp_end[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += t;
    }
    warp_end[lane] = w;
  }
  __syncthreads();
  incl[threadIdx.x] = warp > 0 ? v + warp_end[warp - 1] : v;
  __syncthreads();
}

// One block per (trajectory t, evaluation time i) entry e = t * n_times + i,
// which reads segment seg_of[i] of trajectory t and draws u[offs[e]] to
// u[offs[e + 1] - 1] into the same places of out.
template <int N>
__global__ void __launch_bounds__(kThreads)
    sample_states_kernel(const float* __restrict__ planes,
                         const long long* __restrict__ seg_of,
                         const long long* __restrict__ offs,
                         const double* __restrict__ u, int* __restrict__ out,
                         int n_times, int spt, int renormalize, int reverse) {
  constexpr int kDim = 1 << N;
  constexpr int C = kDim / kThreads;
  __shared__ double red[kWarps];
  __shared__ unsigned long long warp_end[kWarps];
  __shared__ unsigned long long incl[kThreads];
  const int e = blockIdx.x;
  const int traj = e / n_times;
  const float* re =
      planes + (static_cast<size_t>(traj) * spt + seg_of[e % n_times]) * 2 *
                   static_cast<size_t>(kDim);
  const float* im = re + kDim;
  const bool rev = reverse != 0, renorm = renormalize != 0;
  const int tid = threadIdx.x;
  const int lo = rev ? kDim - (tid + 1) * C : tid * C;

  float inv = 1.0f;
  if (renorm) {
    double sq = 0.0;
    over_chunk<C>(re, im, lo, rev, [&](float r, float i) {
      sq += static_cast<double>(__fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)));
    });
    const float norm = sqrtf(static_cast<float>(block_sum(sq, red)));
    inv = 1.0f / (norm != 0.0f ? norm : 1.0f);
  }
  double w_sum = 0.0;
  over_chunk<C>(re, im, lo, rev, [&](float r, float i) {
    w_sum += weight(r, i, inv, renorm);
  });
  const double total = block_sum(w_sum, red);
  unsigned long long q_sum = 0;
  over_chunk<C>(re, im, lo, rev, [&](float r, float i) {
    q_sum += fixed(weight(r, i, inv, renorm), total);
  });
  block_scan(q_sum, incl, warp_end);
  const unsigned long long row_total = incl[kThreads - 1];

  const long long first = offs[e], count = offs[e + 1] - first;
  for (long long k = tid; k < count; k += kThreads) {
    unsigned long long target = __double2ull_ru(u[first + k] * kScale);
    if (target > row_total) target = row_total;
    // The first chunk whose end reaches the target (the last one does)
    int a = 0, b = kThreads - 1;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (incl[m] >= target)
        b = m;
      else
        a = m + 1;
    }
    // Its first outcome whose cumulative weight reaches it: the chunk ends
    // at incl[a] exactly, so one does
    unsigned long long run = a > 0 ? incl[a - 1] : 0ull;
    const int chunk_lo = rev ? kDim - (a + 1) * C : a * C;
    int j = 0, hit = C - 1;
    bool found = false;
    over_chunk<C>(re, im, chunk_lo, rev, [&](float r, float i) {
      if (!found) {
        run += fixed(weight(r, i, inv, renorm), total);
        if (run >= target) {
          found = true;
          hit = j;
        }
      }
      ++j;
    });
    out[first + k] = a * C + hit;
  }
}

template <int N>
cudaError_t launch(const float* planes, const long long* seg_of,
                   const long long* offs, const double* u, int* out,
                   int n_entries, int n_times, int spt, int renormalize,
                   int reverse, cudaStream_t st) {
  sample_states_kernel<N><<<n_entries, kThreads, 0, st>>>(
      planes, seg_of, offs, u, out, n_times, spt, renormalize, reverse);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_launches;
  return err;
}

}  // namespace

// Draws every entry's outcomes on `stream`, one block an entry. Device
// inputs: planes (n_traj, spt, 2, 2^n) float32, the real and imaginary
// planes of each trajectory's state after each segment; seg_of (n_times)
// int64, the segment evaluation time i reads; offs (n_traj * n_times + 1)
// int64, entry e = t * n_times + i draws uniforms [offs[e], offs[e + 1]);
// u (offs[last]) float64 uniforms in [0, 1). Output out (offs[last])
// int32, each uniform's outcome index in bitstring order. renormalize:
// divide each state by its float32 norm first; reverse: bitstring order
// is the state's reversed (ground-rydberg). Returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for n outside [10, 17].
extern "C" int sample_states_run(const float* planes, const long long* seg_of,
                                 const long long* offs, const double* u,
                                 int* out, int n_traj, int spt, int n_times,
                                 int n, int renormalize, int reverse,
                                 void* stream) {
  if (n_traj < 1 || spt < 1 || n_times < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_entries = n_traj * n_times;
#define PT_SAMPLE_CASE(NQ)                                                \
  case NQ:                                                                \
    return launch<NQ>(planes, seg_of, offs, u, out, n_entries, n_times,   \
                      spt, renormalize, reverse, st);
  switch (n) {
    PT_SAMPLE_CASE(10) PT_SAMPLE_CASE(11) PT_SAMPLE_CASE(12)
    PT_SAMPLE_CASE(13) PT_SAMPLE_CASE(14) PT_SAMPLE_CASE(15)
    PT_SAMPLE_CASE(16) PT_SAMPLE_CASE(17)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_SAMPLE_CASE
}

// The device kernels this library has launched so far (sample_states_run
// makes one): a caller counts the launches of one call as the difference,
// without a profiler.
extern "C" unsigned long long sample_states_device_launches() {
  return g_device_launches.load();
}
