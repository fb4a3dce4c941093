// Interaction-picture RK4 sesolve for one ground-rydberg basis (d = 2).
//
// Replaces the TPU kernel `_ip_sesolve_kernel` of
// pulser_tpu/ops/pallas_kernels.py (one Pallas grid step per evaluation
// segment, the state resident in VMEM as (R, C) real/imaginary planes).
//
// What bounds it on an H100: every RK4 stage of a 2^n state (n = 16:
// 512 KiB as complex64, more than a block's 227 KB of shared memory)
// needs the n single-flip partners of every amplitude of the previous
// stage, so the stages of a solve are a chain of thousands of small
// grid-wide steps. Per stage the cost is the partner gathers that cross
// blocks (served from the 50 MB L2) and the grid-wide barrier; the
// arithmetic (about 9n + 25 f32 operations per amplitude) is far below
// the card's rate. On an NVIDIA H100 80GB HBM3 at 700 W, a stage of the
// 16-atom sweep takes about 2.75 us, of which the grid barrier alone is
// 1.11 us (chip_smoke.py); the previous design's per-partner rotors and
// per-stage launches took 12.4 us.
//
// What the design does about it: ONE cooperative launch per solve. The
// grid is at most as many blocks of 512 threads as the card keeps
// resident (occupancy API), never more than the 2^n amplitudes fill;
// each thread owns A fixed amplitudes (idx = blockIdx * T + tid + a * G
// for a grid of G threads) for the whole solve, so the state phi, the
// RK4 accumulator, the diagonal and the rotors stay in registers. Each
// stage rotates its input once per amplitude, w = e^{-i Phi} x, and
// publishes w, double-buffered, to shared memory (partners inside the
// block) and to device memory (partners in other blocks, read through
// L2 with ld.global.cg); flips below 32 come by warp shuffle and flips
// at or above G from the thread's own registers. A grid barrier
// (cooperative_groups) separates the stages: four per RK4 step. The
// thread then sums its n partners and applies e^{+i Phi} to its own sum.
// RK4 stages 1 and 2 share the step's midpoint rotor, and the end-of-step
// rotor is carried into the next step whenever the next step's first
// plan row equals it bit for bit (plans from `build_plan` put both at the
// same float64 time), so a step costs two sincosf per amplitude. Warp 0
// of each block prefetches the next step's plan rows into shared memory
// with cp.async and finds the next non-padding step while the current
// one runs; every block skips h = 0 padding steps the same way, so all
// meet the same barriers. Each segment's lab-frame state is written in
// the same launch. The trajectory-batched mode (the TPU kernel's
// `segs_per_traj`) is ip_sesolve_batched.cu's: one block or one
// thread-block cluster per trajectory, side by side.
//
// Conventions, as in the TPU kernel: qubit q is bit n-1-q of the flat
// index (MSB first). The drive on qubit q is M_q = a_q |1><0| + conj(a_q)
// |0><1|: the imaginary part enters with +a_im where the OUTPUT index has
// bit q set and -a_im where it does not. The phase is
//   Phi(idx) = ((diag[idx] * t) mod 2pi) + sum_q cum_q - sum_q cum_q bit_q(idx)
// with a floored mod (jnp.mod): fmodf truncates, so its sign is fixed up.
// sincosf (not __sincosf) keeps full accuracy for arguments of ~100 rad.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;
using pt::cp_async4;
using pt::cp_async_wait_all;
using pt::first_real;
using pt::kFull;
using pt::step_window;

namespace {

constexpr int kMinQubits = 10;
constexpr int kMaxQubits = 17;
constexpr int kMaxThreads = 512;
constexpr float kTwoPi = 6.283185307179586f;

// Device kernel launches this library has made (ip_sesolve_device_launches).
std::atomic<unsigned long long> g_device_launches{0};

__device__ __forceinline__ float floored_mod_2pi(float x) {
  float r = fmodf(x, kTwoPi);
  return r < 0.0f ? r + kTwoPi : r;
}

// One RK4 step's three plan rows (t, t + h/2, t + h) and its bookkeeping.
template <int N>
struct Rows {
  float t[3];
  float cum[3][N];
  float a_re[3][N];
  float a_im[3][N];
  float h;
  float cum_sum[3];  // sum_q cum_q, in q order
  int carry;  // row 0 equals the previous step's row 2, bit for bit
  int step;   // flat index s * L + i, or n_seg * L past the last step
  int next;   // flat index of the next non-padding step
};

// Warp 0: starts the copy of step `step`'s rows into `r` (cp.async).
template <int N>
__device__ void issue_rows(Rows<N>& r, int step, const float* a_re,
                           const float* a_im, const float* cum,
                           const float* t_stage, const float* seg_dts) {
  const int lane = threadIdx.x & 31;
  const long o = static_cast<long>(step) * 3 * N;
  for (int e = lane; e < 3 * N; e += 32) {
    cp_async4(&r.cum[0][0] + e, cum + o + e);
    cp_async4(&r.a_re[0][0] + e, a_re + o + e);
    cp_async4(&r.a_im[0][0] + e, a_im + o + e);
  }
  if (lane < 3) cp_async4(&r.t[lane], t_stage + static_cast<long>(step) * 3 + lane);
  if (lane == 3) cp_async4(&r.h, seg_dts + step);
}

// Warp 0: waits for the copy into `r` and fills its derived fields.
// `prev` is the previous step's rows (for the carry test), or null.
template <int N>
__device__ void finish_rows(Rows<N>& r, const Rows<N>* prev, int step,
                            int next) {
  const int lane = threadIdx.x & 31;
  cp_async_wait_all();
  __syncwarp();
  if (lane < 3) {
    float s = 0.0f;
    for (int q = 0; q < N; ++q) s += r.cum[lane][q];
    r.cum_sum[lane] = s;
  }
  bool same = false;
  if (prev != nullptr) {
    const float mine = lane < N ? r.cum[0][lane] : r.t[0];
    const float theirs = lane < N ? prev->cum[2][lane] : prev->t[2];
    same = lane > N || __float_as_uint(mine) == __float_as_uint(theirs);
  }
  const bool carry = __all_sync(kFull, same);
  if (lane == 0) {
    r.carry = carry ? 1 : 0;
    r.step = step;
    r.next = next;
  }
}

template <int N, int A>
struct Shape {
  static constexpr int kDim = 1 << N;
  static constexpr int kGrid = kDim / A;  // threads in the grid
  static constexpr int kThreads = kGrid < kMaxThreads ? kGrid : kMaxThreads;
  static constexpr int kBlocks = kGrid / kThreads;
  static_assert(kThreads >= 32, "a block must hold a full warp");
};

// e^{-i Phi(idx)} as (c, s) for the row's time and phase integrals.
template <int N>
__device__ __forceinline__ void rotor(int idx, float dg, float t,
                                      const float* cum, float cum_sum,
                                      float& c, float& s) {
  float ph = floored_mod_2pi(dg * t) + cum_sum;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const bool bit = (idx >> (N - 1 - q)) & 1;
    ph = bit ? ph - cum[q] : ph;
  }
  sincosf(ph, &s, &c);
}

template <int N, int A>
__global__ void __launch_bounds__(Shape<N, A>::kThreads,
                                   A == 1 ? 1024 / Shape<N, A>::kThreads : 1)
ip_sesolve_kernel(const float* __restrict__ a_re,
                  const float* __restrict__ a_im,
                  const float* __restrict__ cum,
                  const float* __restrict__ t_stage,
                  const float* __restrict__ seg_dts,
                  const float* __restrict__ eval_t,
                  const float* __restrict__ eval_cum,
                  const float* __restrict__ diag,
                  const float* __restrict__ psi0_re,
                  const float* __restrict__ psi0_im,
                  float* __restrict__ out, float2* __restrict__ wbuf,
                  int n_seg, int L) {
  using S = Shape<N, A>;
  constexpr int T = S::kThreads, G = S::kGrid, D = S::kDim;
  __shared__ float2 s_w[2][A * T];
  __shared__ Rows<N> s_rows[2];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gtid = blockIdx.x * T + tid;
  const int total = n_seg * L;
  float2* gw[2] = {wbuf, wbuf + D};

  float2 phi[A];
  float dg[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int idx = gtid + a * G;
    phi[a] = make_float2(psi0_re[idx], psi0_im[idx]);
    dg[a] = diag[idx];
  }
  if (warp == 0) {
    const int first = first_real(seg_dts, 0, total, step_window(seg_dts, 0, total));
    if (first < total) {
      issue_rows(s_rows[0], first, a_re, a_im, cum, t_stage, seg_dts);
      const int next =
          first_real(seg_dts, first + 1, total,
                     step_window(seg_dts, first + 1, total));
      finish_rows(s_rows[0], static_cast<const Rows<N>*>(nullptr), first,
                  next);
    } else if (lane == 0) {
      s_rows[0].step = total;
    }
  }
  __syncthreads();

  // Publishes this thread's w into buffer b (shared and device memory).
  auto publish = [&](const float2 (&w)[A], int b) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      if constexpr (T > 32) s_w[b][a * T + tid] = w[a];
      if constexpr (S::kBlocks > 1) __stcg(gw[b] + gtid + a * G, w[a]);
    }
  };
  // y = sum_q coef_q(idx) w[idx ^ m_q] for each amplitude, from buffer b.
  auto gather = [&](const float2 (&w)[A], int b, const float* are,
                    const float* aim, float2 (&y)[A]) {
#pragma unroll
    for (int a = 0; a < A; ++a) y[a] = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int m = 1 << (N - 1 - q);
      const float ar = are[q], ai0 = aim[q];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = gtid + a * G;
        float2 f;
        if (m < 32) {
          f.x = __shfl_xor_sync(kFull, w[a].x, m);
          f.y = __shfl_xor_sync(kFull, w[a].y, m);
        } else if (m < T) {
          f = s_w[b][a * T + (tid ^ m)];
        } else if (m < G) {
          f = __ldcg(gw[b] + (idx ^ m));
        } else {
          f = w[a ^ (m / G)];
        }
        const float ai = (idx & m) ? ai0 : -ai0;
        y[a].x += ar * f.x - ai * f.y;
        y[a].y += ar * f.y + ai * f.x;
      }
    }
  };

  const float b_w[4] = {1.0f / 6.0f, 1.0f / 3.0f, 1.0f / 3.0f, 1.0f / 6.0f};
  float c0[A] = {}, s0[A] = {}, c1[A] = {}, s1[A] = {};  // rows 0/2, 1
  float2 acc[A], w[A], y[A];
  int p = 0, emitted = 0;
  for (;;) {
    const Rows<N>& r = s_rows[p];
    const int step = r.step;
    const int seg = step < total ? step / L : n_seg;
    for (; emitted < seg; ++emitted) {
      // The lab-frame state after segment `emitted`
      const float te = __ldg(eval_t + emitted);
      const float* ec = eval_cum + static_cast<long>(emitted) * N;
      float esum = 0.0f;
#pragma unroll
      for (int q = 0; q < N; ++q) esum += __ldg(ec + q);
      float ecum[N];
#pragma unroll
      for (int q = 0; q < N; ++q) ecum[q] = __ldg(ec + q);
      float* o = out + static_cast<long>(emitted) * 2 * D;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = gtid + a * G;
        float c, s;
        rotor<N>(idx, dg[a], te, ecum, esum, c, s);
        o[idx] = c * phi[a].x + s * phi[a].y;
        o[D + idx] = c * phi[a].y - s * phi[a].x;
      }
    }
    if (step >= total) break;
    const float h = r.h;
    Rows<N>& nr = s_rows[p ^ 1];
    const int nxt = r.next;
    float win = 0.0f;

    // Stage 0: w = R0 phi (R0 carried from the previous step's row 2)
    if (!r.carry) {
#pragma unroll
      for (int a = 0; a < A; ++a)
        rotor<N>(gtid + a * G, dg[a], r.t[0], r.cum[0], r.cum_sum[0], c0[a],
                 s0[a]);
    }
#pragma unroll
    for (int a = 0; a < A; ++a)
      w[a] = make_float2(c0[a] * phi[a].x + s0[a] * phi[a].y,
                         c0[a] * phi[a].y - s0[a] * phi[a].x);
    publish(w, 0);
    grid.sync();
    if (warp == 0 && nxt < total) {
      issue_rows(nr, nxt, a_re, a_im, cum, t_stage, seg_dts);
      win = step_window(seg_dts, nxt + 1, total);
    }
    gather(w, 0, r.a_re[0], r.a_im[0], y);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      // k = -i e^{i Phi} y
      const float zr = c0[a] * y[a].x - s0[a] * y[a].y;
      const float zi = c0[a] * y[a].y + s0[a] * y[a].x;
      const float2 k = make_float2(zi, -zr);
      acc[a] = make_float2(b_w[0] * k.x, b_w[0] * k.y);
      const float ha = h * 0.5f;
      const float2 x = make_float2(phi[a].x + ha * k.x, phi[a].y + ha * k.y);
      rotor<N>(gtid + a * G, dg[a], r.t[1], r.cum[1], r.cum_sum[1], c1[a],
               s1[a]);
      w[a] = make_float2(c1[a] * x.x + s1[a] * x.y, c1[a] * x.y - s1[a] * x.x);
    }
    publish(w, 1);
    grid.sync();

    // Stages 1 and 2 share the midpoint rotor
#pragma unroll
    for (int j = 1; j <= 2; ++j) {
      gather(w, j & 1, r.a_re[1], r.a_im[1], y);
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float zr = c1[a] * y[a].x - s1[a] * y[a].y;
        const float zi = c1[a] * y[a].y + s1[a] * y[a].x;
        const float2 k = make_float2(zi, -zr);
        acc[a].x += b_w[j] * k.x;
        acc[a].y += b_w[j] * k.y;
        const float ha = h * (j == 1 ? 0.5f : 1.0f);
        const float2 x =
            make_float2(phi[a].x + ha * k.x, phi[a].y + ha * k.y);
        if (j == 2)
          rotor<N>(gtid + a * G, dg[a], r.t[2], r.cum[2], r.cum_sum[2],
                   c0[a], s0[a]);
        const float c = j == 1 ? c1[a] : c0[a];
        const float s = j == 1 ? s1[a] : s0[a];
        w[a] = make_float2(c * x.x + s * x.y, c * x.y - s * x.x);
      }
      publish(w, (j + 1) & 1);
      if (j == 2 && warp == 0) {
        if (nxt < total) {
          const int after = first_real(seg_dts, nxt + 1, total, win);
          finish_rows(nr, &r, nxt, after);
        } else if (lane == 0) {
          nr.step = total;
        }
      }
      grid.sync();
    }

    // Stage 3, with the end-of-step rotor R2 (kept in c0, s0)
    gather(w, 1, r.a_re[2], r.a_im[2], y);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float zr = c0[a] * y[a].x - s0[a] * y[a].y;
      const float zi = c0[a] * y[a].y + s0[a] * y[a].x;
      const float2 k = make_float2(zi, -zr);
      const float2 sum =
          make_float2(acc[a].x + b_w[3] * k.x, acc[a].y + b_w[3] * k.y);
      phi[a] = make_float2(phi[a].x + h * sum.x, phi[a].y + h * sum.y);
    }
    p ^= 1;
  }
}

// Grid barriers alone, on K1's grid: what the barriers of a solve cost
// without its work (a measurement aid, not on any solve path).
__global__ void barrier_probe_kernel(int stages) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < stages; ++i) grid.sync();
}

template <int N, int A>
cudaError_t try_launch(const float* a_re, const float* a_im, const float* cum,
                       const float* t_stage, const float* seg_dts,
                       const float* eval_t, const float* eval_cum,
                       const float* diag, const float* psi0_re,
                       const float* psi0_im, float* out, void* wbuf,
                       int n_seg, int L, cudaStream_t st, int* config,
                       bool* fits) {
  using S = Shape<N, A>;
  auto kern = ip_sesolve_kernel<N, A>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        S::kThreads, 0);
  if (err != cudaSuccess) return err;
  *fits = S::kBlocks <= per_sm * sms;
  if (!*fits) return cudaSuccess;
  if (config != nullptr) {
    config[0] = S::kBlocks;
    config[1] = S::kThreads;
    config[2] = A;
    return cudaSuccess;
  }
  float2* w = static_cast<float2*>(wbuf);
  void* args[] = {&a_re,    &a_im,    &cum, &t_stage, &seg_dts,
                  &eval_t,  &eval_cum, &diag, &psi0_re, &psi0_im,
                  &out,     &w,       &n_seg, &L};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                    dim3(S::kBlocks), dim3(S::kThreads), args,
                                    0, st);
  if (err == cudaSuccess) ++g_device_launches;
  return err;
}

// The smallest number of amplitudes per thread whose grid is
// co-resident on the card, then the launch (or, with `config`, only the
// grid's blocks, threads and amplitudes per thread).
template <int N>
cudaError_t launch_n(const float* a_re, const float* a_im, const float* cum,
                     const float* t_stage, const float* seg_dts,
                     const float* eval_t, const float* eval_cum,
                     const float* diag, const float* psi0_re,
                     const float* psi0_im, float* out, void* wbuf, int n_seg,
                     int L, cudaStream_t st, int* config) {
  bool fits = false;
  cudaError_t err = try_launch<N, 1>(
      a_re, a_im, cum, t_stage, seg_dts, eval_t, eval_cum, diag, psi0_re,
      psi0_im, out, wbuf, n_seg, L, st, config, &fits);
  if (err != cudaSuccess || fits) return err;
  if constexpr (N >= 17) {
    err = try_launch<N, 2>(
        a_re, a_im, cum, t_stage, seg_dts, eval_t, eval_cum, diag, psi0_re,
        psi0_im, out, wbuf, n_seg, L, st, config, &fits);
    if (err != cudaSuccess || fits) return err;
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

cudaError_t dispatch(int n, const float* a_re, const float* a_im,
                     const float* cum, const float* t_stage,
                     const float* seg_dts, const float* eval_t,
                     const float* eval_cum, const float* diag,
                     const float* psi0_re, const float* psi0_im, float* out,
                     void* wbuf, int n_seg, int L, cudaStream_t st,
                     int* config) {
#define PT_IP_CASE(NQ)                                                      \
  case NQ:                                                                  \
    return launch_n<NQ>(a_re, a_im, cum, t_stage, seg_dts, eval_t,          \
                        eval_cum, diag, psi0_re, psi0_im, out, wbuf, n_seg, \
                        L, st, config);
  switch (n) {
    PT_IP_CASE(10) PT_IP_CASE(11) PT_IP_CASE(12) PT_IP_CASE(13)
    PT_IP_CASE(14) PT_IP_CASE(15) PT_IP_CASE(16) PT_IP_CASE(17)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_IP_CASE
}

}  // namespace

// Runs the whole solve on `stream` as one cooperative launch. Device
// inputs, in the layout of the TPU kernel's `_ip_sesolve_jit`: a_re,
// a_im, cum (n_seg, L*3, n); t_stage (n_seg, L*3); seg_dts (n_seg, L),
// zero entries are padding and skipped; eval_t (n_seg); eval_cum (n_seg,
// n); diag, psi0_re, psi0_im (2^n). Output `out` is (n_seg, 2, 2^n).
// Scratch `wbuf`: the double-buffered rotated stage input, (2, 2^n)
// float2. Returns a cudaError_t (0 on success):
// cudaErrorCooperativeLaunchTooLarge when no grid for n is co-resident,
// cudaErrorInvalidValue for n outside [10, 17].
extern "C" int ip_sesolve_run(const float* a_re, const float* a_im,
                              const float* cum, const float* t_stage,
                              const float* seg_dts, const float* eval_t,
                              const float* eval_cum, const float* diag,
                              const float* psi0_re, const float* psi0_im,
                              float* out, void* wbuf, int n_seg, int seg_len,
                              int n, void* stream) {
  if (n < kMinQubits || n > kMaxQubits || n_seg < 1 || seg_len < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = dispatch(n, a_re, a_im, cum, t_stage, seg_dts, eval_t,
                             eval_cum, diag, psi0_re, psi0_im, out, wbuf,
                             n_seg, seg_len, static_cast<cudaStream_t>(stream),
                             nullptr);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The grid ip_sesolve_run launches for n qubits on the current device:
// config = (blocks, threads per block, amplitudes per thread).
extern "C" int ip_sesolve_config(int n, int* config) {
  if (n < kMinQubits || n > kMaxQubits) return cudaErrorInvalidValue;
  return dispatch(n, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
                  nullptr, config);
}

// Runs `stages` grid barriers and nothing else, as one cooperative launch
// of `blocks` x `threads` (the grid ip_sesolve_config reports).
extern "C" int ip_sesolve_barrier_probe(int blocks, int threads, int stages,
                                        void* stream) {
  void* args[] = {&stages};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(barrier_probe_kernel), dim3(blocks),
      dim3(threads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  ++g_device_launches;
  return cudaGetLastError();
}

// The device kernels this library has launched so far (ip_sesolve_run
// and ip_sesolve_barrier_probe make one each): a caller counts the
// launches of one call as the difference, without a profiler.
extern "C" unsigned long long ip_sesolve_device_launches() {
  return g_device_launches.load();
}
