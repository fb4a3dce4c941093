// Trajectory-batched interaction-picture RK4 sesolve for one
// ground-rydberg basis (d = 2), 10 <= n <= 13: one thread block per
// trajectory.
//
// Replaces the trajectory-batched mode of the TPU kernel
// `_ip_sesolve_kernel` of pulser_tpu/ops/pallas_kernels.py
// (`segs_per_traj`: the Pallas grid flattens (trajectory, segment), runs
// it in order on one core, resets the state from psi0 at every
// trajectory's first segment and reads that trajectory's interaction
// diagonal). For n >= 14 the state no longer fits one block and the
// batched mode runs in the cooperative kernel of ip_sesolve.cu.
//
// Each RK4 stage computes, in the interaction picture of the diagonal,
//   k = -i e^{+i Phi} sum_q M_q (e^{-i Phi} x)[flip_q],
// and each segment end emits e^{-i Phi(t_eval)} phi, the lab-frame state.
// Noise trajectories without collapse operators differ in their drive
// rows (amplitude noise), their phase integrals (doppler) and their
// diagonal; they share the initial state.
//
// What bounds it on an H100: a trajectory is a chain of hundreds of small
// dependent RK4 stages over 2^n amplitudes (about 9n + 25 f32 operations
// per amplitude and stage), so the latency of a stage and the block
// barrier between two stages bound it, not bytes: a stage reads 3n drive
// values, and the state is 8 KB per real plane at n = 10. The
// trajectories are independent, so nothing has to cross blocks and no
// grid barrier is paid (1.11 us of the 2.75 us stage of the cooperative
// kernel). On an NVIDIA H100 80GB HBM3 at 700 W a stage of SPD10 (n = 10,
// 100 trajectories at once) takes about 1.3 us (chip_smoke.py), as much
// as mcwf_rows.cu's on the same card: the barrier and the latency of a
// stage, not its arithmetic.
//
// What the design does about it: the structure of mcwf_rows.cu without
// decay, norm and jumps. One block of 1024 threads per trajectory, the
// whole batch in ONE launch; the block loops over its trajectory's
// segments and steps and skips the zero-length padding steps. Templated
// on n. Each thread owns 1/2/4/8 fixed amplitudes (idx = tid + a * 1024);
// its phi, the RK4 accumulator, its diagonal and its current rotor (cos,
// sin) live in registers. Only the rotated stage input w = e^{-i Phi} x
// goes to shared memory, double-buffered (16 * 2^n bytes: 128 KiB at
// n = 13). Flip partners below 32 come by __shfl_xor_sync, the others
// from shared memory. A stage is one pass ending in ONE block barrier,
// four per step: gather the partners of w_j, rotate back, form k_j,
// accumulate, form the next stage input, rotate it and publish it to the
// other buffer; the last stage publishes the rotated new state, which is
// the next step's first stage input. Stages 1 and 2 share the midpoint
// rotor, and the end-of-step rotor is carried into the next non-padding
// step whenever warp 0 finds that step's first row (stage time and the n
// phase integrals) equal to it bit for bit; otherwise the rotor is
// recomputed and the first stage input republished (one more barrier),
// so the kernel is right on any input. Warp 0 copies the next step's
// rows into shared memory with cp.async while the current step runs and
// finds the next non-padding step.
//
// Registers: 1024 threads cap a thread at 64 registers. From
// kLeanFromAmps amplitudes per thread on the diagonal is re-read where a
// rotor needs it; from kSharedAccFromAmps on the RK4 accumulator lives in
// a third complex plane of shared memory (64 KiB at n = 13).
// tools/block_sizes.py times the alternatives on that card: 1024 threads
// beat 512 and 256 at n = 10 (2.55 / 2.63 / 3.24 ms on SPD10) and at
// n = 11 to 13 (n = 13: 9.9 ms against 13.4 ms, 100 trajectories of 254
// steps); keeping everything in registers is within 4% either way.
//
// Conventions, as in the TPU kernel: qubit q is bit n-1-q of the flat
// index (MSB first). The drive on qubit q enters with +a_im where the
// OUTPUT index has bit q set and -a_im where not. The phase is
//   Phi(i) = ((diag[i] * t) mod 2pi) + sum_q cum_q - sum_q cum_q bit_q(i)
// with a floored mod (jnp.mod): fmodf truncates, so its sign is fixed up.
// sincosf (not __sincosf) holds full accuracy at phases of ~100 rad.

#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace {

using pt::cp_async4;
using pt::cp_async_wait_all;
using pt::first_real;
using pt::kFull;
using pt::step_window;

constexpr int kMinQubits = 10;
constexpr int kMaxQubits = 13;
constexpr int kThreads = 1024;
constexpr int kLeanFromAmps = 4;
constexpr int kSharedAccFromAmps = 8;
constexpr float kTwoPi = 6.283185307179586f;

// Device kernel launches this library has made
// (ip_sesolve_batched_device_launches).
std::atomic<unsigned long long> g_device_launches{0};

__device__ __forceinline__ float floored_mod_2pi(float x) {
  float r = fmodf(x, kTwoPi);
  return r < 0.0f ? r + kTwoPi : r;
}

template <int N>
struct Shape {
  static constexpr int kDim = 1 << N;
  static constexpr int kAmps = kDim / kThreads;
  static constexpr bool kLean = kAmps >= kLeanFromAmps;
  static constexpr bool kSharedAcc = kAmps >= kSharedAccFromAmps;
  // Two planes of w, and the accumulator's where it lives there
  static constexpr int kSmemBytes =
      (kSharedAcc ? 3 : 2) * kDim * static_cast<int>(sizeof(float2));
  static_assert(kAmps >= 1, "a block holds at least 1024 amplitudes");
};

// One RK4 step's three plan rows (t, t + h/2, t + h) of one trajectory and
// its bookkeeping.
template <int N>
struct Rows {
  float2 coef[3][N];  // (a_re, a_im)
  float cum[3][N];
  float cum_sum[3];  // sum_q cum_q, in q order
  float t[3];
  float h;
  int carry;  // row 0 equals the previous step's row 2, bit for bit
  int step;   // index s * L + i in the trajectory, or S * L past its end
  int next;   // index of the next non-padding step
};

// Warp 0: starts copying plan row `row` (a flat step index over all
// trajectories) into `r` (cp.async).
template <int N>
__device__ void fetch_rows(Rows<N>& r, long row, const float* a_re,
                           const float* a_im, const float* cum,
                           const float* t_stage, const float* seg_dts) {
  const int lane = threadIdx.x & 31;
  const long o = row * 3 * N;
  float* coef = reinterpret_cast<float*>(&r.coef[0][0]);
  for (int e = lane; e < 3 * N; e += 32) {
    cp_async4(coef + 2 * e, a_re + o + e);
    cp_async4(coef + 2 * e + 1, a_im + o + e);
    cp_async4(&r.cum[0][0] + e, cum + o + e);
  }
  if (lane < 3) cp_async4(&r.t[lane], t_stage + row * 3 + lane);
  if (lane == 3) cp_async4(&r.h, seg_dts + row);
}

// Warp 0: waits for the copy into `r` and fills its derived fields. `prev`
// is the previous step's rows (for the carry test), or null.
template <int N>
__device__ void finish_rows(Rows<N>& r, const Rows<N>* prev, int f,
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
    r.step = f;
    r.next = next;
  }
}

// e^{-i Phi(idx)} as (c, s) for a row's time and phase integrals.
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

// w = e^{-i Phi} x
__device__ __forceinline__ float2 rotate(float c, float s, float2 x) {
  return make_float2(c * x.x + s * x.y, c * x.y - s * x.x);
}

// The flip partner idx ^ m of amplitude `idx` in plane `w`; `own` is the
// amplitude's own value there. Flips below 32 come from the lane idx ^ m
// of the same warp, so every lane must call this with the same m.
__device__ __forceinline__ float2 partner(const float2* w, int idx, int m,
                                         float2 own) {
  if (m < 32)
    return make_float2(__shfl_xor_sync(kFull, own.x, m),
                       __shfl_xor_sync(kFull, own.y, m));
  return w[idx ^ m];
}

// RK4 weights: stage j adds b_j k_j to the accumulator, and the stage
// input of stage j + 1 is phi + h a_{j+1} k_j.
__device__ __forceinline__ float rk_b(int j) {
  return j == 0 || j == 3 ? 1.0f / 6.0f : 1.0f / 3.0f;
}
__device__ __forceinline__ float rk_a_next(int j) {
  return j == 2 ? 1.0f : 0.5f;
}

// Block b solves trajectory b: plan rows [b * S * L, (b + 1) * S * L).
template <int N>
__global__ void __launch_bounds__(kThreads)
ip_sesolve_batched_kernel(const float* __restrict__ a_re,
                          const float* __restrict__ a_im,
                          const float* __restrict__ cum,
                          const float* __restrict__ t_stage,
                          const float* __restrict__ seg_dts,
                          const float* __restrict__ eval_t,
                          const float* __restrict__ eval_cum,
                          const float* __restrict__ diags,
                          const float* __restrict__ psi0_re,
                          const float* __restrict__ psi0_im,
                          float* __restrict__ out, int S, int L) {
  using Sh = Shape<N>;
  constexpr int D = Sh::kDim, T = kThreads, A = Sh::kAmps;
  constexpr bool kLean = Sh::kLean, kSharedAcc = Sh::kSharedAcc;
  extern __shared__ float2 s_w[];  // two planes of w (and the accumulator)
  __shared__ Rows<N> s_rows[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int total = S * L;
  const long row0 = static_cast<long>(b) * total;
  // This trajectory's step sizes, diagonal and evaluation rows
  const float* dts = seg_dts + row0;
  const float* diag = diags + static_cast<long>(b) * D;
  const long seg0 = static_cast<long>(b) * S;
  float2* s_acc = s_w + 2 * D;

  float2 phi[A];
  float2 acc[kSharedAcc ? 1 : A];
  float dg[kLean ? 1 : A];
  float c[A], s[A];
  // Amplitude a's diagonal, from registers or anew
  auto diag_of = [&](int a, int idx) {
    if constexpr (Sh::kLean)
      return __ldg(diag + idx);
    else
      return dg[a];
  };
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int idx = tid + a * T;
    phi[a] = make_float2(psi0_re[idx], psi0_im[idx]);
    c[a] = 1.0f;
    s[a] = 0.0f;
    if constexpr (!kLean) dg[a] = diag[idx];
  }
  if (warp == 0) {
    const int first = first_real(dts, 0, total, step_window(dts, 0, total));
    if (first < total) {
      fetch_rows(s_rows[0], row0 + first, a_re, a_im, cum, t_stage, seg_dts);
      const int next = first_real(dts, first + 1, total,
                                  step_window(dts, first + 1, total));
      finish_rows(s_rows[0], static_cast<const Rows<N>*>(nullptr), first,
                  next);
    } else if (lane == 0) {
      s_rows[0].step = total;
    }
  }
  int emitted = 0, p = 0;
  // Whether plane 0 holds the rotated phi under the rotor in (c, s)
  bool fresh = false;
  __syncthreads();

  for (;;) {
    const Rows<N>& rw = s_rows[p];
    const int f = rw.step;
    const int seg = f < total ? f / L : S;
    for (; emitted < seg; ++emitted) {
      // Emit the lab-frame state e^{-i Phi(t_eval)} phi
      const float te = __ldg(eval_t + seg0 + emitted);
      const float* ec = eval_cum + (seg0 + emitted) * N;
      float esum = 0.0f;
#pragma unroll
      for (int q = 0; q < N; ++q) esum += __ldg(ec + q);
      float* o = out + (seg0 + emitted) * 2 * D;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = tid + a * T;
        float ce, se;
        rotor<N>(idx, diag_of(a, idx), te, ec, esum, ce, se);
        const float2 lab = rotate(ce, se, phi[a]);
        o[idx] = lab.x;
        o[D + idx] = lab.y;
      }
    }
    if (f >= total) break;
    const float h = rw.h;
    const int nxt = rw.next;
    Rows<N>& nr = s_rows[p ^ 1];
    float win = 0.0f;
    if (warp == 0 && nxt < total) {
      fetch_rows(nr, row0 + nxt, a_re, a_im, cum, t_stage, seg_dts);
      win = step_window(dts, nxt + 1, total);
    }
    // The rotor of row 0: carried from the previous step's row 2, or
    // recomputed; plane 0 then holds w_0 = e^{-i Phi} phi unless the rotor
    // is new (block-uniform).
    const bool carry = rw.carry != 0;
    if (!carry || !fresh) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = tid + a * T;
        if (!carry)
          rotor<N>(idx, diag_of(a, idx), rw.t[0], rw.cum[0], rw.cum_sum[0],
                   c[a], s[a]);
        s_w[idx] = rotate(c[a], s[a], phi[a]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Stage j reads plan row sidx, stage j + 1 row nrow
      const int sidx = (j + 1) >> 1, nrow = (j + 2) >> 1;
      // Stage j reads plane j & 1 and publishes the next input to the other
      const float2* win_j = s_w + (j & 1) * D;
      float2* wout = s_w + ((j + 1) & 1) * D;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = tid + a * T;
        const float2 w = win_j[idx];
        float yr = 0.0f, yi = 0.0f;
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const int m = 1 << (N - 1 - q);
          const float2 fp = partner(win_j, idx, m, w);
          const float2 cf = rw.coef[sidx][q];
          const float ai = (idx & m) ? cf.y : -cf.y;
          yr = yr + cf.x * fp.x - ai * fp.y;
          yi = yi + cf.x * fp.y + ai * fp.x;
        }
        // k_j = -i e^{+i Phi} y
        const float kr = c[a] * yi + s[a] * yr;
        const float ki = s[a] * yi - c[a] * yr;
        float2 sum;
        if (j == 0) {
          sum = make_float2(rk_b(0) * kr, rk_b(0) * ki);
        } else {
          float2 old;
          if constexpr (kSharedAcc)
            old = s_acc[idx];
          else
            old = acc[a];
          sum = make_float2(old.x + rk_b(j) * kr, old.y + rk_b(j) * ki);
        }
        if (j < 3) {
          if constexpr (kSharedAcc)
            s_acc[idx] = sum;
          else
            acc[a] = sum;
          const float ha = h * rk_a_next(j);
          const float2 xn =
              make_float2(phi[a].x + ha * kr, phi[a].y + ha * ki);
          // Rows 1 (stages 1 and 2) and 2 (stage 3 and, carried, the
          // next step's stage 0) get their rotor here
          if (nrow != sidx)
            rotor<N>(idx, diag_of(a, idx), rw.t[nrow], rw.cum[nrow],
                     rw.cum_sum[nrow], c[a], s[a]);
          wout[idx] = rotate(c[a], s[a], xn);
        } else {
          // phi <- phi + h acc; rotated, it is the next step's w_0
          phi[a] = make_float2(phi[a].x + h * sum.x, phi[a].y + h * sum.y);
          wout[idx] = rotate(c[a], s[a], phi[a]);
        }
      }
      if (j == 2 && warp == 0) {
        // The next step's rows, for the barrier that ends stage 3
        if (nxt < total) {
          const int after = first_real(dts, nxt + 1, total, win);
          finish_rows(nr, &rw, nxt, after);
        } else if (lane == 0) {
          nr.step = total;
        }
      }
      __syncthreads();
    }
    p ^= 1;
    fresh = true;
  }
}

template <int N>
cudaError_t launch(const float* a_re, const float* a_im, const float* cum,
                   const float* t_stage, const float* seg_dts,
                   const float* eval_t, const float* eval_cum,
                   const float* diags, const float* psi0_re,
                   const float* psi0_im, float* out, int n_traj, int S, int L,
                   cudaStream_t st) {
  using Sh = Shape<N>;
  cudaError_t err = cudaFuncSetAttribute(
      ip_sesolve_batched_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
  if (err != cudaSuccess) return err;
  ip_sesolve_batched_kernel<N><<<n_traj, kThreads, Sh::kSmemBytes, st>>>(
      a_re, a_im, cum, t_stage, seg_dts, eval_t, eval_cum, diags, psi0_re,
      psi0_im, out, S, L);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_launches;
  return err;
}

}  // namespace

// Runs the whole batch on `stream`, one block per trajectory. Device
// inputs, in the layout of the TPU kernel's `_ip_sesolve_jit` with
// `segs_per_traj = S` (B trajectories, trajectory-major): a_re, a_im, cum
// (B * S, L, 3, n); t_stage (B * S, L, 3); seg_dts (B * S, L), zero
// entries are padding and skipped; eval_t (B * S); eval_cum (B * S, n);
// diags (B, 2^n); psi0_re, psi0_im (2^n). Output `out` is (B * S, 2, 2^n),
// the lab-frame state after each segment. Returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for n outside [10, 13].
extern "C" int ip_sesolve_batched_run(
    const float* a_re, const float* a_im, const float* cum,
    const float* t_stage, const float* seg_dts, const float* eval_t,
    const float* eval_cum, const float* diags, const float* psi0_re,
    const float* psi0_im, float* out, int n_traj, int segs_per_traj,
    int seg_len, int n, void* stream) {
  if (n < kMinQubits || n > kMaxQubits || n_traj < 1 || segs_per_traj < 1 ||
      seg_len < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_IPB_CASE(NQ)                                                     \
  case NQ:                                                                  \
    return launch<NQ>(a_re, a_im, cum, t_stage, seg_dts, eval_t, eval_cum,  \
                      diags, psi0_re, psi0_im, out, n_traj, segs_per_traj,  \
                      seg_len, st);
  switch (n) {
    PT_IPB_CASE(10) PT_IPB_CASE(11) PT_IPB_CASE(12) PT_IPB_CASE(13)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_IPB_CASE
}

// The device kernels this library has launched so far
// (ip_sesolve_batched_run makes one): a caller counts the launches of one
// call as the difference, without a profiler.
extern "C" unsigned long long ip_sesolve_batched_device_launches() {
  return g_device_launches.load();
}
