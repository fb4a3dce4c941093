// Row-batched interaction-picture quantum-jump (MCWF) solve with diagonal
// collapse operators, for one ground-rydberg basis (d = 2).
//
// Replaces the TPU kernel `_mcwf_rows_kernel` of
// pulser_tpu/ops/pallas_kernels.py (called from `mcwf_rows_program`). The
// TPU kernel advances the whole trajectory batch through one sequential
// grid, the states resident in VMEM as (R, T, C) real/imaginary planes,
// trajectories on the sublane axis, qubit flips as slice swaps (rows) and
// permutation matmuls (columns).
//
// Each RK4 stage computes, in the interaction picture of the diagonal,
//   k = -i e^{+i Phi} sum_q M_q (e^{-i Phi} x)[flip_q] - 1/2 g x,
// with the rotor phase Phi(idx, t) below and the decay g(idx) =
// G00 #zeros + G11 #ones of G = sum_k L_k+ L_k. After each step, when
// |psi|^2 <= r, a jump: the weights of the channels (operator k outer,
// qubit q inner) from the 2n populations, one chosen searchsorted-left on
// u0 * total (`u <= cum`, and `u > prev` beyond the first), the state
// multiplied by the operator's diagonal entry and renormalised by
// 1/sqrt(max(w, 1e-30)), and r becomes the step's second uniform. Each
// segment end emits psi/|psi| rotated to the lab frame.
//
// What bounds it on an H100: a trajectory is a chain of hundreds of small
// dependent RK4 stages over 2^n amplitudes (about 9n + 32 f32 operations
// per amplitude and stage), so the latency of a stage and the block
// barrier between two stages bound it, not bytes: a stage reads 3n drive
// values, and the state is 8 KB per real plane at n = 10. On an NVIDIA
// H100 80GB HBM3 at 700 W a stage of NOISY10 (n = 10, 1024 threads per
// trajectory) takes about 1.16 us (chip_smoke.py), against 3.87 us for
// the previous design with ten shared-memory planes, two passes and 15
// barriers per step, and four sincosf per amplitude and step.
//
// What the design does about it: one thread block per trajectory (100
// trajectories fill 100 of the 132 SMs), the whole plan in ONE launch; the
// block loops over segments and steps itself and skips the zero-length
// padding steps. The kernel is templated on n, so the partner and
// amplitude loops unroll. Each thread owns fixed amplitudes (one up to
// n = 10, then 2/4/8 at n = 11/12/13, idx = tid + a * 1024); its psi, the
// RK4 accumulator, the stage input, its interaction diagonal, its decay
// factor and its current rotor (cos, sin) live in registers. Only the
// rotated stage input w = e^{-i Phi} x goes to shared memory,
// double-buffered (two complex planes, 16 * 2^n bytes: 128 KiB at n = 13),
// so that partners can read it; no state lives in device memory at any n.
// Flip partners below 32 come from the same warp by __shfl_xor_sync, the
// others from shared memory; the sign of a_im is picked by the amplitude's
// bit as a select, not by a branch. A stage is one pass ending in ONE
// block barrier, FOUR per jump-free RK4 step: gather the partners of w_j,
// rotate back, form k_j, accumulate, form the next stage input, rotate it
// and publish it to the other buffer. The last stage publishes the rotated
// new state (the next step's first stage input) and each warp's share of
// |psi|^2; after its barrier every thread sums the shares in a fixed warp
// order, so the jump test costs no barrier of its own and stays
// block-uniform.
//
// One rotor per distinct plan row: stages 1 and 2 read the same row, and
// the end-of-step rotor is carried into the next non-padding step
// whenever warp 0 finds that step's first row (the shared stage time and
// this trajectory's n phase integrals) equal to it bit for bit; otherwise
// the rotor is recomputed and the first stage input republished (one more
// barrier), so the kernel is right on any input. Where the rows agree a
// step costs two sincosf per amplitude. A carried rotor stays valid across
// a jump: it depends on time only. Warp 0 copies the next step's drive,
// phase integrals, stage times and step size into shared memory with
// cp.async while the current step runs, and finds the next non-padding
// step, so no stage waits on device memory. The two uniforms are read
// only in the rare jump branch, which reduces the 2n populations (per-warp
// partials, then over the warps in a fixed order), lets one thread select
// and costs three more barriers.
//
// Registers: 1024 threads cap a thread at 64 registers. From
// kLeanFromAmps amplitudes per thread on, the stage input is not kept but
// recovered from the thread's own w (x = e^{+i Phi} w) and the diagonal
// and the decay factor are re-read or recomputed where needed; from
// kSharedAccFromAmps on, the RK4 accumulator lives in a third complex
// plane of shared memory (64 KiB at n = 13, beside the 128 KiB of w).
// tools/block_sizes.py times the alternatives: on that card these
// thresholds and 1024 threads beat 512 threads and all-register variants
// at n = 10 to 13 (n = 13, which still spills 680 B: 18.6 ms against 39.5
// ms with everything in registers, 100 trajectories of 254 steps). Tensor
// cores, clusters and TMA are later work.
//
// Conventions, as in the TPU kernel: qubit q is bit n-1-q of the flat
// index (MSB first). The drive on qubit q enters with +a_im where the
// OUTPUT index has bit q set and -a_im where not. The phase is
//   Phi(i) = ((diag[i] * t) mod 2pi) + sum_q cum_q * (1 - bit_q(i)),
// summed in that order, with a floored mod (jnp.mod): fmodf truncates,
// so its sign is fixed up. sincosf (not __sincosf) holds full accuracy at
// phases of ~100 rad.

#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace {

using pt::cp_async4;
using pt::cp_async_wait_all;
using pt::first_real;
using pt::kFull;
using pt::step_window;

constexpr int kMaxQubits = 13;
constexpr int kMaxCops = 8;
constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = 1024;
// Amplitudes per thread from which the stage input, the diagonal and the
// decay factor leave the registers, and from which the RK4 accumulator
// moves to shared memory.
constexpr int kLeanFromAmps = 4;
constexpr int kSharedAccFromAmps = 8;
constexpr float kTwoPi = 6.283185307179586f;

// Device kernel launches this library has made (mcwf_rows_device_launches).
std::atomic<unsigned long long> g_device_launches{0};

__device__ __forceinline__ float floored_mod_2pi(float x) {
  float r = fmodf(x, kTwoPi);
  return (r != 0.0f && r < 0.0f) ? r + kTwoPi : r;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(kFull, v, off);
  return v;
}

// Sum of `v` over the block, in a fixed order; every thread gets it.
// `red` holds 33 floats. blockDim.x is a multiple of 32.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = warp_sum(lane < n_warps ? red[lane] : 0.0f);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <int N>
struct Shape {
  static constexpr int kDim = 1 << N;
  static constexpr int kThreads =
      kDim < 32 ? 32 : (kDim > kMaxThreads ? kMaxThreads : kDim);
  static constexpr int kAmps = kDim > kMaxThreads ? kDim / kMaxThreads : 1;
  static constexpr int kWarps = kThreads / 32;
  static constexpr bool kLean = kAmps >= kLeanFromAmps;
  static constexpr bool kSharedAcc = kAmps >= kSharedAccFromAmps;
  // Two planes of w, and the accumulator's where it lives there
  static constexpr int kSmemBytes =
      (kSharedAcc ? 3 : 2) * kDim * static_cast<int>(sizeof(float2));
};

// One RK4 step's three plan rows (t, t + h/2, t + h) of one trajectory and
// its bookkeeping.
template <int N>
struct Rows {
  float2 coef[3][N];  // (a_re, a_im)
  float cum[3][N];
  float t[3];
  float h;
  int carry;  // row 0 equals the previous step's row 2, bit for bit
  int step;   // index s * L + i in the plan, or S * L past the end
  int next;   // index of the next non-padding step
};

// Warp 0: starts copying step `f` of the trajectory whose drive rows begin
// at row `row0` into `r` (cp.async).
template <int N>
__device__ void fetch_rows(Rows<N>& r, long row0, int f, const float* a_re,
                           const float* a_im, const float* cum,
                           const float* t_stage, const float* seg_dts) {
  const int lane = threadIdx.x & 31;
  const long o = (row0 + f) * 3 * N;
  float* coef = reinterpret_cast<float*>(&r.coef[0][0]);
  for (int e = lane; e < 3 * N; e += 32) {
    cp_async4(coef + 2 * e, a_re + o + e);
    cp_async4(coef + 2 * e + 1, a_im + o + e);
    cp_async4(&r.cum[0][0] + e, cum + o + e);
  }
  if (lane < 3) cp_async4(&r.t[lane], t_stage + static_cast<long>(f) * 3 + lane);
  if (lane == 3) cp_async4(&r.h, seg_dts + f);
}

// Warp 0: waits for the copy into `r` and fills its bookkeeping. `prev`
// is the previous step's rows (for the carry test), or null.
template <int N>
__device__ void finish_rows(Rows<N>& r, const Rows<N>* prev, int f,
                            int next) {
  const int lane = threadIdx.x & 31;
  cp_async_wait_all();
  __syncwarp();
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
                                      const float* cum, float& c, float& s) {
  float ph = floored_mod_2pi(dg * t);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const bool bit = (idx >> (N - 1 - q)) & 1;
    ph = bit ? ph : ph + cum[q];
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
// input of stage j + 1 is psi + h a_{j+1} k_j.
__device__ __forceinline__ float rk_b(int j) {
  return j == 0 || j == 3 ? 1.0f / 6.0f : 1.0f / 3.0f;
}
__device__ __forceinline__ float rk_a_next(int j) {
  return j == 2 ? 1.0f : 0.5f;
}

// cops: (n_cops, 6) rows (l00_re, l00_im, l11_re, l11_im, |l00|^2, |l11|^2).
template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
mcwf_rows_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                 const float* __restrict__ cum, const float* __restrict__ t_stage,
                 const float* __restrict__ seg_dts, const float* __restrict__ us,
                 const float* __restrict__ eval_t,
                 const float* __restrict__ eval_cum,
                 const float* __restrict__ r0, const float* __restrict__ diags,
                 const float* __restrict__ psi0_re,
                 const float* __restrict__ psi0_im,
                 const float* __restrict__ cops, float* __restrict__ out,
                 int* __restrict__ jumps, int* __restrict__ carried, int S,
                 int L, int n_cops, float g00, float g11) {
  using Sh = Shape<N>;
  constexpr int D = Sh::kDim, T = Sh::kThreads, A = Sh::kAmps;
  constexpr int W = Sh::kWarps;
  constexpr bool kLean = Sh::kLean, kSharedAcc = Sh::kSharedAcc;
  extern __shared__ float2 s_w[];  // two planes of w (and the accumulator)
  __shared__ Rows<N> s_rows[2];
  __shared__ float s_cop[kMaxCops * 6];
  __shared__ float s_part[kMaxWarps * 2 * kMaxQubits];
  __shared__ float s_pop[2 * kMaxQubits];
  __shared__ float s_wgt[kMaxCops * kMaxQubits];
  __shared__ float s_norm[kMaxWarps];
  __shared__ float s_red[33];
  __shared__ float s_inv;
  __shared__ int s_sel;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Below 32 amplitudes the lanes past D repeat the first D (so every
  // warp shuffle stays inside a group of D lanes) and write nothing.
  const bool live = tid < D;
  const int base = tid & (D - 1);
  const int total = S * L;
  const long row0 = static_cast<long>(b) * total;
  const float* diag = diags + static_cast<long>(b) * D;
  float2* s_acc = s_w + 2 * D;

  // 1/2 g(idx), g = G00 #zeros + G11 #ones
  auto half_g = [&](int idx) {
    const float popf = static_cast<float>(__popc(idx));
    return 0.5f * (g00 * (static_cast<float>(N) - popf) + g11 * popf);
  };

  for (int i = tid; i < n_cops * 6; i += T) s_cop[i] = cops[i];
  float2 psi[A];
  float2 x[kLean ? 1 : A], acc[kSharedAcc ? 1 : A];
  float dg[kLean ? 1 : A], hg[kLean ? 1 : A];
  float c[A], s[A];
  // Amplitude a's diagonal and decay factor, from registers or anew
  auto diag_of = [&](int a, int idx) {
    if constexpr (Sh::kLean)
      return __ldg(diag + idx);
    else
      return dg[a];
  };
  auto half_of = [&](int a, int idx) {
    if constexpr (Sh::kLean)
      return half_g(idx);
    else
      return hg[a];
  };
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int idx = base + a * T;
    psi[a] = make_float2(psi0_re[idx], psi0_im[idx]);
    c[a] = 1.0f;
    s[a] = 0.0f;
    if constexpr (!kLean) {
      dg[a] = diag[idx];
      hg[a] = half_g(idx);
    }
  }
  if (warp == 0) {
    const int first =
        first_real(seg_dts, 0, total, step_window(seg_dts, 0, total));
    if (first < total) {
      fetch_rows(s_rows[0], row0, first, a_re, a_im, cum, t_stage, seg_dts);
      const int next = first_real(seg_dts, first + 1, total,
                                  step_window(seg_dts, first + 1, total));
      finish_rows(s_rows[0], static_cast<const Rows<N>*>(nullptr), first,
                  next);
    } else if (lane == 0) {
      s_rows[0].step = total;
    }
  }
  float r = r0[b];
  int n_jumps = 0, n_carried = 0, emitted = 0, p = 0;
  // Whether plane 0 holds the rotated psi under the rotor in (c, s)
  bool fresh = false;
  __syncthreads();

  for (;;) {
    const Rows<N>& rw = s_rows[p];
    const int f = rw.step;
    const int seg = f < total ? f / L : S;
    for (; emitted < seg; ++emitted) {
      // Emit the normalised lab-frame state: e^{-i Phi(t_eval)} psi / |psi|
      float part = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a)
        part += live ? psi[a].x * psi[a].x + psi[a].y * psi[a].y : 0.0f;
      const float inv_n =
          1.0f / sqrtf(fmaxf(block_sum(part, s_red), 1e-30f));
      const float te = __ldg(eval_t + emitted);
      const float* ec = eval_cum + (static_cast<long>(b) * S + emitted) * N;
      float* o = out + (static_cast<long>(b) * S + emitted) * 2 * D;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = base + a * T;
        float ce, se;
        rotor<N>(idx, diag_of(a, idx), te, ec, ce, se);
        const float2 lab =
            rotate(ce, se, make_float2(psi[a].x * inv_n, psi[a].y * inv_n));
        if (live) {
          o[idx] = lab.x;
          o[D + idx] = lab.y;
        }
      }
    }
    if (f >= total) break;
    const float h = rw.h;
    const int nxt = rw.next;
    Rows<N>& nr = s_rows[p ^ 1];
    float win = 0.0f;
    if (warp == 0 && nxt < total) {
      fetch_rows(nr, row0, nxt, a_re, a_im, cum, t_stage, seg_dts);
      win = step_window(seg_dts, nxt + 1, total);
    }
    // The rotor of row 0: carried from the previous step's row 2, or
    // recomputed; plane 0 then holds w_0 = e^{-i Phi} psi unless the rotor
    // is new or a jump has replaced psi (all block-uniform).
    const bool carry = rw.carry != 0;
    n_carried += carry ? 1 : 0;
    if (!carry || !fresh) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = base + a * T;
        if (!carry)
          rotor<N>(idx, diag_of(a, idx), rw.t[0], rw.cum[0], c[a], s[a]);
        if (live) s_w[idx] = rotate(c[a], s[a], psi[a]);
      }
      __syncthreads();
    }

    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Stage j reads plan row sidx, stage j + 1 row nrow
      const int sidx = (j + 1) >> 1, nrow = (j + 2) >> 1;
      // Stage j reads plane j & 1 and publishes the next input to the other
      const float2* win_j = s_w + (j & 1) * D;
      float2* wout = s_w + ((j + 1) & 1) * D;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = base + a * T;
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
        // The stage input x_j (x_0 = psi)
        float2 xj = psi[a];
        if (j > 0) {
          if constexpr (kLean)
            xj = make_float2(c[a] * w.x - s[a] * w.y, c[a] * w.y + s[a] * w.x);
          else
            xj = x[a];
        }
        // k_j = -i e^{+i Phi} y - 1/2 g x_j
        const float half = half_of(a, idx);
        const float kr = c[a] * yi + s[a] * yr - half * xj.x;
        const float ki = s[a] * yi - c[a] * yr - half * xj.y;
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
          if constexpr (kSharedAcc) {
            if (live) s_acc[idx] = sum;
          } else {
            acc[a] = sum;
          }
          const float ha = h * rk_a_next(j);
          const float2 xn =
              make_float2(psi[a].x + ha * kr, psi[a].y + ha * ki);
          if constexpr (!kLean) x[a] = xn;
          // Rows 1 (stages 1 and 2) and 2 (stage 3 and, carried, the
          // next step's stage 0) get their rotor here
          if (nrow != sidx)
            rotor<N>(idx, diag_of(a, idx), rw.t[nrow], rw.cum[nrow], c[a],
                     s[a]);
          if (live) wout[idx] = rotate(c[a], s[a], xn);
        } else {
          // psi <- psi + h acc; rotated, it is the next step's w_0
          psi[a] = make_float2(psi[a].x + h * sum.x, psi[a].y + h * sum.y);
          if (live) {
            part += psi[a].x * psi[a].x + psi[a].y * psi[a].y;
            wout[idx] = rotate(c[a], s[a], psi[a]);
          }
        }
      }
      if (j == 2 && warp == 0) {
        // The next step's rows, for the barrier that ends stage 3
        if (nxt < total) {
          const int after = first_real(seg_dts, nxt + 1, total, win);
          finish_rows(nr, &rw, nxt, after);
        } else if (lane == 0) {
          nr.step = total;
        }
      }
      if (j == 3) {
        // Each warp's share of |psi|^2. s_norm is read after this
        // barrier and written again only after three more.
        const float v = warp_sum(part);
        if (lane == 0) s_norm[warp] = v;
      }
      __syncthreads();
    }
    // The step's |psi|^2, summed over the warps in a fixed order
    float norm2 = warp_sum(lane < W ? s_norm[lane] : 0.0f);
    norm2 = __shfl_sync(kFull, norm2, 0);
    p ^= 1;
    fresh = true;
    if (norm2 > r) continue;  // no jump (uniform across the block)

    // A jump: the populations of |0> and |1> of every qubit, per-warp
    // partial sums first, then over the warps (both in a fixed order)
    const long ub = (row0 + f) * 2;
#pragma unroll 1
    for (int q = 0; q < N; ++q) {
      const int m = 1 << (N - 1 - q);
      float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = base + a * T;
        const float pa =
            live ? psi[a].x * psi[a].x + psi[a].y * psi[a].y : 0.0f;
        p0 += (idx & m) ? 0.0f : pa;
        p1 += (idx & m) ? pa : 0.0f;
      }
      p0 = warp_sum(p0);
      p1 = warp_sum(p1);
      if (lane == 0) {
        s_part[warp * 2 * kMaxQubits + 2 * q] = p0;
        s_part[warp * 2 * kMaxQubits + 2 * q + 1] = p1;
      }
    }
    __syncthreads();
    for (int e = warp; e < 2 * N; e += W) {
      const float v =
          warp_sum(lane < W ? s_part[lane * 2 * kMaxQubits + e] : 0.0f);
      if (lane == 0) s_pop[e] = v;
    }
    __syncthreads();
    if (tid == 0) {
      const int n_w = n_cops * N;
      for (int q = 0; q < N; ++q)
        for (int k = 0; k < n_cops; ++k)
          s_wgt[k * N + q] = s_cop[k * 6 + 4] * s_pop[2 * q] +
                             s_cop[k * 6 + 5] * s_pop[2 * q + 1];
      float total_w = s_wgt[0];
      for (int e = 1; e < n_w; ++e) total_w = total_w + s_wgt[e];
      const float u = us[ub] * total_w;
      float cum_w = 0.0f, w_sel = 0.0f;
      int sel = -1;
      for (int e = 0; e < n_w; ++e) {
        const float prev = cum_w;
        cum_w = cum_w + s_wgt[e];
        const bool hit = (u <= cum_w) && (e == 0 || u > prev);
        if (hit && sel < 0) {
          sel = e;
          w_sel = s_wgt[e];
        }
      }
      s_sel = sel;
      s_inv = 1.0f / sqrtf(fmaxf(w_sel, 1e-30f));
    }
    __syncthreads();
    const int sel = s_sel;
    const float inv = s_inv;
    const int m_sel = sel >= 0 ? 1 << (N - 1 - sel % N) : 0;
    const float* cop = s_cop + (sel >= 0 ? sel / N : 0) * 6;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int idx = base + a * T;
      float2 jumped = make_float2(0.0f, 0.0f);
      if (sel >= 0) {
        const bool one = idx & m_sel;
        const float cr = cop[one ? 2 : 0], ci = cop[one ? 3 : 1];
        jumped = make_float2((cr * psi[a].x - ci * psi[a].y) * inv,
                             (cr * psi[a].y + ci * psi[a].x) * inv);
      }
      psi[a] = jumped;
    }
    r = us[ub + 1];
    ++n_jumps;
    fresh = false;  // plane 0 holds the rotated state from before the jump
  }
  if (tid == 0) {
    jumps[b] = n_jumps;
    if (carried != nullptr) carried[b] = n_carried;
  }
}

template <int N>
cudaError_t launch(const float* a_re, const float* a_im, const float* cum,
                   const float* t_stage, const float* seg_dts, const float* us,
                   const float* eval_t, const float* eval_cum, const float* r0,
                   const float* diags, const float* psi0_re,
                   const float* psi0_im, const float* cops, float* out,
                   int* jumps, int* carried, int n_traj, int S, int L,
                   int n_cops, float g00, float g11, cudaStream_t st) {
  using Sh = Shape<N>;
  cudaError_t err = cudaFuncSetAttribute(
      mcwf_rows_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmemBytes);
  if (err != cudaSuccess) return err;
  mcwf_rows_kernel<N><<<n_traj, Sh::kThreads, Sh::kSmemBytes, st>>>(
      a_re, a_im, cum, t_stage, seg_dts, us, eval_t, eval_cum, r0, diags,
      psi0_re, psi0_im, cops, out, jumps, carried, S, L, n_cops, g00, g11);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_launches;
  return err;
}

}  // namespace

// Runs the whole solve on `stream`, one block per trajectory. Device
// inputs, in the layout of the TPU kernel's `mcwf_rows_program`: a_re,
// a_im, cum (B, S, L, 3, n); t_stage (S, L, 3); seg_dts (S, L); us
// (B, S, L, 2); eval_t (S); eval_cum (B, S, n); r0 (B); diags (B, 2^n);
// psi0_re, psi0_im (2^n); cops (n_cops, 6). Outputs: out (B, S, 2, 2^n)
// normalised lab-frame states after each segment, jumps (B) int32 jump
// counts, and carried (B, may be null) the int32 number of steps of each
// trajectory that took their first rotor from the step before. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int mcwf_rows_run(const float* a_re, const float* a_im,
                             const float* cum, const float* t_stage,
                             const float* seg_dts, const float* us,
                             const float* eval_t, const float* eval_cum,
                             const float* r0, const float* diags,
                             const float* psi0_re, const float* psi0_im,
                             const float* cops, float* out, int* jumps,
                             int* carried, int n_traj, int S, int L, int n,
                             int n_cops, float g00, float g11, void* stream) {
  if (n < 1 || n > kMaxQubits || n_cops < 1 || n_cops > kMaxCops ||
      n_traj < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_ROWS_CASE(NQ)                                                     \
  case NQ:                                                                   \
    return launch<NQ>(a_re, a_im, cum, t_stage, seg_dts, us, eval_t,         \
                      eval_cum, r0, diags, psi0_re, psi0_im, cops, out,      \
                      jumps, carried, n_traj, S, L, n_cops, g00, g11, st);
  switch (n) {
    PT_ROWS_CASE(1) PT_ROWS_CASE(2) PT_ROWS_CASE(3) PT_ROWS_CASE(4)
    PT_ROWS_CASE(5) PT_ROWS_CASE(6) PT_ROWS_CASE(7) PT_ROWS_CASE(8)
    PT_ROWS_CASE(9) PT_ROWS_CASE(10) PT_ROWS_CASE(11) PT_ROWS_CASE(12)
    PT_ROWS_CASE(13)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_ROWS_CASE
}

// The device kernels this library has launched so far (mcwf_rows_run makes
// one): a caller counts the launches of one call as the difference,
// without a profiler.
extern "C" unsigned long long mcwf_rows_device_launches() {
  return g_device_launches.load();
}
