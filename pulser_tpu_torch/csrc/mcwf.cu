// Lab-frame quantum-jump (MCWF) solve with general 2x2 collapse operators,
// for one ground-rydberg basis (d = 2).
//
// Replaces the TPU kernel `_mcwf_kernel` of pulser_tpu/ops/pallas_kernels.py
// (called from `_mcwf_jit`, entry `mcwf_pallas`). The TPU kernel runs one
// trajectory after another on its sequential grid, one grid step per chunk
// of at most 512 RK4 steps, the state resident in VMEM as (R, C)
// real/imaginary planes, qubit flips as permutation matmuls on both axes.
//
// Each RK4 stage computes k = -i H_eff x with the non-Hermitian
// H_eff = H - (i/2) sum_{k,q} L_k^(q)+ L_k^(q):
// - a real diagonal diag - sum_q det_q + sum_q det_q bit_q (the detuning
//   projector sits on local state 0, "r first");
// - a constant imaginary diagonal -1/2 (G00 #zeros + G11 #ones);
// - per qubit a non-Hermitian flip: the |1><0| entry carries
//   a_q - (i/2) G[1,0], the |0><1| entry conj(a_q) - (i/2) conj(G[1,0]).
// After each step, when |psi|^2 <= r, a jump: all K*n candidates
// L_k^(q) psi (operator k outer, qubit q inner), one chosen by running
// comparisons against u_sel * total (`u > prev && u <= cum`, the last
// candidate also taking u <= 0), normalised by 1/sqrt(max(w, 1e-30)), and
// r becomes the step's second uniform. Each segment end emits psi/|psi|.
//
// What bounds it on an H100: a trajectory is a chain of thousands of small
// dependent RK4 stages over 2^n amplitudes (about 9n + 21 f32 operations
// per amplitude and stage), so the latency of a stage and the block
// barrier between two stages bound it, not bytes: a stage reads 3n drive
// values, and the state is 8 KB per real plane at n = 10. On an NVIDIA
// H100 80GB HBM3 at 700 W a stage of PAULI10 (n = 10, 1024 threads per
// trajectory) takes about 1.08 us (chip_smoke.py), against 2.93 us for
// the previous design with 20 shared-memory gathers, a divergent branch
// and seven barriers per step.
//
// What the design does about it: one thread block per trajectory (100
// trajectories fill 100 of the 132 SMs), the whole plan in ONE launch; the
// block loops over segments and steps itself and skips the zero-length
// padding steps. The kernel is templated on n, so the partner and
// amplitude loops unroll. Each thread owns fixed amplitudes (one up to
// n = 10, then 2/4/8 at n = 11/12/13, idx = tid + a * 1024); its psi, the
// RK4 accumulator, k and its diagonal live in registers. Only the stage
// input goes to shared memory, double-buffered (two complex planes,
// 16 * 2^n bytes: 128 KiB at n = 13), so that partners can read it. Flip
// partners below 32 come from the same warp by __shfl_xor_sync, the
// others from shared memory; the flip entry is picked by the amplitude's
// bit as an address offset, not by a branch. A stage is one pass ending in
// ONE block barrier, four per RK4 step: the last stage also writes each
// warp's share of |psi|^2, and after its barrier every thread sums the
// shares in a fixed warp order, so the jump test costs no further
// barrier and stays block-uniform. Warp 0 copies the next step's drive,
// detuning and step size into shared memory with cp.async while the
// current step runs, and finds the next non-padding step, so no step
// waits on device memory. Only in the rare jump branch does the block
// reduce the K*n candidate weights (per-warp partials, summed in a fixed
// order) and one thread select, as the previous design did. Tensor cores,
// clusters and TMA are later work.

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
constexpr int kMaxCands = kMaxCops * kMaxQubits;
constexpr int kMaxWarps = 32;
constexpr int kMaxThreads = 1024;

// Device kernel launches this library has made (mcwf_device_launches).
std::atomic<unsigned long long> g_device_launches{0};

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
};

// One step's samples, ready for the stages: per row (t, t + h/2, t + h)
// and qubit the flip entries (|0><1| then |1><0|, G folded in) and the
// detuning, the detunings' sum in qubit order, and the step's bookkeeping.
template <int N>
struct Step {
  float4 coef[3][N];  // (up_re, up_im, lo_re, lo_im)
  float det[3][N];
  float det_sum[3];
  float h;
  int step;  // index s * L + i in the trajectory, or S * L past the end
  int next;  // index of the next non-padding step
};

// The raw copy of one step's inputs: a_re, a_im, det rows, then h.
template <int N>
struct Raw {
  float v[9 * N + 1];
};

// Warp 0: starts copying step `f` of the trajectory whose rows begin at
// `row0` into `raw`.
template <int N>
__device__ void issue_step(Raw<N>& raw, long row0, int f, const float* a_re,
                           const float* a_im, const float* det,
                           const float* seg_dts) {
  const int lane = threadIdx.x & 31;
  const long o = (row0 + f) * 3 * N;
  for (int e = lane; e < 3 * N; e += 32) {
    cp_async4(raw.v + e, a_re + o + e);
    cp_async4(raw.v + 3 * N + e, a_im + o + e);
    cp_async4(raw.v + 6 * N + e, det + o + e);
  }
  if (lane == 0) cp_async4(raw.v + 9 * N, seg_dts + row0 + f);
}

// Warp 0: waits for `raw` and forms step `f`'s samples in `st`.
template <int N>
__device__ void finish_step(Step<N>& st, const Raw<N>& raw, int f, int next,
                            float klo_re, float klo_im, float kup_re,
                            float kup_im) {
  const int lane = threadIdx.x & 31;
  cp_async_wait_all();
  __syncwarp();
  for (int e = lane; e < 3 * N; e += 32) {
    const float ar = raw.v[e], ai = raw.v[3 * N + e];
    st.coef[e / N][e % N] =
        make_float4(ar + kup_re, -ai + kup_im, ar + klo_re, ai + klo_im);
    st.det[e / N][e % N] = raw.v[6 * N + e];
  }
  __syncwarp();
  if (lane < 3) {
    float s = 0.0f;
    for (int q = 0; q < N; ++q) s += st.det[lane][q];
    st.det_sum[lane] = s;
  }
  if (lane == 0) {
    st.h = raw.v[9 * N];
    st.step = f;
    st.next = next;
  }
}

// The flip partner idx ^ m of amplitude `idx` in plane `x`; `own` is the
// amplitude's own value there. Flips below 32 come from the lane idx ^ m
// of the same warp, so every lane must call this with the same m.
__device__ __forceinline__ float2 partner(const float2* x, int idx, int m,
                                         float2 own) {
  if (m < 32)
    return make_float2(__shfl_xor_sync(kFull, own.x, m),
                       __shfl_xor_sync(kFull, own.y, m));
  return x[idx ^ m];
}

// RK4 weights: stage j adds b_j k_j to the accumulator, and the stage
// input of stage j + 1 is psi + h a_{j+1} k_j.
__device__ __forceinline__ float rk_b(int j) {
  return j == 0 || j == 3 ? 1.0f / 6.0f : 1.0f / 3.0f;
}
__device__ __forceinline__ float rk_a_next(int j) {
  return j == 2 ? 1.0f : 0.5f;
}

// cops: (n_cops, 8) rows (l00r, l00i, l01r, l01i, l10r, l10i, l11r, l11i).
template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
mcwf_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
            const float* __restrict__ det, const float* __restrict__ seg_dts,
            const float* __restrict__ us, const float* __restrict__ r0,
            const float* __restrict__ diags,
            const float* __restrict__ psi0_re,
            const float* __restrict__ psi0_im,
            const float* __restrict__ cops, float* __restrict__ out,
            int* __restrict__ jumps, int S, int L, int n_cops, float g00,
            float g11, float g_lo_re, float g_lo_im) {
  using Sh = Shape<N>;
  constexpr int D = Sh::kDim, T = Sh::kThreads, A = Sh::kAmps;
  constexpr int W = Sh::kWarps;
  extern __shared__ float2 s_x[];  // two stage-input planes of D
  __shared__ Step<N> s_step[2];
  __shared__ Raw<N> s_raw;
  __shared__ float s_cop[kMaxCops * 8];
  __shared__ float s_part[kMaxWarps * kMaxCands];
  __shared__ float s_w[kMaxCands];
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
  const int n_cand = n_cops * N;
  const int total = S * L;
  const long row0 = static_cast<long>(b) * total;
  const float* dts = seg_dts + row0;
  // -(i/2) G[1,0] on the |1><0| entries, -(i/2) conj(G[1,0]) on |0><1|
  const float klo_re = 0.5f * g_lo_im, klo_im = -0.5f * g_lo_re;
  const float kup_re = -0.5f * g_lo_im, kup_im = -0.5f * g_lo_re;

  for (int i = tid; i < n_cops * 8; i += T) s_cop[i] = cops[i];
  float2 psi[A], acc[A];
  float dg[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int idx = base + a * T;
    psi[a] = make_float2(psi0_re[idx], psi0_im[idx]);
    dg[a] = diags[static_cast<long>(b) * D + idx];
    if (live) s_x[idx] = psi[a];
  }
  if (warp == 0) {
    const int first = first_real(dts, 0, total, step_window(dts, 0, total));
    if (first < total) {
      issue_step(s_raw, row0, first, a_re, a_im, det, seg_dts);
      const int next =
          first_real(dts, first + 1, total, step_window(dts, first + 1, total));
      finish_step(s_step[0], s_raw, first, next, klo_re, klo_im, kup_re,
                  kup_im);
    } else if (lane == 0) {
      s_step[0].step = total;
    }
  }
  float r = r0[b];
  int n_jumps = 0, emitted = 0, p = 0;
  __syncthreads();

  for (;;) {
    const Step<N>& st = s_step[p];
    const int f = st.step;
    const int seg = f < total ? f / L : S;
    for (; emitted < seg; ++emitted) {
      // Emit the normalised state
      float part = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a)
        part += live ? psi[a].x * psi[a].x + psi[a].y * psi[a].y : 0.0f;
      const float inv_n =
          1.0f / sqrtf(fmaxf(block_sum(part, s_red), 1e-30f));
      float* o = out + (row0 / L + emitted) * 2 * D;
      if (live) {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const int idx = base + a * T;
          o[idx] = psi[a].x * inv_n;
          o[D + idx] = psi[a].y * inv_n;
        }
      }
    }
    if (f >= total) break;
    const float h = st.h;
    const int nxt = st.next;
    float win = 0.0f;
    if (warp == 0 && nxt < total) {
      issue_step(s_raw, row0, nxt, a_re, a_im, det, seg_dts);
      win = step_window(dts, nxt + 1, total);
    }

    float part = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sidx = (j + 1) >> 1;
      // Stage j reads plane j & 1 and writes the next input to the other
      const float2* xin = s_x + (j & 1) * D;
      float2* xout = s_x + ((j + 1) & 1) * D;
      const float det_sum = st.det_sum[sidx];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = base + a * T;
        const float2 x = j == 0 ? psi[a] : xin[idx];
        float dr = dg[a] - det_sum;
        float yr = 0.0f, yi = 0.0f;
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const int m = 1 << (N - 1 - q);
          const float2 fp = partner(xin, idx, m, x);
          const int bit = (idx & m) ? 1 : 0;
          const float2 c =
              reinterpret_cast<const float2*>(&st.coef[sidx][q])[bit];
          dr = bit ? dr + st.det[sidx][q] : dr;
          yr = yr + c.x * fp.x - c.y * fp.y;
          yi = yi + c.y * fp.x + c.x * fp.y;
        }
        const float popf = static_cast<float>(__popc(idx));
        const float d_im =
            -0.5f * (g00 * (static_cast<float>(N) - popf) + g11 * popf);
        // k = -i H_eff x
        const float kr = dr * x.y + d_im * x.x + yi;
        const float ki = -(dr * x.x - d_im * x.y + yr);
        if (j == 0) {
          acc[a] = make_float2(rk_b(0) * kr, rk_b(0) * ki);
        } else {
          acc[a].x = acc[a].x + rk_b(j) * kr;
          acc[a].y = acc[a].y + rk_b(j) * ki;
        }
        if (j < 3) {
          const float ha = h * rk_a_next(j);
          if (live)
            xout[idx] = make_float2(psi[a].x + ha * kr, psi[a].y + ha * ki);
        } else {
          // psi <- psi + h acc; it is also the next step's stage input
          psi[a] = make_float2(psi[a].x + h * acc[a].x,
                               psi[a].y + h * acc[a].y);
          if (live) {
            xout[idx] = psi[a];
            part += psi[a].x * psi[a].x + psi[a].y * psi[a].y;
          }
        }
      }
      if (j == 2 && warp == 0) {
        // The next step's samples, for the barrier that ends stage 3
        if (nxt < total) {
          const int after = first_real(dts, nxt + 1, total, win);
          finish_step(s_step[p ^ 1], s_raw, nxt, after, klo_re, klo_im,
                      kup_re, kup_im);
        } else if (lane == 0) {
          s_step[p ^ 1].step = total;
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
    if (norm2 > r) continue;  // no jump (uniform across the block)

    // A jump: the weight of every candidate L_k^(q) psi, per-warp
    // partial sums first (fixed order), then over the warps. psi is in
    // plane 0 (the next stage input) and in the registers.
    const long ub = (row0 + f) * 2;
#pragma unroll 1
    for (int q = 0; q < N; ++q) {
      const int m = 1 << (N - 1 - q);
      float wk[kMaxCops];
#pragma unroll
      for (int k = 0; k < kMaxCops; ++k) wk[k] = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int idx = base + a * T;
        const float2 fp = partner(s_x, idx, m, psi[a]);
        const int one = (idx & m) ? 1 : 0;
#pragma unroll
        for (int k = 0; k < kMaxCops; ++k) {
          if (k < n_cops && live) {
            const float* c = s_cop + k * 8;
            const float kre = c[one ? 6 : 0], kim = c[one ? 7 : 1];
            const float cre = c[one ? 4 : 2], cim = c[one ? 5 : 3];
            const float vr =
                kre * psi[a].x - kim * psi[a].y + cre * fp.x - cim * fp.y;
            const float vi =
                kre * psi[a].y + kim * psi[a].x + cre * fp.y + cim * fp.x;
            wk[k] += vr * vr + vi * vi;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kMaxCops; ++k) {
        if (k < n_cops) {
          const float v = warp_sum(wk[k]);
          if (lane == 0) s_part[warp * kMaxCands + k * N + q] = v;
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < n_cand; x += T) {
      float w = 0.0f;
      for (int wp = 0; wp < W; ++wp) w += s_part[wp * kMaxCands + x];
      s_w[x] = w;
    }
    __syncthreads();
    if (tid == 0) {
      float total_w = s_w[0];
      for (int x = 1; x < n_cand; ++x) total_w = total_w + s_w[x];
      const float u = us[ub] * total_w;
      float cum = 0.0f, w_sel = 0.0f;
      int sel = -1;
      for (int x = 0; x < n_cand; ++x) {
        const float prev = cum;
        cum = cum + s_w[x];
        bool hit = u > prev && u <= cum;
        if (x == n_cand - 1) hit = hit || u <= 0.0f;
        if (hit && sel < 0) {
          sel = x;
          w_sel = s_w[x];
        }
      }
      s_sel = sel;
      s_inv = 1.0f / sqrtf(fmaxf(w_sel, 1e-30f));
    }
    __syncthreads();
    // The chosen candidate, from psi and its flip partners in plane 0
    const int sel = s_sel;
    const float inv = s_inv;
    const int m_sel = sel >= 0 ? 1 << (N - 1 - sel % N) : 0;
    const float* c = s_cop + (sel >= 0 ? sel / N : 0) * 8;
    float2 nw[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int idx = base + a * T;
      // m_sel is block-uniform: every lane takes the same branch
      float2 fp;
      if (m_sel > 0 && m_sel < 32) {
        fp = make_float2(__shfl_xor_sync(kFull, psi[a].x, m_sel),
                         __shfl_xor_sync(kFull, psi[a].y, m_sel));
      } else {
        fp = s_x[idx ^ m_sel];
      }
      float vr = 0.0f, vi = 0.0f;
      if (sel >= 0) {
        const int one = (idx & m_sel) ? 1 : 0;
        const float kre = c[one ? 6 : 0], kim = c[one ? 7 : 1];
        const float cre = c[one ? 4 : 2], cim = c[one ? 5 : 3];
        vr = (kre * psi[a].x - kim * psi[a].y + cre * fp.x - cim * fp.y) *
             inv;
        vi = (kre * psi[a].y + kim * psi[a].x + cre * fp.y + cim * fp.x) *
             inv;
      }
      nw[a] = make_float2(vr, vi);
    }
    __syncthreads();  // every partner of plane 0 has been read
#pragma unroll
    for (int a = 0; a < A; ++a) {
      psi[a] = nw[a];
      if (live) s_x[base + a * T] = psi[a];
    }
    r = us[ub + 1];
    ++n_jumps;
    __syncthreads();
  }
  if (tid == 0) jumps[b] = n_jumps;
}

template <int N>
cudaError_t launch(const float* a_re, const float* a_im, const float* det,
                   const float* seg_dts, const float* us, const float* r0,
                   const float* diags, const float* psi0_re,
                   const float* psi0_im, const float* cops, float* out,
                   int* jumps, int n_traj, int S, int L, int n_cops, float g00,
                   float g11, float g_lo_re, float g_lo_im,
                   cudaStream_t st) {
  using Sh = Shape<N>;
  const int smem = 2 * Sh::kDim * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      mcwf_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mcwf_kernel<N><<<n_traj, Sh::kThreads, smem, st>>>(
      a_re, a_im, det, seg_dts, us, r0, diags, psi0_re, psi0_im, cops, out,
      jumps, S, L, n_cops, g00, g11, g_lo_re, g_lo_im);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_launches;
  return err;
}

}  // namespace

// Runs the whole solve on `stream`, one block per trajectory. Device
// inputs, in the layout of the TPU kernel's `_mcwf_jit` (B trajectories
// of S segments, L steps each): a_re, a_im, det (B*S, L, 3, n); seg_dts
// (B*S, L); us (B*S, L, 2); r0 (B); diags (B, 2^n); psi0_re, psi0_im
// (2^n); cops (n_cops, 8). Outputs: out (B*S, 2, 2^n) normalised states
// after each segment, jumps (B) int32 jump counts. g00, g11 are the
// diagonal of G = sum_k L_k+ L_k and (g_lo_re, g_lo_im) its [1, 0] entry.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mcwf_run(const float* a_re, const float* a_im, const float* det,
                        const float* seg_dts, const float* us, const float* r0,
                        const float* diags, const float* psi0_re,
                        const float* psi0_im, const float* cops, float* out,
                        int* jumps, int n_traj, int S, int L, int n,
                        int n_cops, float g00, float g11, float g_lo_re,
                        float g_lo_im, void* stream) {
  if (n < 1 || n > kMaxQubits || n_cops < 1 || n_cops > kMaxCops ||
      n_traj < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_MCWF_CASE(NQ)                                                    \
  case NQ:                                                                  \
    return launch<NQ>(a_re, a_im, det, seg_dts, us, r0, diags, psi0_re,     \
                      psi0_im, cops, out, jumps, n_traj, S, L, n_cops, g00, \
                      g11, g_lo_re, g_lo_im, st);
  switch (n) {
    PT_MCWF_CASE(1) PT_MCWF_CASE(2) PT_MCWF_CASE(3) PT_MCWF_CASE(4)
    PT_MCWF_CASE(5) PT_MCWF_CASE(6) PT_MCWF_CASE(7) PT_MCWF_CASE(8)
    PT_MCWF_CASE(9) PT_MCWF_CASE(10) PT_MCWF_CASE(11) PT_MCWF_CASE(12)
    PT_MCWF_CASE(13)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_MCWF_CASE
}

// The device kernels this library has launched so far (mcwf_run makes
// one): a caller counts the launches of one call as the difference,
// without a profiler.
extern "C" unsigned long long mcwf_device_launches() {
  return g_device_launches.load();
}
