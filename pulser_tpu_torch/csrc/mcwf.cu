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
// dependent RK4 stages over 2^n amplitudes (about 9n + 20 f32 operations
// per amplitude and stage), so latency and synchronisation bound it, not
// bytes: the inputs a stage reads are 3n drive values, and the state is
// 8 KB per real plane at n = 10.
//
// What the design does about it: one thread block per trajectory (100
// trajectories fill 100 of the 132 SMs), the whole plan in ONE launch; the
// block loops over segments and steps itself and skips the zero-length
// padding steps. The state, two stage-input buffers and the RK4
// accumulator are eight f32 planes (32 * 2^n bytes) in shared memory up to
// n = 12 and in a per-trajectory slice of device memory at n = 13. Each
// thread owns its amplitudes; a stage is ONE pass: it gathers the n flip
// partners x[i ^ (1 << (n-1-q))] of the stage input, applies H_eff, adds
// to the accumulator and writes the next stage's input into the other
// buffer, so one barrier separates two stages. The lab frame needs no
// rotor (no sincosf), unlike the interaction-picture kernels. The step's
// 3 x n drive and detuning samples are staged once per step in shared
// memory, with G's off-diagonal folded in. The jump test is a block
// reduction that every thread reads, so the branch is block-uniform; only
// in the rare jump branch does the block reduce the K*n candidate weights
// (per-warp partials, summed in a fixed order) and one thread selects.
// Tensor cores, clusters and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQubits = 13;
constexpr int kMaxCops = 8;
constexpr int kMaxCands = kMaxCops * kMaxQubits;
constexpr int kMaxWarps = 32;
constexpr int kPlanes = 8;

// Plane order inside a trajectory's scratch (each `dim` floats): the
// state, the two stage-input buffers, the RK4 accumulator.
enum Plane { kPsiRe, kPsiIm, kX0Re, kX0Im, kX1Re, kX1Im, kAccRe, kAccIm };

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
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

// cops: (n_cops, 8) rows (l00r, l00i, l01r, l01i, l10r, l10i, l11r, l11i).
__global__ void __launch_bounds__(1024)
mcwf_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
            const float* __restrict__ det, const float* __restrict__ seg_dts,
            const float* __restrict__ us, const float* __restrict__ r0,
            const float* __restrict__ diags,
            const float* __restrict__ psi0_re,
            const float* __restrict__ psi0_im,
            const float* __restrict__ cops, float* __restrict__ out,
            int* __restrict__ jumps, float* __restrict__ scratch, int S,
            int L, int n, int n_cops, float g00, float g11, float g_lo_re,
            float g_lo_im) {
  extern __shared__ float smem[];
  // The step's three stage samples: flip entries (G folded in) and
  // detunings, per qubit
  __shared__ float s_lo_re[3][kMaxQubits], s_lo_im[3][kMaxQubits];
  __shared__ float s_up_re[3][kMaxQubits], s_up_im[3][kMaxQubits];
  __shared__ float s_det[3][kMaxQubits];
  __shared__ float s_cop[kMaxCops * 8];
  __shared__ float s_part[kMaxWarps * kMaxCands];
  __shared__ float s_w[kMaxCands];
  __shared__ float s_red[33];
  __shared__ float s_inv;
  __shared__ int s_sel;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int dim = 1 << n;
  const int n_cand = n_cops * n;
  float* pl = scratch ? scratch + static_cast<long>(b) * kPlanes * dim : smem;
  float* psi_re = pl + kPsiRe * dim;
  float* psi_im = pl + kPsiIm * dim;
  float* x_re[2] = {pl + kX0Re * dim, pl + kX1Re * dim};
  float* x_im[2] = {pl + kX0Im * dim, pl + kX1Im * dim};
  float* acc_re = pl + kAccRe * dim;
  float* acc_im = pl + kAccIm * dim;
  const float* diag = diags + static_cast<long>(b) * dim;
  // -(i/2) G[1,0] on the |1><0| entries, -(i/2) conj(G[1,0]) on |0><1|
  const float klo_re = 0.5f * g_lo_im, klo_im = -0.5f * g_lo_re;
  const float kup_re = -0.5f * g_lo_im, kup_im = -0.5f * g_lo_re;

  for (int i = tid; i < n_cops * 8; i += nt) s_cop[i] = cops[i];
  for (int i = tid; i < dim; i += nt) {
    psi_re[i] = x_re[0][i] = psi0_re[i];
    psi_im[i] = x_im[0][i] = psi0_im[i];
  }
  float r = r0[b];
  int n_jumps = 0;
  const float a_w[4] = {0.0f, 0.5f, 0.5f, 1.0f};
  const float b_w[4] = {1.0f / 6.0f, 1.0f / 3.0f, 1.0f / 3.0f, 1.0f / 6.0f};
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    const long seg = static_cast<long>(b) * S + s;
    for (int st = 0; st < L; ++st) {
      const float h = seg_dts[seg * L + st];
      if (h == 0.0f) continue;  // start padding of a short segment
      // Stage the step's samples. The previous readers of s_* passed the
      // barriers of the last norm reduction.
      if (tid < 3 * n) {
        const int j = tid / n, q = tid % n;
        const long idx = ((seg * L + st) * 3 + j) * n + q;
        const float ar = a_re[idx], ai = a_im[idx];
        s_lo_re[j][q] = ar + klo_re;
        s_lo_im[j][q] = ai + klo_im;
        s_up_re[j][q] = ar + kup_re;
        s_up_im[j][q] = -ai + kup_im;
        s_det[j][q] = det[idx];
      }
      __syncthreads();
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sidx = (j + 1) >> 1;
        // Stage j reads buffer j & 1 and writes the next input to the other
        const float* xin_re = x_re[j & 1];
        const float* xin_im = x_im[j & 1];
        float* xout_re = x_re[(j + 1) & 1];
        float* xout_im = x_im[(j + 1) & 1];
        float det_sum = 0.0f;
        for (int q = 0; q < n; ++q) det_sum += s_det[sidx][q];
        for (int i = tid; i < dim; i += nt) {
          const float xr = xin_re[i], xi = xin_im[i];
          float dr = diag[i] - det_sum;
          float yr = 0.0f, yi = 0.0f;
          int pop = 0;
          for (int q = 0; q < n; ++q) {
            const int m = 1 << (n - 1 - q);
            const float fr = xin_re[i ^ m], fi = xin_im[i ^ m];
            float cr, ci;
            if (i & m) {
              cr = s_lo_re[sidx][q];
              ci = s_lo_im[sidx][q];
              dr += s_det[sidx][q];
              ++pop;
            } else {
              cr = s_up_re[sidx][q];
              ci = s_up_im[sidx][q];
            }
            yr = yr + cr * fr - ci * fi;
            yi = yi + ci * fr + cr * fi;
          }
          const float popf = static_cast<float>(pop);
          const float d_im =
              -0.5f * (g00 * (static_cast<float>(n) - popf) + g11 * popf);
          // k = -i H_eff x
          const float kr = dr * xi + d_im * xr + yi;
          const float ki = -(dr * xr - d_im * xi + yr);
          float ar, ai;
          if (j == 0) {
            ar = b_w[j] * kr;
            ai = b_w[j] * ki;
          } else {
            ar = acc_re[i] + b_w[j] * kr;
            ai = acc_im[i] + b_w[j] * ki;
          }
          if (j < 3) {
            acc_re[i] = ar;
            acc_im[i] = ai;
            const float ha = h * a_w[j + 1];
            xout_re[i] = psi_re[i] + ha * kr;
            xout_im[i] = psi_im[i] + ha * ki;
          } else {
            // psi <- psi + h acc; it is also the next step's stage input
            const float pr = psi_re[i] + h * ar;
            const float pi = psi_im[i] + h * ai;
            psi_re[i] = xout_re[i] = pr;
            psi_im[i] = xout_im[i] = pi;
            part += pr * pr + pi * pi;
          }
        }
        if (j < 3) __syncthreads();
      }
      const float norm2 = block_sum(part, s_red);
      if (norm2 > r) continue;  // no jump (uniform across the block)

      // A jump: the weight of every candidate L_k^(q) psi, per-warp
      // partial sums first (fixed order), then over the warps
      for (int q = 0; q < n; ++q) {
        const int m = 1 << (n - 1 - q);
        float wk[kMaxCops];
#pragma unroll
        for (int k = 0; k < kMaxCops; ++k) wk[k] = 0.0f;
        for (int i = tid; i < dim; i += nt) {
          const float pr = psi_re[i], pi = psi_im[i];
          const float fr = psi_re[i ^ m], fi = psi_im[i ^ m];
          const int one = (i & m) ? 1 : 0;
#pragma unroll
          for (int k = 0; k < kMaxCops; ++k) {
            if (k < n_cops) {
              const float* c = s_cop + k * 8;
              const float kre = c[one ? 6 : 0], kim = c[one ? 7 : 1];
              const float cre = c[one ? 4 : 2], cim = c[one ? 5 : 3];
              const float vr = kre * pr - kim * pi + cre * fr - cim * fi;
              const float vi = kre * pi + kim * pr + cre * fi + cim * fr;
              wk[k] += vr * vr + vi * vi;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxCops; ++k) {
          if (k < n_cops) {
            const float v = warp_sum(wk[k]);
            if (lane == 0) s_part[warp * kMaxCands + k * n + q] = v;
          }
        }
      }
      __syncthreads();
      for (int x = tid; x < n_cand; x += nt) {
        float w = 0.0f;
        for (int wp = 0; wp < n_warps; ++wp) w += s_part[wp * kMaxCands + x];
        s_w[x] = w;
      }
      __syncthreads();
      if (tid == 0) {
        const long ub = (seg * L + st) * 2;
        float total = s_w[0];
        for (int x = 1; x < n_cand; ++x) total = total + s_w[x];
        const float u = us[ub] * total;
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
      // The chosen candidate goes to the stage-input buffer first (its
      // flip partners are still read from psi), then to psi
      const int sel = s_sel;
      const float inv = s_inv;
      for (int i = tid; i < dim; i += nt) {
        float vr = 0.0f, vi = 0.0f;
        if (sel >= 0) {
          const int m = 1 << (n - 1 - sel % n);
          const int one = (i & m) ? 1 : 0;
          const float* c = s_cop + (sel / n) * 8;
          const float kre = c[one ? 6 : 0], kim = c[one ? 7 : 1];
          const float cre = c[one ? 4 : 2], cim = c[one ? 5 : 3];
          const float pr = psi_re[i], pi = psi_im[i];
          const float fr = psi_re[i ^ m], fi = psi_im[i ^ m];
          vr = (kre * pr - kim * pi + cre * fr - cim * fi) * inv;
          vi = (kre * pi + kim * pr + cre * fi + cim * fr) * inv;
        }
        x_re[0][i] = vr;
        x_im[0][i] = vi;
      }
      __syncthreads();
      for (int i = tid; i < dim; i += nt) {
        psi_re[i] = x_re[0][i];
        psi_im[i] = x_im[0][i];
      }
      r = us[(seg * L + st) * 2 + 1];
      ++n_jumps;
    }
    // Emit the normalised state
    float part = 0.0f;
    for (int i = tid; i < dim; i += nt)
      part += psi_re[i] * psi_re[i] + psi_im[i] * psi_im[i];
    const float inv_n = 1.0f / sqrtf(fmaxf(block_sum(part, s_red), 1e-30f));
    float* o = out + seg * 2 * dim;
    for (int i = tid; i < dim; i += nt) {
      o[i] = psi_re[i] * inv_n;
      o[dim + i] = psi_im[i] * inv_n;
    }
  }
  if (tid == 0) jumps[b] = n_jumps;
}

int threads_for(int dim) {
  int t = dim < 32 ? 32 : dim;
  return t > 1024 ? 1024 : t;
}

// Shared-memory bytes the state planes take, or 0 when they do not fit
// beside the kernel's static shared memory on the current device.
long planes_smem_bytes(int n) {
  const long bytes = static_cast<long>(kPlanes) * (1L << n) * sizeof(float);
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, mcwf_kernel) != cudaSuccess) return 0;
  return bytes + static_cast<long>(attr.sharedSizeBytes) <= optin ? bytes : 0;
}

}  // namespace

// Floats of device scratch the solve needs for `n_traj` trajectories of
// n qubits: 0 when the state planes fit in shared memory.
extern "C" long mcwf_scratch_floats(int n, int n_traj) {
  if (planes_smem_bytes(n) > 0) return 0;
  return static_cast<long>(n_traj) * kPlanes * (1L << n);
}

// Runs the whole solve on `stream`, one block per trajectory. Device
// inputs, in the layout of the TPU kernel's `_mcwf_jit` (B trajectories
// of S segments, L steps each): a_re, a_im, det (B*S, L, 3, n); seg_dts
// (B*S, L); us (B*S, L, 2); r0 (B); diags (B, 2^n); psi0_re, psi0_im
// (2^n); cops (n_cops, 8). Outputs: out (B*S, 2, 2^n) normalised states
// after each segment, jumps (B) int32 jump counts. `scratch` holds
// mcwf_scratch_floats(n, B) floats (may be null when that is 0). g00, g11
// are the diagonal of G = sum_k L_k+ L_k and (g_lo_re, g_lo_im) its
// [1, 0] entry. Returns the cudaError_t of the launch (0 on success).
extern "C" int mcwf_run(const float* a_re, const float* a_im, const float* det,
                        const float* seg_dts, const float* us, const float* r0,
                        const float* diags, const float* psi0_re,
                        const float* psi0_im, const float* cops, float* out,
                        int* jumps, float* scratch, int n_traj, int S, int L,
                        int n, int n_cops, float g00, float g11, float g_lo_re,
                        float g_lo_im, void* stream) {
  if (n < 1 || n > kMaxQubits || n_cops < 1 || n_cops > kMaxCops ||
      n_traj < 1)
    return cudaErrorInvalidValue;
  const long smem = planes_smem_bytes(n);
  if (smem == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  if (smem > 0) {
    scratch = nullptr;
    cudaError_t err = cudaFuncSetAttribute(
        mcwf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  mcwf_kernel<<<n_traj, threads_for(1 << n), smem,
                static_cast<cudaStream_t>(stream)>>>(
      a_re, a_im, det, seg_dts, us, r0, diags, psi0_re, psi0_im, cops, out,
      jumps, scratch, S, L, n, n_cops, g00, g11, g_lo_re, g_lo_im);
  return cudaGetLastError();
}
