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
// What bounds it on an H100: a trajectory is a long chain of small
// dependent steps (hundreds of RK4 steps of 2^n amplitudes, each stage
// gathering n flip partners, and a norm reduction after every step), so
// the cost is latency: synchronisation and the per-amplitude phase and
// partner arithmetic, not bytes. A 10-qubit state is 8 KB per real plane.
//
// What the design does about it: one thread block per trajectory (the
// batch is embarrassingly parallel: 100 trajectories fill 100 of the 132
// SMs), and the whole plan in ONE launch: the block loops over segments
// and steps itself, reads the step sizes from device memory, and skips
// the zero-length padding steps at no cost. The state, RK4 stage input,
// accumulator, rotated stage input and the stage's rotor (cos, sin) are
// ten f32 planes that live in shared memory while they fit (n <= 12 on
// an H100: 40 * 2^n bytes) and in a per-trajectory slice of device
// memory otherwise (n = 13: 320 KB per trajectory, L2-resident). Each
// RK4 stage is two passes separated by a barrier: (1) rotate the stage
// input into the interaction picture, w = e^{-i Phi} x; (2) gather the n
// single-flip partners w[i ^ (1 << (n-1-q))], apply the drive, rotate
// back and add the non-Hermitian decay -1/2 g x. After each step a block
// reduction gives the norm; only when norm^2 <= r (a jump) does the block
// reduce the per-(operator, qubit) weights, pick the channel and
// renormalise. Tensor cores, clusters and TMA are later work.
//
// Conventions, as in the TPU kernel: qubit q is bit n-1-q of the flat
// index (MSB first). The drive on qubit q enters with +a_im where the
// OUTPUT index has bit q set and -a_im where not. The phase is
//   Phi(i) = ((diag[i] * t) mod 2pi) + sum_q cum_q * (1 - bit_q(i)),
// summed in that order, with a floored mod (jnp.mod): fmodf truncates,
// so its sign is fixed up. sincosf (not __sincosf) holds full accuracy at
// phases of ~100 rad. The jump test and the channel choice use the TPU
// kernel's comparisons: channels (operator k outer, qubit q inner) are
// chosen searchsorted-left on u0 * total (`u <= cum`, and `u > prev`
// beyond the first), the state is renormalised by 1/sqrt(max(w, 1e-30)),
// and the threshold r becomes the step's second uniform only on a jump.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQubits = 16;
constexpr int kMaxCops = 8;
constexpr int kPlanes = 10;
constexpr float kTwoPi = 6.283185307179586f;

// Plane order inside a trajectory's scratch (each `dim` floats).
enum Plane { kPsiRe, kPsiIm, kKRe, kKIm, kAccRe, kAccIm, kWRe, kWIm, kCos, kSin };

__device__ __forceinline__ float floored_mod_2pi(float x) {
  float r = fmodf(x, kTwoPi);
  return (r != 0.0f && r < 0.0f) ? r + kTwoPi : r;
}

__device__ __forceinline__ float ip_phase(int idx, float diag_t_mod,
                                          const float* cum, int n) {
  float ph = diag_t_mod;
  for (int q = 0; q < n; ++q) {
    if (!((idx >> (n - 1 - q)) & 1)) ph += cum[q];
  }
  return ph;
}

// Sum of `v` over the block, in a fixed order; every thread gets it.
// `red` holds 33 floats. blockDim.x is a multiple of 32.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // `red` may still be read from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    v = lane < n_warps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// cops: (n_cops, 6) rows (l00_re, l00_im, l11_re, l11_im, |l00|^2, |l11|^2).
__global__ void __launch_bounds__(1024)
mcwf_rows_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                 const float* __restrict__ cum, const float* __restrict__ t_stage,
                 const float* __restrict__ seg_dts, const float* __restrict__ us,
                 const float* __restrict__ eval_t,
                 const float* __restrict__ eval_cum,
                 const float* __restrict__ r0, const float* __restrict__ diags,
                 const float* __restrict__ psi0_re,
                 const float* __restrict__ psi0_im,
                 const float* __restrict__ cops, float* __restrict__ out,
                 int* __restrict__ jumps, float* __restrict__ scratch, int S,
                 int L, int n, int n_cops, float g00, float g11) {
  extern __shared__ float smem[];
  __shared__ float s_are[kMaxQubits], s_aim[kMaxQubits], s_cum[kMaxQubits];
  __shared__ float s_cop[kMaxCops * 6];
  __shared__ float s_w[kMaxCops * kMaxQubits];
  __shared__ float s_red[33];
  __shared__ float s_t, s_inv;
  __shared__ int s_sel;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int dim = 1 << n;
  float* pl = scratch ? scratch + static_cast<long>(b) * kPlanes * dim : smem;
  float* psi_re = pl + kPsiRe * dim;
  float* psi_im = pl + kPsiIm * dim;
  float* k_re = pl + kKRe * dim;
  float* k_im = pl + kKIm * dim;
  float* acc_re = pl + kAccRe * dim;
  float* acc_im = pl + kAccIm * dim;
  float* w_re = pl + kWRe * dim;
  float* w_im = pl + kWIm * dim;
  float* rc = pl + kCos * dim;
  float* rs = pl + kSin * dim;
  const float* diag = diags + static_cast<long>(b) * dim;
  const long drive0 = static_cast<long>(b) * S * L * 3 * n;
  const long u0_base = static_cast<long>(b) * S * L * 2;

  for (int i = tid; i < n_cops * 6; i += nt) s_cop[i] = cops[i];
  for (int i = tid; i < dim; i += nt) {
    psi_re[i] = psi0_re[i];
    psi_im[i] = psi0_im[i];
  }
  float r = r0[b];
  int n_jumps = 0;
  const float a_w[4] = {0.0f, 0.5f, 0.5f, 1.0f};
  const float b_w[4] = {1.0f / 6.0f, 1.0f / 3.0f, 1.0f / 3.0f, 1.0f / 6.0f};
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    for (int st = 0; st < L; ++st) {
      const float h = seg_dts[s * L + st];
      if (h == 0.0f) continue;  // start padding of a short segment
      for (int j = 0; j < 4; ++j) {
        const int sidx = (j + 1) >> 1;
        const long row = (static_cast<long>(s) * L + st) * 3 + sidx;
        __syncthreads();  // the previous pass 2 is done with s_* and w
        if (tid < n) {
          s_are[tid] = a_re[drive0 + row * n + tid];
          s_aim[tid] = a_im[drive0 + row * n + tid];
          s_cum[tid] = cum[drive0 + row * n + tid];
        }
        if (tid == 0) s_t = t_stage[row];
        __syncthreads();
        const float t = s_t;
        const float ha = h * a_w[j];
        // Pass 1: w = e^{-i Phi} x, x = psi + h a_j k_{j-1}
        for (int i = tid; i < dim; i += nt) {
          float xr = psi_re[i], xi = psi_im[i];
          if (j > 0) {
            xr += ha * k_re[i];
            xi += ha * k_im[i];
          }
          const float ph = ip_phase(i, floored_mod_2pi(diag[i] * t), s_cum, n);
          float sn, c;
          sincosf(ph, &sn, &c);
          rc[i] = c;
          rs[i] = sn;
          w_re[i] = c * xr + sn * xi;
          w_im[i] = c * xi - sn * xr;
        }
        __syncthreads();
        // Pass 2: k_j = -i e^{i Phi} sum_q M_q w[flip_q] - 1/2 g x
        for (int i = tid; i < dim; i += nt) {
          float yr = 0.0f, yi = 0.0f;
          int pop = 0;
          for (int q = 0; q < n; ++q) {
            const int bit = 1 << (n - 1 - q);
            const int p = i ^ bit;
            const float fr = w_re[p], fi = w_im[p];
            const float ar = s_are[q];
            const float ai = (i & bit) ? s_aim[q] : -s_aim[q];
            pop += (i & bit) ? 1 : 0;
            yr = yr + ar * fr - ai * fi;
            yi = yi + ar * fi + ai * fr;
          }
          float xr = psi_re[i], xi = psi_im[i];
          if (j > 0) {
            xr += ha * k_re[i];
            xi += ha * k_im[i];
          }
          const float popf = static_cast<float>(pop);
          const float g = g00 * (static_cast<float>(n) - popf) + g11 * popf;
          const float c = rc[i], sn = rs[i];
          const float kr = c * yi + sn * yr - 0.5f * g * xr;
          const float ki = sn * yi - c * yr - 0.5f * g * xi;
          k_re[i] = kr;
          k_im[i] = ki;
          if (j == 0) {
            acc_re[i] = b_w[j] * kr;
            acc_im[i] = b_w[j] * ki;
          } else {
            acc_re[i] += b_w[j] * kr;
            acc_im[i] += b_w[j] * ki;
          }
        }
      }
      // psi <- psi + h acc, and its norm (each thread owns its indices)
      float part = 0.0f;
      for (int i = tid; i < dim; i += nt) {
        const float pr = psi_re[i] + h * acc_re[i];
        const float pi = psi_im[i] + h * acc_im[i];
        psi_re[i] = pr;
        psi_im[i] = pi;
        part += pr * pr + pi * pi;
      }
      const float norm2 = block_sum(part, s_red);
      if (norm2 > r) continue;  // no jump (uniform across the block)

      // A jump: weights of every (operator k, qubit q) channel
      const long ub = u0_base + (static_cast<long>(s) * L + st) * 2;
      for (int q = 0; q < n; ++q) {
        float p0 = 0.0f, p1 = 0.0f;
        for (int i = tid; i < dim; i += nt) {
          const float p = psi_re[i] * psi_re[i] + psi_im[i] * psi_im[i];
          if ((i >> (n - 1 - q)) & 1)
            p1 += p;
          else
            p0 += p;
        }
        p0 = block_sum(p0, s_red);
        p1 = block_sum(p1, s_red);
        if (tid == 0) {
          for (int k = 0; k < n_cops; ++k)
            s_w[k * n + q] = s_cop[k * 6 + 4] * p0 + s_cop[k * 6 + 5] * p1;
        }
      }
      if (tid == 0) {
        const int n_w = n_cops * n;
        float total = s_w[0];
        for (int x = 1; x < n_w; ++x) total = total + s_w[x];
        const float u = us[ub] * total;
        float cum_w = 0.0f, w_sel = 0.0f;
        int sel = -1;
        for (int x = 0; x < n_w; ++x) {
          const float prev = cum_w;
          cum_w = cum_w + s_w[x];
          const bool hit = (u <= cum_w) && (x == 0 || u > prev);
          if (hit && sel < 0) {
            sel = x;
            w_sel = s_w[x];
          }
        }
        s_sel = sel;
        s_inv = 1.0f / sqrtf(fmaxf(w_sel, 1e-30f));
      }
      __syncthreads();
      const int sel = s_sel;
      const float inv = s_inv;
      for (int i = tid; i < dim; i += nt) {
        float jr = 0.0f, ji = 0.0f;
        if (sel >= 0) {
          const int k = sel / n, q = sel % n;
          const bool one = (i >> (n - 1 - q)) & 1;
          const float cr = s_cop[k * 6 + (one ? 2 : 0)];
          const float ci = s_cop[k * 6 + (one ? 3 : 1)];
          const float pr = psi_re[i], pi = psi_im[i];
          jr = (cr * pr - ci * pi) * inv;
          ji = (cr * pi + ci * pr) * inv;
        }
        psi_re[i] = jr;
        psi_im[i] = ji;
      }
      r = us[ub + 1];
      ++n_jumps;
    }
    // Emit the normalised lab-frame state: e^{-i Phi(t_eval)} psi / |psi|
    float part = 0.0f;
    for (int i = tid; i < dim; i += nt)
      part += psi_re[i] * psi_re[i] + psi_im[i] * psi_im[i];
    const float inv_n = 1.0f / sqrtf(fmaxf(block_sum(part, s_red), 1e-30f));
    if (tid < n) s_cum[tid] = eval_cum[(static_cast<long>(b) * S + s) * n + tid];
    if (tid == 0) s_t = eval_t[s];
    __syncthreads();
    float* o = out + (static_cast<long>(b) * S + s) * 2 * dim;
    for (int i = tid; i < dim; i += nt) {
      const float ph =
          ip_phase(i, floored_mod_2pi(diag[i] * s_t), s_cum, n);
      float sn, c;
      sincosf(ph, &sn, &c);
      const float pr = psi_re[i] * inv_n, pi = psi_im[i] * inv_n;
      o[i] = c * pr + sn * pi;
      o[dim + i] = c * pi - sn * pr;
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
  if (cudaFuncGetAttributes(&attr, mcwf_rows_kernel) != cudaSuccess) return 0;
  return bytes + static_cast<long>(attr.sharedSizeBytes) <= optin ? bytes : 0;
}

}  // namespace

// Floats of device scratch the solve needs for `n_traj` trajectories of
// n qubits: 0 when the state planes fit in shared memory.
extern "C" long mcwf_rows_scratch_floats(int n, int n_traj) {
  if (planes_smem_bytes(n) > 0) return 0;
  return static_cast<long>(n_traj) * kPlanes * (1L << n);
}

// Runs the whole solve on `stream`, one block per trajectory. Device
// inputs, in the layout of the TPU kernel's `mcwf_rows_program`: a_re,
// a_im, cum (B, S, L, 3, n); t_stage (S, L, 3); seg_dts (S, L); us
// (B, S, L, 2); eval_t (S); eval_cum (B, S, n); r0 (B); diags (B, 2^n);
// psi0_re, psi0_im (2^n); cops (n_cops, 6). Outputs: out (B, S, 2, 2^n)
// normalised lab-frame states after each segment, jumps (B) int32 jump
// counts. `scratch` holds mcwf_rows_scratch_floats(n, B) floats (may be
// null when that is 0). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mcwf_rows_run(const float* a_re, const float* a_im,
                             const float* cum, const float* t_stage,
                             const float* seg_dts, const float* us,
                             const float* eval_t, const float* eval_cum,
                             const float* r0, const float* diags,
                             const float* psi0_re, const float* psi0_im,
                             const float* cops, float* out, int* jumps,
                             float* scratch, int n_traj, int S, int L, int n,
                             int n_cops, float g00, float g11, void* stream) {
  if (n < 1 || n > 13 || n_cops < 1 || n_cops > kMaxCops || n_traj < 1)
    return cudaErrorInvalidValue;
  const long smem = planes_smem_bytes(n);
  if (smem == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  if (smem > 0) {
    scratch = nullptr;
    cudaError_t err = cudaFuncSetAttribute(
        mcwf_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  mcwf_rows_kernel<<<n_traj, threads_for(1 << n), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      a_re, a_im, cum, t_stage, seg_dts, us, eval_t, eval_cum, r0, diags,
      psi0_re, psi0_im, cops, out, jumps, scratch, S, L, n, n_cops, g00, g11);
  return cudaGetLastError();
}
