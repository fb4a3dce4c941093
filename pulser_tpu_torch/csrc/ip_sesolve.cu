// Interaction-picture RK4 sesolve for one ground-rydberg basis (d = 2).
//
// Replaces the TPU kernel `_ip_sesolve_kernel` of
// pulser_tpu/ops/pallas_kernels.py (one Pallas grid step per evaluation
// segment, the state resident in VMEM as (R, C) real/imaginary planes).
//
// What bounds it on an H100: the state. A 16-qubit state is 512 KiB as
// complex64 and a 17-qubit state 1 MiB, beyond one block's 227 KB of
// shared memory, so the TPU's "whole state in fast memory, one sequential
// grid step per segment" layout does not carry over. Every RK4 stage
// reads each amplitude n + 1 times (its n single-flip partners and
// itself) and writes it about twice: a memory-bound stream of ~(n+3)*8
// bytes per amplitude, served mostly from the 50 MB L2, which holds the
// state, the stage input and the accumulator many times over.
//
// What the design does about it: state, stage input and accumulator live
// in device memory, double-buffered so that no launch reads what it
// writes at another index. Each RK4 stage is one launch over the 2^n
// amplitudes with one thread per output index. The thread gathers its n
// partners idx ^ (1 << b), computes their interaction-picture rotors on
// the fly (no phase or occupancy table in memory), sums the drive terms,
// applies its own outer rotor and updates the accumulator and, at the
// last stage, the next state. The host loops over segments and steps
// (inside ip_sesolve_run below, so Python pays one call per solve) and
// skips the zero-length padding steps of short segments. A small emit
// kernel writes each segment's lab-frame state. Persistent cooperative
// grids, CUDA graphs, clusters and tensor cores are later work.
//
// Conventions, as in the TPU kernel: qubit q is bit n-1-q of the flat
// index (MSB first). The drive on qubit q is M_q = a_q |1><0| + conj(a_q)
// |0><1|: the imaginary part enters with +a_im where the OUTPUT index has
// bit q set and -a_im where it does not. The phase is
//   Phi(idx) = ((diag[idx] * t) mod 2pi) + sum_q cum_q - sum_q cum_q bit_q(idx)
// with a floored mod (jnp.mod): fmodf truncates, so its sign is fixed up.
// sincosf (not __sincosf) keeps full accuracy for arguments of ~100 rad.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQubits = 32;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float floored_mod_2pi(float x) {
  float r = fmodf(x, kTwoPi);
  return r < 0.0f ? r + kTwoPi : r;
}

// Phi(idx), summed in the TPU kernel's order.
__device__ __forceinline__ float ip_phase(int idx, float diag_t_mod,
                                          float cum_sum, const float* cum,
                                          int n) {
  float ph = diag_t_mod + cum_sum;
  for (int q = 0; q < n; ++q) {
    if ((idx >> (n - 1 - q)) & 1) ph -= cum[q];
  }
  return ph;
}

__global__ void ip_init_kernel(const float* __restrict__ psi0_re,
                               const float* __restrict__ psi0_im,
                               float2* __restrict__ phi, int dim) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < dim) phi[idx] = make_float2(psi0_re[idx], psi0_im[idx]);
}

// One RK4 stage j: k_j = -i e^{i Phi} A e^{-i Phi} (phi + h a_j k_{j-1}).
// `first` stage: no k_{j-1} term and the accumulator starts fresh.
// `last` stage: writes phi_out = phi + h (acc + b_j k_j).
__global__ void ip_stage_kernel(const float2* __restrict__ phi,
                                const float2* __restrict__ k_in,
                                float2* __restrict__ k_out,
                                float2* __restrict__ acc,
                                float2* __restrict__ phi_out,
                                const float* __restrict__ diag,
                                const float* __restrict__ a_re_row,
                                const float* __restrict__ a_im_row,
                                const float* __restrict__ cum_row,
                                const float* __restrict__ t_ptr, float h,
                                float a_w, float b_w, int first, int last,
                                int n, int dim) {
  __shared__ float s_are[kMaxQubits];
  __shared__ float s_aim[kMaxQubits];
  __shared__ float s_cum[kMaxQubits];
  __shared__ float s_t;
  if (threadIdx.x < n) {
    s_are[threadIdx.x] = a_re_row[threadIdx.x];
    s_aim[threadIdx.x] = a_im_row[threadIdx.x];
    s_cum[threadIdx.x] = cum_row[threadIdx.x];
  }
  if (threadIdx.x == 0) s_t = *t_ptr;
  __syncthreads();
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= dim) return;

  const float t = s_t;
  float cum_sum = 0.0f;
  for (int q = 0; q < n; ++q) cum_sum += s_cum[q];
  const float ha = h * a_w;

  float yr = 0.0f, yi = 0.0f;
  for (int q = 0; q < n; ++q) {
    const int bit = 1 << (n - 1 - q);
    const int p = idx ^ bit;
    float2 x = phi[p];
    if (!first) {
      const float2 kp = k_in[p];
      x.x += ha * kp.x;
      x.y += ha * kp.y;
    }
    const float ph =
        ip_phase(p, floored_mod_2pi(diag[p] * t), cum_sum, s_cum, n);
    float s, c;
    sincosf(ph, &s, &c);
    // w = e^{-i Phi} x
    const float wr = c * x.x + s * x.y;
    const float wi = c * x.y - s * x.x;
    const float ar = s_are[q];
    const float ai = (idx & bit) ? s_aim[q] : -s_aim[q];
    yr += ar * wr - ai * wi;
    yi += ar * wi + ai * wr;
  }
  const float ph =
      ip_phase(idx, floored_mod_2pi(diag[idx] * t), cum_sum, s_cum, n);
  float s, c;
  sincosf(ph, &s, &c);
  // k = -i e^{i Phi} y
  const float zr = c * yr - s * yi;
  const float zi = c * yi + s * yr;
  const float2 k = make_float2(zi, -zr);
  k_out[idx] = k;
  float2 a;
  if (first) {
    a = make_float2(b_w * k.x, b_w * k.y);
  } else {
    a = acc[idx];
    a.x += b_w * k.x;
    a.y += b_w * k.y;
  }
  if (last) {
    const float2 ph0 = phi[idx];
    phi_out[idx] = make_float2(ph0.x + h * a.x, ph0.y + h * a.y);
  } else {
    acc[idx] = a;
  }
}

// out[0] / out[1] = real / imaginary planes of e^{-i Phi(t_eval)} phi.
__global__ void ip_emit_kernel(const float2* __restrict__ phi,
                               const float* __restrict__ diag,
                               const float* __restrict__ eval_t,
                               const float* __restrict__ eval_cum,
                               float* __restrict__ out, int n, int dim) {
  __shared__ float s_cum[kMaxQubits];
  __shared__ float s_t;
  if (threadIdx.x < n) s_cum[threadIdx.x] = eval_cum[threadIdx.x];
  if (threadIdx.x == 0) s_t = *eval_t;
  __syncthreads();
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= dim) return;
  float cum_sum = 0.0f;
  for (int q = 0; q < n; ++q) cum_sum += s_cum[q];
  const float ph =
      ip_phase(idx, floored_mod_2pi(diag[idx] * s_t), cum_sum, s_cum, n);
  float s, c;
  sincosf(ph, &s, &c);
  const float2 p = phi[idx];
  out[idx] = c * p.x + s * p.y;
  out[dim + idx] = c * p.y - s * p.x;
}

}  // namespace

// Runs the whole solve on `stream`. Device inputs, in the layout of the
// TPU kernel's `_ip_sesolve_jit`: a_re, a_im, cum (n_seg, L*3, n); t_stage
// (n_seg, L*3); eval_t (n_seg); eval_cum (n_seg, n); diag, psi0_re,
// psi0_im (2^n). Output `out` is (n_seg, 2, 2^n). Scratch: phi (2, 2^n)
// float2, k (2, 2^n) float2, acc (2^n) float2. `h_host` is the host copy
// of the (n_seg, L) step sizes; zero entries are padding and skipped.
// Returns the cudaError_t of the last launch check (0 on success).
extern "C" int ip_sesolve_run(const float* a_re, const float* a_im,
                              const float* cum, const float* t_stage,
                              const float* eval_t, const float* eval_cum,
                              const float* diag, const float* psi0_re,
                              const float* psi0_im, float* out, void* phi,
                              void* k, void* acc, const float* h_host,
                              int n_seg, int seg_len, int n, void* stream) {
  if (n < 1 || n > kMaxQubits - 2) return cudaErrorInvalidValue;
  const int dim = 1 << n;
  const int blocks = (dim + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* phi_buf[2] = {static_cast<float2*>(phi),
                        static_cast<float2*>(phi) + dim};
  float2* k_buf[2] = {static_cast<float2*>(k), static_cast<float2*>(k) + dim};
  float2* acc_buf = static_cast<float2*>(acc);
  const float a_w[4] = {0.0f, 0.5f, 0.5f, 1.0f};
  const float b_w[4] = {1.0f / 6.0f, 1.0f / 3.0f, 1.0f / 3.0f, 1.0f / 6.0f};
  const int l3 = seg_len * 3;

  ip_init_kernel<<<blocks, kThreads, 0, st>>>(psi0_re, psi0_im, phi_buf[0],
                                              dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int cur = 0;
  for (int s = 0; s < n_seg; ++s) {
    for (int i = 0; i < seg_len; ++i) {
      const float h = h_host[s * seg_len + i];
      if (h == 0.0f) continue;
      for (int j = 0; j < 4; ++j) {
        const int sidx = (j + 1) >> 1;
        const long row = static_cast<long>(s) * l3 + i * 3 + sidx;
        ip_stage_kernel<<<blocks, kThreads, 0, st>>>(
            phi_buf[cur], k_buf[j & 1], k_buf[(j + 1) & 1], acc_buf,
            phi_buf[cur ^ 1], diag, a_re + row * n, a_im + row * n,
            cum + row * n, t_stage + row, h, a_w[j], b_w[j], j == 0, j == 3,
            n, dim);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
      }
      cur ^= 1;
    }
    ip_emit_kernel<<<blocks, kThreads, 0, st>>>(
        phi_buf[cur], diag, eval_t + s, eval_cum + static_cast<long>(s) * n,
        out + static_cast<long>(s) * 2 * dim, n, dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
