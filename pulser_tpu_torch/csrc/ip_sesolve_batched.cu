// Trajectory-batched interaction-picture RK4 sesolve for one
// ground-rydberg basis (d = 2), 10 <= n <= 17: one thread block per
// trajectory up to n = 13, one thread-block cluster per trajectory above.
//
// Replaces the trajectory-batched mode of the TPU kernel
// `_ip_sesolve_kernel` of pulser_tpu/ops/pallas_kernels.py
// (`segs_per_traj`: the Pallas grid flattens (trajectory, segment), runs
// it in order on one core, resets the state from psi0 at every
// trajectory's first segment and reads that trajectory's interaction
// diagonal).
//
// Each RK4 stage computes, in the interaction picture of the diagonal,
//   k = -i e^{+i Phi} sum_q M_q (e^{-i Phi} x)[flip_q],
// and each segment end emits e^{-i Phi(t_eval)} phi, the lab-frame state.
// Noise trajectories without collapse operators differ in their drive
// rows (amplitude noise), their phase integrals (doppler) and their
// diagonal; they share the initial state.
//
// What bounds it on an H100: a trajectory is a chain of thousands of
// small dependent RK4 stages over 2^n amplitudes (about 9n + 25 f32
// operations per amplitude and stage), so the latency of a stage and the
// barrier between two stages bound it, not bytes: a stage reads 3n drive
// values, and the state is 8 KB per real plane at n = 10. A 1024-thread
// block holds at most 8192 amplitudes (three complex planes of shared
// memory, 192 KiB), so from n = 14 a trajectory needs several SMs and
// the barrier between its stages has to span them. On an NVIDIA H100
// 80GB HBM3 at 700 W (tools/block_sizes.py, chip_smoke.py) a stage of
// SPD10 (n = 10, 100 trajectories at once) takes about 1.3 us, one of
// n = 13 (8192 amplitudes a block) about 9.7 us: the barrier and the
// latency of the stage's gathers and rotors, not its arithmetic. The
// cooperative kernel of ip_sesolve.cu took 2.5 us a stage at n = 14 but
// held a whole grid for one trajectory at a time: 32 to 128 of the
// card's 132 SMs for n = 14 to 16, each stage paying a grid barrier.
//
// What the design does about it: each trajectory gets C = 2^(n - NB)
// blocks of T threads, each block 2^NB amplitudes, in ONE thread-block
// cluster; the whole batch is ONE launch of n_traj * C blocks, and the
// hardware runs as many clusters side by side as the card holds, in
// waves, so the card fills whatever n. The stage barrier is the
// cluster's (barrier.cluster, the C blocks sit in one GPC) instead of a
// grid barrier, and partners in other blocks come from their shared
// memory (distributed shared memory) instead of through L2. Measured on
// that card, 100 random trajectories of 254 steps: 12.6, 12.4, 14.3 and
// 15.9 us a stage of a cluster at n = 14 (C = 2), 15 (C = 8 blocks of
// 2^12), 16 (C = 8) and 17 (C = 16), against 9.7 us for the lone block
// at n = 13: the cluster barrier and the remote partners cost 3 to 6 us
// a stage, and the batch takes 25.653 / 50.306 / 101.542 / 241.863 ms
// against 254.061 / 267.813 / 283.741 / 392.273 ms with the trajectories
// one after another in the cooperative kernel. Clusters at once
// (cudaOccupancyMaxActiveClusters): 66 at n = 14, 30 at n = 15 (either
// shape), 15 at n = 16 (14 with 16 blocks of 2^12) and 7 at n = 17; one
// block per trajectory below, 132 at once.
//
// The structure is mcwf_rows.cu's without decay, norm and jumps. Block
// r = cluster.block_rank() owns amplitudes [r 2^NB, (r + 1) 2^NB): the
// top n - NB bits of an index name its block. The block loops over its
// trajectory's segments and steps and skips the zero-length padding
// steps. Each thread owns fixed amplitudes (local index tid + a T); its
// phi, the RK4 accumulator, its diagonal and its current rotor (cos,
// sin) live in registers. Only the rotated stage input w = e^{-i Phi} x
// goes to shared memory, double-buffered. Flip partners below 32 come by
// __shfl_xor_sync, those below 2^NB from the block's own shared memory,
// and those on the top n - NB bits from the partner block's shared
// memory (map_shared_rank, then a plain load); the partners are summed in
// q order, as in the plain version. A stage is one pass ending in ONE
// barrier (the block's for C = 1, the cluster's above; the C = 1
// instantiations compile no cluster code), four per step: gather the
// partners of w_j, rotate back, form k_j, accumulate, form the next
// stage input, rotate it and publish it to the other buffer; the last
// stage publishes the rotated new state, which is the next step's first
// stage input. w is double-buffered, so a block overwrites a plane only
// after the barrier that ends every read of it. Stages 1 and 2 share the
// midpoint rotor, and the end-of-step rotor is carried into the next
// non-padding step whenever warp 0 finds that step's first row (stage
// time and the n phase integrals) equal to it bit for bit; otherwise the
// rotor is recomputed and the first stage input republished (one more
// barrier), so the kernel is right on any input. Warp 0 of every block
// copies the next step's rows into shared memory with cp.async while the
// current step runs and finds the next non-padding step: the blocks of a
// cluster read the same rows and make the same test, so all meet the
// same barriers. Before a block of a cluster exits, the cluster meets
// one last barrier.
//
// Registers: 1024 threads cap a thread at 64 registers (512 threads at
// two blocks an SM, too). From kLeanFromAmps amplitudes per thread on the
// diagonal is re-read where a rotor needs it; from kSharedAccFromAmps on
// the RK4 accumulator lives in a third complex plane of shared memory
// (64 KiB at 8192 amplitudes). The cluster shapes the table picks spill
// 136 bytes a thread at n = 14, 15 and 16 and 156 at n = 17 (ptxas spill
// stores; the other shapes 120 to 160), the lone block at n = 13 16.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using pt::cp_async4;
using pt::cp_async_wait_all;
using pt::first_real;
using pt::kFull;
using pt::step_window;

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

// One block of T threads over 2^NB amplitudes of a trajectory of 2^N.
template <int N, int NB, int T>
struct Shape {
  static constexpr int kDim = 1 << N;
  static constexpr int kBlockDim = 1 << NB;
  static constexpr int kCluster = 1 << (N - NB);  // blocks per trajectory
  static constexpr int kAmps = kBlockDim / T;
  static constexpr bool kLean = kAmps >= kLeanFromAmps;
  static constexpr bool kSharedAcc = kAmps >= kSharedAccFromAmps;
  // Two planes of w, and the accumulator's where it lives there
  static constexpr int kSmemBytes =
      (kSharedAcc ? 3 : 2) * kBlockDim * static_cast<int>(sizeof(float2));
  static_assert(NB <= N && kCluster <= 16, "at most 16 blocks a cluster");
  static_assert(kAmps >= 1 && T >= 32, "a thread holds an amplitude");
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

// The flip partner li ^ m of the block's amplitude with local index `li`
// in plane `w`; `own` is the amplitude's own value there. Flips below 32
// come from the lane li ^ m of the same warp, so every lane must call
// this with the same m; flips at or above the block's 2^NB amplitudes
// from the same plane of block rank ^ (m >> NB) of the cluster.
template <int NB>
__device__ __forceinline__ float2 partner(const float2* w, int li, int m,
                                         float2 own, unsigned rank) {
  if (m < 32)
    return make_float2(__shfl_xor_sync(kFull, own.x, m),
                       __shfl_xor_sync(kFull, own.y, m));
  if (m < (1 << NB)) return w[li ^ m];
  return cg::this_cluster().map_shared_rank(w, rank ^ (m >> NB))[li];
}

// RK4 weights: stage j adds b_j k_j to the accumulator, and the stage
// input of stage j + 1 is phi + h a_{j+1} k_j.
__device__ __forceinline__ float rk_b(int j) {
  return j == 0 || j == 3 ? 1.0f / 6.0f : 1.0f / 3.0f;
}
__device__ __forceinline__ float rk_a_next(int j) {
  return j == 2 ? 1.0f : 0.5f;
}

// Trajectory b is solved by blocks [b C, (b + 1) C), one cluster for
// C > 1; its plan rows are [b S L, (b + 1) S L).
template <int N, int NB, int T>
__global__ void __launch_bounds__(T, kThreads / T)
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
  using Sh = Shape<N, NB, T>;
  constexpr int D = Sh::kDim, DB = Sh::kBlockDim, A = Sh::kAmps;
  constexpr int C = Sh::kCluster;
  constexpr bool kLean = Sh::kLean, kSharedAcc = Sh::kSharedAcc;
  extern __shared__ float2 s_w[];  // two planes of w (and the accumulator)
  __shared__ Rows<N> s_rows[2];

  unsigned rank = 0;
  if constexpr (C > 1) rank = cg::this_cluster().block_rank();
  // A stage's barrier: the block's, or the cluster's when partners lie
  // in other blocks
  auto stage_sync = [] {
    if constexpr (Sh::kCluster > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // This block's first amplitude in the trajectory
  const int base = static_cast<int>(rank) * DB;
  const int total = S * L;
  const long row0 = static_cast<long>(b) * total;
  // This trajectory's step sizes, diagonal and evaluation rows
  const float* dts = seg_dts + row0;
  const float* diag = diags + static_cast<long>(b) * D;
  const long seg0 = static_cast<long>(b) * S;
  float2* s_acc = s_w + 2 * DB;

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
    const int idx = base + tid + a * T;
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
        const int idx = base + tid + a * T;
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
    // is new (uniform over the block and the cluster).
    const bool carry = rw.carry != 0;
    if (!carry || !fresh) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int li = tid + a * T, idx = base + li;
        if (!carry)
          rotor<N>(idx, diag_of(a, idx), rw.t[0], rw.cum[0], rw.cum_sum[0],
                   c[a], s[a]);
        s_w[li] = rotate(c[a], s[a], phi[a]);
      }
      stage_sync();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // Stage j reads plan row sidx, stage j + 1 row nrow
      const int sidx = (j + 1) >> 1, nrow = (j + 2) >> 1;
      // Stage j reads plane j & 1 and publishes the next input to the other
      const float2* win_j = s_w + (j & 1) * DB;
      float2* wout = s_w + ((j + 1) & 1) * DB;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int li = tid + a * T, idx = base + li;
        const float2 w = win_j[li];
        float yr = 0.0f, yi = 0.0f;
#pragma unroll
        for (int q = 0; q < N; ++q) {
          const int m = 1 << (N - 1 - q);
          const float2 fp = partner<NB>(win_j, li, m, w, rank);
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
            old = s_acc[li];
          else
            old = acc[a];
          sum = make_float2(old.x + rk_b(j) * kr, old.y + rk_b(j) * ki);
        }
        if (j < 3) {
          if constexpr (kSharedAcc)
            s_acc[li] = sum;
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
          wout[li] = rotate(c[a], s[a], xn);
        } else {
          // phi <- phi + h acc; rotated, it is the next step's w_0
          phi[a] = make_float2(phi[a].x + h * sum.x, phi[a].y + h * sum.y);
          wout[li] = rotate(c[a], s[a], phi[a]);
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
      stage_sync();
    }
    p ^= 1;
    fresh = true;
  }
  // No block leaves while another may still read its shared memory
  if constexpr (C > 1) cg::this_cluster().sync();
}

// Sets the kernel's attributes for its shape: the dynamic shared memory
// and, above the portable 8 blocks, the cluster size.
template <int N, int NB, int T>
cudaError_t prepare() {
  using Sh = Shape<N, NB, T>;
  auto kern = ip_sesolve_batched_kernel<N, NB, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmemBytes);
  if (err == cudaSuccess && Sh::kCluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// The launch configuration of `n_traj` trajectories: one cluster of C
// blocks each (`attr` is filled for C > 1).
template <int N, int NB, int T>
cudaLaunchConfig_t launch_config(int n_traj, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  using Sh = Shape<N, NB, T>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_traj * Sh::kCluster);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = Sh::kSmemBytes;
  cfg.stream = st;
  if (Sh::kCluster > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = Sh::kCluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

template <int N, int NB, int T>
cudaError_t launch(const float* a_re, const float* a_im, const float* cum,
                   const float* t_stage, const float* seg_dts,
                   const float* eval_t, const float* eval_cum,
                   const float* diags, const float* psi0_re,
                   const float* psi0_im, float* out, int n_traj, int S, int L,
                   cudaStream_t st) {
  cudaError_t err = prepare<N, NB, T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<N, NB, T>(n_traj, st, &attr);
  err = cudaLaunchKernelEx(&cfg, ip_sesolve_batched_kernel<N, NB, T>, a_re,
                           a_im, cum, t_stage, seg_dts, eval_t, eval_cum,
                           diags, psi0_re, psi0_im, out, S, L);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++g_device_launches;
  return err;
}

// config = (block qubits NB, blocks per trajectory C, threads per block,
// amplitudes per thread, dynamic shared bytes per block, trajectories the
// card runs at once): the occupancy API's clusters, or blocks for C = 1.
template <int N, int NB, int T>
cudaError_t shape_config(int* config) {
  using Sh = Shape<N, NB, T>;
  cudaError_t err = prepare<N, NB, T>();
  if (err != cudaSuccess) return err;
  auto kern = ip_sesolve_batched_kernel<N, NB, T>;
  int active = 0;
  if (Sh::kCluster > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config<N, NB, T>(1, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  } else {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, T, Sh::kSmemBytes);
    active = per_sm * sms;
  }
  if (err != cudaSuccess) return err;
  const int values[6] = {NB, Sh::kCluster, T, Sh::kAmps, Sh::kSmemBytes,
                         active};
  for (int i = 0; i < 6; ++i) config[i] = values[i];
  return cudaSuccess;
}

}  // namespace

// The shape of each n (n, block qubits NB, threads), the table of
// ops/kernels.py's IP_BATCHED_SHAPES: a block of 2^13 amplitudes has
// kThreads threads, one of 2^12 half as many (two blocks an SM). For
// n = 14 to 16 both were timed in turns on an NVIDIA H100 80GB HBM3 at
// 700 W (tools/block_sizes.py ip_sesolve_batched_cluster, 100 random
// trajectories of 254 steps) and the faster kept: 2^13 at n = 14 (25.653
// against 26.254 ms) and 16 (101.542 against 117.740), 2^12 at n = 15
// (50.306 against 53.534). n = 17 has one shape, 16 blocks of 2^13
// (241.863 ms against 392.273 for the cooperative kernel that ran the
// trajectories one after another).
#define PT_IPB_SHAPES(CASE)                                          \
  CASE(10, 10, kThreads) CASE(11, 11, kThreads)                      \
  CASE(12, 12, kThreads) CASE(13, 13, kThreads)                      \
  CASE(14, 13, kThreads) CASE(15, 12, kThreads / 2)                  \
  CASE(16, 13, kThreads) CASE(17, 13, kThreads)

// Runs the whole batch on `stream`, one block (n <= 13) or one cluster of
// 2^(n - NB) blocks (n >= 14, PT_IPB_SHAPES) per trajectory. Device inputs, in the layout of the
// TPU kernel's `_ip_sesolve_jit` with `segs_per_traj = S` (B
// trajectories, trajectory-major): a_re, a_im, cum (B * S, L, 3, n);
// t_stage (B * S, L, 3); seg_dts (B * S, L), zero entries are padding and
// skipped; eval_t (B * S); eval_cum (B * S, n); diags (B, 2^n); psi0_re,
// psi0_im (2^n). Output `out` is (B * S, 2, 2^n), the lab-frame state
// after each segment. Returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for n outside [10, 17].
extern "C" int ip_sesolve_batched_run(
    const float* a_re, const float* a_im, const float* cum,
    const float* t_stage, const float* seg_dts, const float* eval_t,
    const float* eval_cum, const float* diags, const float* psi0_re,
    const float* psi0_im, float* out, int n_traj, int segs_per_traj,
    int seg_len, int n, void* stream) {
  if (n_traj < 1 || segs_per_traj < 1 || seg_len < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PT_IPB_CASE(NQ, NBQ, TQ)                                          \
  if (n == NQ)                                                            \
    return launch<NQ, NBQ, TQ>(a_re, a_im, cum, t_stage, seg_dts, eval_t, \
                               eval_cum, diags, psi0_re, psi0_im, out,    \
                               n_traj, segs_per_traj, seg_len, st);
  PT_IPB_SHAPES(PT_IPB_CASE)
#undef PT_IPB_CASE
  return cudaErrorInvalidValue;
}

// The shape ip_sesolve_batched_run launches for n qubits on the current
// device: config = (block qubits, blocks per trajectory, threads per
// block, amplitudes per thread, dynamic shared bytes per block,
// trajectories the card runs at once).
extern "C" int ip_sesolve_batched_config(int n, int* config) {
#define PT_IPB_CASE(NQ, NBQ, TQ) \
  if (n == NQ) return shape_config<NQ, NBQ, TQ>(config);
  PT_IPB_SHAPES(PT_IPB_CASE)
#undef PT_IPB_CASE
  return cudaErrorInvalidValue;
}

// The device kernels this library has launched so far
// (ip_sesolve_batched_run makes one): a caller counts the launches of one
// call as the difference, without a profiler.
extern "C" unsigned long long ip_sesolve_batched_device_launches() {
  return g_device_launches.load();
}
