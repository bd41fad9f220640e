// The older continuous NUTS machine as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel blackjax_tpu/ops/fused_nuts.py:_nuts_kernel
// (launched by fused_nuts_run, pallas_call at fused_nuts.py:711), for the fused
// leapfrog's targets: the hierarchical and Gaussian targets and logistic
// regression (blackjax_tpu/ops/fused_leapfrog.py), with a diagonal metric. The
// Python wrapper and the plain PyTorch version of the same machine live in
// blackjax_tpu_torch/ops/fused_nuts.py.
//
// What it computes, per chain: num_steps NUTS transitions, one velocity-Verlet
// leaf per loop iteration, with progressive uniform merging inside a subtree,
// the biased merge across subtrees, checkpointed U-turn slots, the divergence
// threshold, and the inline restart (a chain that closes a transition draws its
// next momentum at the top of the following iteration), within a budget of leaf
// iterations. Randomness is the reference's counter-based threefry2x32, keyed as
// the Pallas kernel keys it: the momentum on (lane; 1 << 24 | chain * S +
// steps), the direction on (chain * S + steps; 2 << 24 | depth), the leaf's
// uniform on (...; 3 << 24 | nstates) and the proposal's on (...; 4 << 24 |
// depth), each the block's first word.
//
// It is the machine of csrc/fused_nuts_dc.cuh at pack = 1 and restart_every =
// 1, apart from what the older kernel spells otherwise, which this kernel keeps:
// the proposal's own block (the dc machine takes the second word of the
// direction's), a slot's U-turn rho = (sub_msum - ckpt_sum + ckpt_m) - 0.5
// (ckpt_m + m), the momentum (sigma_m sqrt(-2 log u1)) cos(2 pi u2), the targets'
// separate gradient and log density (fused_leapfrog's tile functions), and the
// per-iteration trace. Those differences reach every line of the leaf, so the
// machine is a kernel of its own rather than a policy of the dc template.
//
// Trace. With kTrace, the kernel records the 18 TRACE_COLS of fused_nuts.py of
// the first `trace` iterations. The reference runs that loop without an early
// exit, so a finished chain's registers keep evolving under its masks and its
// trace rows hold those values; the traced kernel runs them too. Without
// kTrace a chain leaves the loop when it has finished, which changes none of
// its outputs.
//
// Design. One warp runs one chain, as in the dc machine: lane j holds dims j,
// j+32, ... in N registers per vector (N = 4 for d = 100, d <= 256); per-chain
// scalars are replicated in all lanes, so every branch is warp-uniform; dot
// products are xor-shuffle reductions whose butterfly leaves the same bits in
// every lane. The 2 * max_depth checkpoint slots, indexed by a data-dependent
// slot id, live in shared memory (each lane touches only its own dims), beside
// logistic regression's per-warp scratch.
//
// Bound. A leaf is O(d) FP32 work (leapfrog, energy, up to max_depth slot
// checks), a gradient and a log density, exp/log/cos and a few threefry
// blocks; device memory sees the initial positions, a history row per closed
// transition and the final state. It is bound by FP32/SFU throughput and the
// latency of its shuffle reductions, not by bytes; logistic regression adds
// its contractions with X from L2 (matrix_targets.cuh).
//
// Numerics. Build without --use_fast_math and with --fmad=false: expf, logf,
// cosf, sqrtf and log1pf are the accurate library versions and no multiply-add
// is contracted, so the kernel rounds like the plain PyTorch version except for
// the order of its sums and the last ulp of the transcendentals.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "counter_rng.cuh"     // threefry2x32, to_unit, kKey1, kU24, kTwoPi
#include "matrix_targets.cuh"  // warp_sum, logaddexp, sigmoid, target_grad, target_logdensity

namespace {

constexpr int kWarps = 4;  // chains per block
constexpr int kTraceCols = 18;

struct Params {
  const float* x0;       // (C, d) initial positions
  const float* imm;      // (d,) diagonal inverse mass matrix
  const float* sigma_m;  // (d,) sqrt(1 / imm), 0 where imm <= 0
  const float* inv_var;  // (d,) Gaussian target only, else null
  float* out_x;          // (C, d) final positions
  int* out_steps;        // (C,) transitions completed
  float* out_grads;      // (C,) gradient evaluations of completed transitions
  float* out_hist;       // (C, S, n_track), zeroed by the caller
  float* out_trace;      // (C, trace, kTraceCols), zeroed by the caller, or null
  int C, d, S, n_track, max_depth, budget, trace, target;
  float eps, threshold;
  uint32_t seed;
  MatrixData mat;        // logistic regression's data, else zeros
};

// 0.5 * sum((m * imm) * m), as kinetic() of the reference
template <int N>
__device__ __forceinline__ float kinetic(const float (&m)[N], const float (&imm)[N]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) s += (m[k] * imm[k]) * m[k];
  return 0.5f * warp_sum(s);
}

// the reference's turning(m_left, m_right, m_sum) with rho given
template <int N>
__device__ __forceinline__ bool turning(const float (&ml)[N], const float (&mr)[N],
                                        const float (&rho)[N], const float (&imm)[N]) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    a += (imm[k] * ml[k]) * rho[k];
    b += (imm[k] * mr[k]) * rho[k];
  }
  return warp_sum(a) <= 0.f || warp_sum(b) <= 0.f;
}

template <int N>
__device__ __forceinline__ void copy(float (&dst)[N], const float (&src)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = src[k];
}

// the first word of the tagged block (seed, kKey1; c0, tag << 24 | sub) as
// U[0, 1): the reference's _counter_uniforms
__device__ __forceinline__ float counter_uniform(uint32_t seed, uint32_t c0, uint32_t tag,
                                                 uint32_t sub) {
  uint32_t b1, b2;
  threefry2x32(seed, kKey1, c0, (tag << 24) | sub, b1, b2);
  return to_unit(b1);
}

template <int N, int F, bool kTrace>
__global__ void __launch_bounds__(kWarps * 32) nuts_kernel(const Params p) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * kWarps + warp;
  if (chain >= p.C) return;  // the whole warp leaves together
  const int slot = N * 32;
  float* ck_m = smem + (size_t)warp * (2 * p.max_depth * slot + scratch_floats<N>());
  float* ck_s = ck_m + p.max_depth * slot;
  float* scratch = ck_s + p.max_depth * slot;  // logistic regression's

  float imm[N], iv[N], acc_x[N], acc_g[N], cur_x[N], cur_m[N], cur_g[N];
  float left_x[N], left_m[N], left_g[N], right_x[N], right_m[N], right_g[N];
  float msum[N], sub_msum[N], prop_x[N], prop_g[N], sub_x[N], sub_g[N];
  float new_x[N], new_m[N], new_g[N], rho[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    acc_x[k] = valid ? p.x0[(size_t)chain * p.d + j] : 0.f;
    imm[k] = valid ? p.imm[j] : 0.f;
    iv[k] = (valid && p.inv_var != nullptr) ? p.inv_var[j] : 0.f;
  }
  target_grad<N, F>(p, acc_x, iv, acc_g, lane, scratch);
  float acc_ld = target_logdensity<N, F>(p, acc_x, iv, lane, scratch);

  // the reference's initial registers: every end and proposal at x0 with a
  // zero momentum (read only by finished chains' masked updates)
  copy<N>(cur_x, acc_x); copy<N>(cur_g, acc_g);
  copy<N>(left_x, acc_x); copy<N>(left_g, acc_g);
  copy<N>(right_x, acc_x); copy<N>(right_g, acc_g);
  copy<N>(prop_x, acc_x); copy<N>(prop_g, acc_g);
  copy<N>(sub_x, acc_x); copy<N>(sub_g, acc_g);
#pragma unroll
  for (int k = 0; k < N; ++k) cur_m[k] = left_m[k] = right_m[k] = msum[k] = sub_msum[k] = 0.f;
  float left_ld = acc_ld, right_ld = acc_ld, prop_ld = acc_ld, sub_ld = acc_ld;
  float prop_w = 0.f, prop_slpa = 0.f, sub_w = 0.f, sub_slpa = 0.f, h0 = 0.f;
  float direction = 1.f, grads = 0.f;
  int depth = 0, leaf = 0, nstates = 0, steps = 0;
  bool done = true, div = false, turn = false;  // done: iteration 0 starts
  const int S = p.S;

  for (int it = 0; it < p.budget; ++it) {
    const bool live = steps < S;
    if (!kTrace && !live) break;  // a finished chain changes none of its outputs
    const uint32_t base_c0 = (uint32_t)chain * (uint32_t)S + (uint32_t)steps;

    // ---- inline restart: fresh momentum, trajectory reset ----
    const bool start = done && live;
    if (start) {
      const uint32_t c1 = (1u << 24) | base_c0;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int j = k * 32 + lane;
        uint32_t b1, b2;
        threefry2x32(p.seed, kKey1, (uint32_t)j, c1, b1, b2);
        const float u1 = ((float)(int)(b1 >> 8) + 1.0f) * kU24;
        const float u2 = to_unit(b2);
        const float sm = j < p.d ? p.sigma_m[j] : 0.f;
        cur_m[k] = (sm * sqrtf(-2.0f * logf(u1))) * cosf(kTwoPi * u2);
      }
      h0 = -acc_ld + kinetic<N>(cur_m, imm);
      copy<N>(cur_x, acc_x); copy<N>(cur_g, acc_g);
      copy<N>(left_x, acc_x); copy<N>(left_m, cur_m); copy<N>(left_g, acc_g);
      copy<N>(right_x, acc_x); copy<N>(right_m, cur_m); copy<N>(right_g, acc_g);
      copy<N>(msum, cur_m);
#pragma unroll
      for (int k = 0; k < N; ++k) sub_msum[k] = cur_m[k] * 0.f;
      copy<N>(prop_x, acc_x); copy<N>(prop_g, acc_g);
      copy<N>(sub_x, acc_x); copy<N>(sub_g, acc_g);
      left_ld = right_ld = prop_ld = sub_ld = acc_ld;
      prop_w = 0.f; prop_slpa = -INFINITY; sub_w = 0.f; sub_slpa = -INFINITY;
      depth = leaf = nstates = 0;
      div = turn = done = false;
    }
    const bool active = !done && live;

    // ---- subtree start: direction draw, continue from that end ----
    const bool at_start = leaf == 0 && active;
    if (at_start) {
      direction = counter_uniform(p.seed, base_c0, 2u, (uint32_t)depth) < 0.5f ? -1.f : 1.f;
      if (direction > 0.f) {
        copy<N>(cur_x, right_x); copy<N>(cur_m, right_m); copy<N>(cur_g, right_g);
      } else {
        copy<N>(cur_x, left_x); copy<N>(cur_m, left_m); copy<N>(cur_g, left_g);
      }
    }
    const bool fwd = direction > 0.f;

    // ---- one velocity-Verlet leaf ----
    const float d_eps = direction * p.eps;
    const float half = 0.5f * d_eps;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      new_m[k] = cur_m[k] + half * cur_g[k];
      new_x[k] = cur_x[k] + d_eps * (imm[k] * new_m[k]);
    }
    target_grad<N, F>(p, new_x, iv, new_g, lane, scratch);
#pragma unroll
    for (int k = 0; k < N; ++k) new_m[k] = new_m[k] + half * new_g[k];
    const float new_ld = target_logdensity<N, F>(p, new_x, iv, lane, scratch);
    const float energy = -new_ld + kinetic<N>(new_m, imm);
    float delta = h0 - energy;
    if (isnan(delta)) delta = -INFINITY;
    const float leaf_w = delta;
    const float leaf_slpa = delta < 0.f ? delta : 0.f;
    const bool leaf_div = -delta > p.threshold && active;

    // ---- progressive uniform merge within the subtree ----
    const float u_leaf = counter_uniform(p.seed, base_c0, 3u, (uint32_t)nstates);
    // sigmoid(NaN) is NaN and the comparison is false: no take
    const bool take = u_leaf < sigmoid(leaf_w - sub_w) && active;
    if (at_start || take) {
      copy<N>(sub_x, new_x); copy<N>(sub_g, new_g); sub_ld = new_ld;
    }
    if (at_start) {
      sub_w = leaf_w;
      sub_slpa = leaf_slpa;
      copy<N>(sub_msum, new_m);
    } else {
      sub_w = logaddexp(sub_w, leaf_w);
      sub_slpa = logaddexp(sub_slpa, leaf_slpa);
#pragma unroll
      for (int k = 0; k < N; ++k) sub_msum[k] = sub_msum[k] + new_m[k];
    }

    // ---- checkpointed subtree U-turn (termination.py:37-43) ----
    const int idx_max = __popc(leaf >> 1);
    bool subtree_turning = false;
    if (active) {
      if ((leaf & 1) == 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          ck_m[idx_max * slot + k * 32 + lane] = new_m[k];
          ck_s[idx_max * slot + k * 32 + lane] = sub_msum[k];
        }
      } else {
        const int idx_min = idx_max - __popc(((~leaf) & (leaf + 1)) - 1) + 1;
        for (int i = idx_min; i <= idx_max && !subtree_turning; ++i) {
          float ckm[N];
#pragma unroll
          for (int k = 0; k < N; ++k) {
            ckm[k] = ck_m[i * slot + k * 32 + lane];
            const float cks = ck_s[i * slot + k * 32 + lane];
            rho[k] = (sub_msum[k] - cks + ckm[k]) - 0.5f * (ckm[k] + new_m[k]);
          }
          subtree_turning = turning<N>(ckm, new_m, rho, imm);
        }
      }
    }

    // ---- subtree boundary: merge into the trajectory ----
    const bool aborted = leaf_div || subtree_turning;
    const bool closing = (leaf + 1 >= (1 << depth) || aborted) && active;
    bool full_turn = false, take_traj = false;
    const float u_prop = counter_uniform(p.seed, base_c0, 4u, (uint32_t)depth);
    if (closing) {
#pragma unroll
      for (int k = 0; k < N; ++k) msum[k] = msum[k] + sub_msum[k];
      if (fwd) {
        copy<N>(right_x, new_x); copy<N>(right_m, new_m); copy<N>(right_g, new_g);
        right_ld = new_ld;
      } else {
        copy<N>(left_x, new_x); copy<N>(left_m, new_m); copy<N>(left_g, new_g);
        left_ld = new_ld;
      }
      // biased merge toward the new subtree; an aborted subtree adds its
      // acceptance statistics only. min(NaN, 1) stays NaN, as jnp.minimum.
      const float ratio = expf(sub_w - prop_w);
      const float p_biased = ratio > 1.f ? 1.f : ratio;
      take_traj = u_prop < p_biased && !aborted;
      if (take_traj) {
        copy<N>(prop_x, sub_x); copy<N>(prop_g, sub_g); prop_ld = sub_ld;
      }
      if (!aborted) prop_w = logaddexp(prop_w, sub_w);
      prop_slpa = logaddexp(prop_slpa, sub_slpa);
#pragma unroll
      for (int k = 0; k < N; ++k) rho[k] = msum[k] - 0.5f * (left_m[k] + right_m[k]);
      full_turn = turning<N>(left_m, right_m, rho, imm);
      depth += 1;
      leaf = 0;
    } else {
      leaf += 1;
    }

    // ---- transition close ----
    div = div || leaf_div;
    turn = turn || (closing && (subtree_turning || full_turn));
    const bool done_new = div || turn || (closing && depth >= p.max_depth);
    if (active) nstates += 1;
    const bool just_closed = active && done_new;
    if (just_closed) {
      grads = grads + (float)nstates;
      copy<N>(acc_x, prop_x); copy<N>(acc_g, prop_g); acc_ld = prop_ld;
      // history row `steps` of the closed transition, from the proposal
      float* row = p.out_hist + ((size_t)chain * S + steps) * p.n_track;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int j = k * 32 + lane;
        if (j < p.n_track) row[j] = prop_x[k];
      }
      steps += 1;
    }
    if constexpr (kTrace) {
      if (it < p.trace) {
        const float cols[kTraceCols] = {
            (float)start, (float)at_start, direction, (float)depth, (float)leaf, delta,
            u_leaf, (float)take, sub_w, u_prop, (float)take_traj, prop_w, (float)closing,
            (float)done_new, energy, h0, __shfl_sync(kFull, new_x[0], 0), (float)aborted};
        float* out = p.out_trace + ((size_t)chain * p.trace + it) * kTraceCols;
        if (lane < kTraceCols) {
#pragma unroll
          for (int c = 0; c < kTraceCols; ++c)
            if (c == lane) out[c] = cols[c];
        }
      }
    }
    done = done_new || done;
    copy<N>(cur_x, new_x); copy<N>(cur_m, new_m); copy<N>(cur_g, new_g);
  }

#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    if (j < p.d) p.out_x[(size_t)chain * p.d + j] = acc_x[k];
  }
  if (lane == 0) {
    p.out_steps[chain] = steps;
    p.out_grads[chain] = grads;
  }
}

// A block asks for more than the 48 KB default of shared memory through the
// attribute; past the card's 227 KB the attribute or the launch is refused,
// and the error comes back to the wrapper, which raises.
template <int N, int F, bool kTrace>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)kWarps * (2 * p.max_depth * N * 32 + scratch_floats<N>()) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_kernel<N, F, kTrace>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.C + kWarps - 1) / kWarps;
  nuts_kernel<N, F, kTrace><<<blocks, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_target(const Params& p, cudaStream_t stream) {
  const bool traced = p.trace > 0;
  if (p.target == kLogisticRegression)
    return traced ? launch<N, kLogisticRegression, true>(p, stream)
                  : launch<N, kLogisticRegression, false>(p, stream);
  return traced ? launch<N, 0, true>(p, stream) : launch<N, 0, false>(p, stream);
}

}  // namespace

extern "C" {

// Runs the machine; returns cudaGetLastError() of the launch (0 = success).
// X (rows, d), Xt and y (rows,) are logistic regression's data and k0, k1 its
// 1 / prior_scale^2 and -0.5 / prior_scale^2 (null and 0 otherwise).
// trace_cols must be the wrapper's len(TRACE_COLS).
int bjt_fused_nuts(const float* x0, const float* imm, const float* sigma_m,
                   const float* inv_var, const float* X, const float* Xt, const float* y,
                   float* out_x, int* out_steps, float* out_grads, float* out_hist,
                   float* out_trace, int C, int d, int S, int n_track, int max_depth,
                   int budget, int trace, int target, int rows, int trace_cols, float eps,
                   float threshold, float k0, float k1, uint32_t seed, void* stream) {
  Params p{x0, imm, sigma_m, inv_var, out_x, out_steps, out_grads, out_hist, out_trace,
           C, d, S, n_track, max_depth, budget, trace, target, eps, threshold,
           seed, {X, Xt, y, nullptr, rows, d, {k0, k1}}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target != kHierarchical && target != kGaussian && target != kLogisticRegression)
    return cudaErrorInvalidValue;
  if (target == kGaussian && inv_var == nullptr) return cudaErrorInvalidValue;
  if (target == kLogisticRegression && (X == nullptr || Xt == nullptr || y == nullptr))
    return cudaErrorInvalidValue;
  if (trace_cols != kTraceCols || (trace > 0 && out_trace == nullptr) || n_track > d ||
      max_depth < 1 || max_depth > 30)
    return cudaErrorInvalidValue;
  if (C <= 0) return cudaSuccess;
  const int n = (d + 31) / 32;
  if (n <= 1) return launch_target<1>(p, s);
  if (n <= 2) return launch_target<2>(p, s);
  if (n <= 4) return launch_target<4>(p, s);
  if (n <= 8) return launch_target<8>(p, s);
  return cudaErrorInvalidValue;
}

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
