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
// every lane. Two forms run the machine; the wrapper picks one before the
// launch (ops/fused_nuts.py:plan).
//
// The resident form (nuts_resident, a template on the analytic target T)
// runs the hierarchical and Gaussian targets without a trace, as the dc
// machine's resident form runs them (csrc/fused_nuts_dc.cuh, whose pieces it
// shares through resident_form.cuh). One warp a block, built for
// resident_warps<N>() warps an SM, so that a finished chain's slot takes the
// next chain at once: the launch ends with its slowest chain. It keeps in
// registers only the leaf's x, m and g (updated in place), the subtree's
// momentum sum, M^{-1} and the Gaussian's inverse variances; the accepted
// state, the proposal, the trajectory's two ends and its momentum sum live in
// a per-chain scratch in device memory (ColdVec, 6.5 KB a chain at N = 4,
// which stays in L2), and the checkpoint slots and the subtree's sample in
// shared memory where the SM's warps fit them (resident_slots_shared), else
// beside the rest. A leaf draws one threefry block before its gradient, so
// that its rounds overlap it: the merge's uniform (tag 3) or, on a subtree's
// first leaf, which merges nothing, the next subtree's direction (tag 2) on
// the even lanes and its proposal uniform (tag 4) on the odd ones, each the
// block's first word; the restart draws depth 0's pair the same way. The
// energy's sum (and the Gaussian's log density's) and every U-turn check's
// sums run their butterflies side by side (the reference ORs every slot's
// check); the hierarchical target sums theta^2 once for its gradient and its
// log density. A subtree that continues in the last one's direction starts
// from the registers. Every sum keeps its order and every draw its key, so
// the two forms' outputs are the same bits.
//
// The registers form (nuts_kernel) runs the rest: the trace, and logistic
// regression. Four chains a block; 23 length-d vectors in registers; the
// 2 * max_depth checkpoint slots, indexed by a data-dependent slot id, live
// in shared memory (each lane touches only its own dims), beside logistic
// regression's per-warp scratch.
//
// Bound. A leaf is O(d) FP32 work (leapfrog, energy, up to max_depth slot
// checks), a gradient and a log density, exp/log/cos and a few threefry
// blocks; device memory sees the initial positions, a history row per closed
// transition and the final state. It is bound by FP32/SFU throughput and the
// latency of its shuffle reductions, not by bytes; logistic regression adds
// its contractions with X from L2 (matrix_targets.cuh). What sets the
// resident form's time is its slowest chain: its leaves run one after the
// other, at about 1,800 cycles a leaf when it is alone on the card and about
// twice that while its SM is full (PERF.md §6).
//
// Numerics. Build without --use_fast_math and with --fmad=false: expf, logf,
// cosf, sqrtf and log1pf are the accurate library versions and no multiply-add
// is contracted, so the kernel rounds like the plain PyTorch version except for
// the order of its sums and the last ulp of the transcendentals.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "counter_rng.cuh"     // threefry2x32, to_unit, kKey1, kU24, kTwoPi
#include "matrix_targets.cuh"  // warp_sum, logaddexp, sigmoid, target_grad, target_logdensity
#include "resident_form.cuh"   // ColdVec, copy, warp_sums, slots_fit_shared, occupancy_of

namespace {

constexpr int kWarps = 4;  // chains per block of the registers form
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
  float* cold;           // resident form: (C, resident_cold_floats) scratch, else null
  float* slots;          // resident form: (C, slot_floats) where not in shared memory
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

// ---------------------------------------------------------------------------
// The resident form: the analytic targets without a trace, N <= 8 (see the
// head of this file)
// ---------------------------------------------------------------------------

// warps a block of the resident form: a block holds its SM's resources
// until its last warp ends, so that with one warp a finished chain's slot
// takes the next chain at once.
constexpr int kResidentBlockWarps = 1;

// warps an SM that the resident form's instantiations are built to hold:
// their __launch_bounds__ ask for resident_warps / kResidentBlockWarps
// blocks an SM, which caps a thread at 65,536 / (32 resident_warps)
// registers. Picked by measurement (dc_kernel_ms.py --machine older --warps:
// PERF.md §6).
template <int N>
__host__ __device__ constexpr int resident_warps() { return N <= 2 ? 24 : N == 4 ? 20 : 16; }

// the chain's vectors that the resident form keeps in device memory, by
// index: the accepted state, the proposal, the trajectory's two ends, the
// subtree's sample (where the slots do not fit in shared memory) and the
// trajectory's momentum sum
enum ResidentVec {
  kAccX, kAccG, kPropX, kPropG, kLeftX, kLeftM, kLeftG, kRightX, kRightM, kRightG,
  kSubX, kSubG, kMsum, kResidentVectors
};

// floats of a chain's scratch in device memory for those vectors
template <int N>
__host__ __device__ constexpr int resident_cold_floats() { return kResidentVectors * N * 32; }

// floats of a chain's checkpoint slots: m and msum at each of max_depth levels
template <int N>
__host__ __device__ constexpr int slot_floats(int max_depth) { return 2 * max_depth * N * 32; }

// floats of a resident warp's shared memory when its slots live there: the
// subtree's sample (x and g) and the slots
template <int N>
__host__ __device__ constexpr int resident_shared_floats(int max_depth) {
  return 2 * N * 32 + slot_floats<N>(max_depth);
}

// whether the resident form keeps the warps' slots and the subtrees' samples
// in shared memory: where the resident_warps of an SM fit them
template <int N>
__host__ __device__ constexpr bool resident_slots_shared(int max_depth) {
  return slots_fit_shared(resident_warps<N>(), kResidentBlockWarps,
                          resident_shared_floats<N>(max_depth));
}

// a resident block's dynamic shared memory
template <int N>
__host__ __device__ constexpr size_t resident_block_bytes(int max_depth) {
  return resident_slots_shared<N>(max_depth)
             ? (size_t)kResidentBlockWarps * resident_shared_floats<N>(max_depth) * sizeof(float)
             : 0;
}

// the registers form's block: each of the kWarps warps' slots and logistic
// regression's scratch
template <int N>
__host__ __device__ constexpr size_t registers_block_bytes(int max_depth) {
  return (size_t)kWarps * (slot_floats<N>(max_depth) + scratch_floats<N>()) * sizeof(float);
}

// The analytic target T's gradient (grad() of analytic_targets.cuh) and what
// the leaf needs of its log density: the hierarchical target's log density
// (logdensity(), from the same theta^2, summed once), or the Gaussian's
// lane part of its sum, whose butterfly runs beside the energy's.
template <int N, int T>
__device__ __forceinline__ float resident_grad(const Params& p, const float (&x)[N],
                                               const float (&iv)[N], float (&g)[N], int lane) {
  if constexpr (T == kHierarchical) {
    const float log_tau = __shfl_sync(kFull, x[0], 0);
    const float exp_neg = expf(-log_tau);
    const float ts = theta_sq<N>(p, x, lane);
    const float half_n_theta = 0.5f * (float)(p.d - 1);
    const float g_tau = -log_tau + 0.5f * ts * exp_neg - half_n_theta;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int j = k * 32 + lane;
      const float is_tau = j == 0 ? 1.f : 0.f;
      const float theta_mask = (j >= 1 && j < p.d) ? 1.f : 0.f;
      g[k] = is_tau * g_tau + -(x[k] * theta_mask) * exp_neg;
    }
    return -0.5f * (log_tau * log_tau) - 0.5f * ts * exp_neg - half_n_theta * log_tau;
  } else {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      g[k] = -x[k] * iv[k];
      s += x[k] * x[k] * iv[k];
    }
    return s;
  }
}

// the lane's parts of turning() against checkpoint slot i, before their
// butterflies: rho = (sub_msum - ckpt_sum + ckpt_m) - 0.5 (ckpt_m + m)
template <int N>
__device__ __forceinline__ void slot_parts(float* slots, int i, const float (&imm)[N],
                                           const float (&sub_msum)[N], const float (&m)[N],
                                           float& a, float& b) {
  const float* ck = slot_level<N, 2>(slots, i);
  a = 0.f;
  b = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float ckm = ck[k * 32];
    const float cks = ck[(N + k) * 32];
    const float rho = (sub_msum[k] - cks + ckm) - 0.5f * (ckm + m[k]);
    a += (imm[k] * ckm) * rho;
    b += (imm[k] * m[k]) * rho;
  }
}

// the direction's block (tag 2) on the even lanes and the proposal's (tag
// 4) on the odd ones, both at depth: their first words, from lanes 0 and 1
__device__ __forceinline__ uint32_t subtree_counter(int lane, int depth) {
  return ((lane & 1) ? 4u << 24 : 2u << 24) | (uint32_t)depth;
}

// The machine of nuts_kernel (without kTrace) for the analytic target T, in
// the resident form: the same transitions, draws and sums, in the order that
// shortens a leaf's dependent chains.
template <int N, int T>
__global__ void __launch_bounds__(kResidentBlockWarps * 32,
                                  resident_warps<N>() / kResidentBlockWarps)
    nuts_resident(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chain = blockIdx.x * kResidentBlockWarps + warp;
  if (chain >= p.C) return;  // resident
  constexpr int V = N * 32;  // floats of a vector
  // the warp's shared memory, where it fits: [subtree's x] [subtree's g] [slots]
  const bool shared = resident_slots_shared<N>(p.max_depth);
  float* const cold = p.cold + (size_t)chain * resident_cold_floats<N>() + lane;
  const auto vec = [&](int i) { return ColdVec<N>{cold + i * V}; };
  ColdVec<N> acc_x = vec(kAccX), acc_g = vec(kAccG), prop_x = vec(kPropX), prop_g = vec(kPropG);
  ColdVec<N> left_x = vec(kLeftX), left_m = vec(kLeftM), left_g = vec(kLeftG);
  ColdVec<N> right_x = vec(kRightX), right_m = vec(kRightM), right_g = vec(kRightG);
  ColdVec<N> msum = vec(kMsum);
  float* const own =
      smem + (size_t)warp * (shared ? resident_shared_floats<N>(p.max_depth) : 0) + lane;
  ColdVec<N> sub_x{shared ? own : cold + kSubX * V};
  ColdVec<N> sub_g{shared ? own + V : cold + kSubG * V};
  // the checkpoint slots, level by level (slot_level)
  float* const slots =
      shared ? own + 2 * V : p.slots + (size_t)chain * slot_floats<N>(p.max_depth) + lane;

  // one set of the leaf's vectors, updated in place: the leaf starts from
  // x, m, g and leaves its new state there
  float imm[N], iv[N], x[N], m[N], g[N], sub_msum[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int j = k * 32 + lane;
    const bool valid = j < p.d;
    x[k] = valid ? p.x0[(size_t)chain * p.d + j] : 0.f;
    imm[k] = valid ? p.imm[j] : 0.f;
    iv[k] = (T == kGaussian && valid) ? p.inv_var[j] : 0.f;
  }
  float acc_ld = resident_grad<N, T>(p, x, iv, g, lane);
  if constexpr (T == kGaussian) acc_ld = -0.5f * warp_sum(acc_ld);
  copy<N>(acc_x, x); copy<N>(acc_g, g);

  float prop_ld = 0.f, sub_ld = 0.f, prop_w = 0.f, sub_w = 0.f, h0 = 0.f;
  float direction = 1.f, grads = 0.f;
  // the subtree's proposal uniform and the next subtree's two words (its
  // direction's and its proposal's)
  uint32_t u_prop = 0u, u_next_dir = 0u, u_next_prop = 0u;
  int depth = 0, leaf = 0, nstates = 0, steps = 0;
  // iteration 0 starts with done = 1, so it opens the first transition;
  // prop_new: the proposal has moved off the accepted state this transition
  bool done = true, div = false, turn = false, prop_new = false;
  const int S = p.S;
  for (int it = 0; it < p.budget; ++it) {  // resident
    if (steps >= S) break;  // a finished chain changes none of its outputs
    const uint32_t base_c0 = (uint32_t)chain * (uint32_t)S + (uint32_t)steps;

    if (done) {
      // ---- inline restart: fresh momentum, trajectory reset ----
      // The subtree's sample is set at its first leaf, and the proposal
      // stays the accepted state until a subtree is taken, so neither is
      // copied.
      const uint32_t c1 = (1u << 24) | base_c0;
      float e = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int j = k * 32 + lane;
        uint32_t b1, b2;
        threefry2x32(p.seed, kKey1, (uint32_t)j, c1, b1, b2);
        const float u1 = ((float)(int)(b1 >> 8) + 1.0f) * kU24;
        const float u2 = to_unit(b2);
        const float sm = j < p.d ? p.sigma_m[j] : 0.f;
        m[k] = (sm * sqrtf(-2.0f * logf(u1))) * cosf(kTwoPi * u2);
        e += (m[k] * imm[k]) * m[k];
      }
      uint32_t w, unused;
      threefry2x32(p.seed, kKey1, base_c0, subtree_counter(lane, 0), w, unused);  // depth 0's
      u_next_dir = __shfl_sync(kFull, w, 0);
      u_next_prop = __shfl_sync(kFull, w, 1);
      h0 = -acc_ld + 0.5f * warp_sum(e);
      copy<N>(x, acc_x); copy<N>(g, acc_g);
      copy<N>(left_x, x); copy<N>(left_m, m); copy<N>(left_g, g);
      copy<N>(right_x, x); copy<N>(right_m, m); copy<N>(right_g, g);
      copy<N>(msum, m);
      prop_ld = acc_ld;
      prop_w = 0.f;
      prop_new = false;
      depth = leaf = nstates = 0;
      div = turn = done = false;
    }

    // ---- subtree start: direction, continue from that end ----
    // The direction's and the proposal's words were drawn ahead: by the
    // restart for depth 0, by the previous subtree's first leaf for the
    // others. x, m, g hold the end that the last subtree closed on (at depth
    // 0 both ends hold what the restart left there), so only a turn of
    // direction reads the other end.
    const bool at_start = leaf == 0;
    if (at_start) {
      u_prop = u_next_prop;
      const float last = direction;
      direction = to_unit(u_next_dir) < 0.5f ? -1.f : 1.f;
      if (depth > 0 && direction != last) {
        if (direction > 0.f) {
          copy<N>(x, right_x); copy<N>(m, right_m); copy<N>(g, right_g);
        } else {
          copy<N>(x, left_x); copy<N>(m, left_m); copy<N>(g, left_g);
        }
      }
    }
    const bool fwd = direction > 0.f;

    // ---- one velocity-Verlet leaf (resident) ----
    // one threefry block, drawn before the gradient so that its rounds
    // overlap it: the merge's uniform (tag 3, nstates), or, on a subtree's
    // first leaf, which merges nothing, the next subtree's pair
    uint32_t u_leaf, u_unused;
    threefry2x32(p.seed, kKey1, base_c0,
                 at_start ? subtree_counter(lane, depth + 1) : (3u << 24) | (uint32_t)nstates,
                 u_leaf, u_unused);
    const uint32_t next_dir = __shfl_sync(kFull, u_leaf, 0);
    const uint32_t next_prop = __shfl_sync(kFull, u_leaf, 1);
    const float d_eps = direction * p.eps;
    const float half = 0.5f * d_eps;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      m[k] = m[k] + half * g[k];
      x[k] = x[k] + d_eps * (imm[k] * m[k]);
    }
    const float ld_part = resident_grad<N, T>(p, x, iv, g, lane);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      m[k] = m[k] + half * g[k];
      sub_msum[k] = at_start ? m[k] : sub_msum[k] + m[k];
    }
    if (at_start) {
      u_next_dir = next_dir;
      u_next_prop = next_prop;
    }

    // ---- the energy and the U-turn checks' sums (resident) ----
    // Even leaves store (m, sub_msum) at slot idx_max; odd leaves check the
    // slots idx_min..idx_max of the subtrees that end at this leaf, all of
    // them (the reference ORs every slot's check). The energy's sum (and
    // the Gaussian's log density's) and the two newest slots' four sums run
    // their butterflies together; older slots follow two at a time.
    constexpr int E = T == kGaussian ? 2 : 1;  // the energy's and the log density's sums
    const int idx_max = __popc(leaf >> 1);
    float s[E + 4] = {};
#pragma unroll
    for (int k = 0; k < N; ++k) s[0] += (m[k] * imm[k]) * m[k];
    if constexpr (T == kGaussian) s[1] = ld_part;
    bool subtree_turning = false;
    if ((leaf & 1) == 0) {
      float* ck = slot_level<N, 2>(slots, idx_max);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        ck[k * 32] = m[k];
        ck[(N + k) * 32] = sub_msum[k];
      }
      warp_sums<E>(reinterpret_cast<float(&)[E]>(s));
    } else {
      const int idx_min = idx_max - __popc(((~leaf) & (leaf + 1)) - 1) + 1;
      const bool two = idx_max > idx_min;
      slot_parts<N>(slots, idx_max, imm, sub_msum, m, s[E], s[E + 1]);
      if (two) slot_parts<N>(slots, idx_max - 1, imm, sub_msum, m, s[E + 2], s[E + 3]);
      warp_sums<E + 4>(s);
      subtree_turning = s[E] <= 0.f || s[E + 1] <= 0.f ||
                        (two && (s[E + 2] <= 0.f || s[E + 3] <= 0.f));
      for (int i = idx_max - 2; i >= idx_min; i -= 2) {
        const bool pair = i > idx_min;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        slot_parts<N>(slots, i, imm, sub_msum, m, t[0], t[1]);
        if (pair) slot_parts<N>(slots, i - 1, imm, sub_msum, m, t[2], t[3]);
        warp_sums<4>(t);
        subtree_turning = subtree_turning || t[0] <= 0.f || t[1] <= 0.f ||
                          (pair && (t[2] <= 0.f || t[3] <= 0.f));
      }
    }
    const float new_ld = T == kGaussian ? -0.5f * s[E - 1] : ld_part;
    const float energy = -new_ld + 0.5f * s[0];
    float delta = h0 - energy;
    if (isnan(delta)) delta = -INFINITY;
    const float leaf_w = delta;
    const bool leaf_div = -delta > p.threshold;

    // ---- progressive uniform merge within the subtree (resident) ----
    // the subtree's first leaf is its sample; sigmoid(NaN) is NaN and the
    // comparison is false: no take
    {
      const float p_acc = sigmoid(leaf_w - sub_w);
      const float merged_w = logaddexp(sub_w, leaf_w);
      if (at_start || to_unit(u_leaf) < p_acc) {
        copy<N>(sub_x, x); copy<N>(sub_g, g);
        sub_ld = new_ld;
      }
      sub_w = at_start ? leaf_w : merged_w;
    }

    // ---- subtree boundary: merge into the trajectory (resident) ----
    const bool aborted = leaf_div || subtree_turning;
    const bool closing = leaf + 1 >= (1 << depth) || aborted;
    bool full_turn = false;
    if (closing) {
      // the leaf becomes the end on its side; the full tree's check reads
      // the other end from device memory
      float ab[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float ms = msum[k] + sub_msum[k];
        msum[k] = ms;
        float lm, rm;
        if (fwd) {
          right_x[k] = x[k]; right_m[k] = m[k]; right_g[k] = g[k];
          lm = left_m[k];
          rm = m[k];
        } else {
          left_x[k] = x[k]; left_m[k] = m[k]; left_g[k] = g[k];
          lm = m[k];
          rm = right_m[k];
        }
        const float rho = ms - 0.5f * (lm + rm);
        ab[0] += (imm[k] * lm) * rho;
        ab[1] += (imm[k] * rm) * rho;
      }
      // biased merge toward the new subtree; an aborted subtree adds nothing.
      // min(NaN, 1) stays NaN, as jnp.minimum.
      const float ratio = expf(sub_w - prop_w);
      const float p_biased = ratio > 1.f ? 1.f : ratio;
      if (to_unit(u_prop) < p_biased && !aborted) {
        copy<N>(prop_x, sub_x); copy<N>(prop_g, sub_g);
        prop_ld = sub_ld;
        prop_new = true;
      }
      if (!aborted) prop_w = logaddexp(prop_w, sub_w);
      warp_sums<2>(ab);
      full_turn = ab[0] <= 0.f || ab[1] <= 0.f;
      depth += 1;
      leaf = 0;
    } else {
      leaf += 1;
    }

    // ---- transition close (resident) ----
    div = div || leaf_div;
    turn = turn || (closing && (subtree_turning || full_turn));
    done = div || turn || (closing && depth >= p.max_depth);
    nstates += 1;
    if (done) {
      grads = grads + (float)nstates;
      if (prop_new) {
        copy<N>(acc_x, prop_x); copy<N>(acc_g, prop_g);
      }
      acc_ld = prop_ld;
      // history row `steps` of the closed transition, from the accepted state
      float* row = p.out_hist + ((size_t)chain * S + steps) * p.n_track;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int j = k * 32 + lane;
        if (j < p.n_track) row[j] = acc_x[k];
      }
      steps += 1;
    }
  }

  // ---- final state (resident) ----
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

template <int N, int T>
cudaError_t launch_resident(const Params& p, cudaStream_t stream) {
  const bool shared = resident_slots_shared<N>(p.max_depth);
  if (p.cold == nullptr || (!shared && p.slots == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = resident_block_bytes<N>(p.max_depth);
  const auto kernel = nuts_resident<N, T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       carveout_for(shared));
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int blocks = (p.C + kResidentBlockWarps - 1) / kResidentBlockWarps;
  kernel<<<blocks, kResidentBlockWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The registers form's launch, and the form's dispatch
// ---------------------------------------------------------------------------

// A block asks for more than the 48 KB default of shared memory through the
// attribute; past the card's 227 KB the attribute or the launch is refused,
// and the error comes back to the wrapper, which raises.
template <int N, int F, bool kTrace>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = registers_block_bytes<N>(p.max_depth);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nuts_kernel<N, F, kTrace>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.C + kWarps - 1) / kWarps;
  const auto kernel = nuts_kernel<N, F, kTrace>;
  kernel<<<blocks, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// the instantiation for the target in the form the wrapper chose (resident:
// the analytic targets without a trace)
template <int N>
cudaError_t launch_target(const Params& p, bool resident, cudaStream_t stream) {
  if (resident)
    return p.target == kHierarchical ? launch_resident<N, kHierarchical>(p, stream)
                                     : launch_resident<N, kGaussian>(p, stream);
  const bool traced = p.trace > 0;
  if (p.target == kLogisticRegression)
    return traced ? launch<N, kLogisticRegression, true>(p, stream)
                  : launch<N, kLogisticRegression, false>(p, stream);
  return traced ? launch<N, 0, true>(p, stream) : launch<N, 0, false>(p, stream);
}

// calls fn with the instantiation's N for d as a std::integral_constant,
// or returns fail where no instantiation takes d
template <class Fn, class R>
R for_width(int d, Fn fn, R fail) {
  const int n = (d + 31) / 32;
  if (d < 1) return fail;
  if (n <= 1) return fn(std::integral_constant<int, 1>{});
  if (n <= 2) return fn(std::integral_constant<int, 2>{});
  if (n <= 4) return fn(std::integral_constant<int, 4>{});
  if (n <= 8) return fn(std::integral_constant<int, 8>{});
  return fail;
}

}  // namespace

extern "C" {

// Runs the machine; returns cudaGetLastError() of the launch (0 = success).
// X (rows, d), Xt and y (rows,) are logistic regression's data and k0, k1 its
// 1 / prior_scale^2 and -0.5 / prior_scale^2 (null and 0 otherwise).
// trace_cols must be the wrapper's len(TRACE_COLS). form 1 launches the
// resident form (the analytic targets, trace 0), with cold and slots each
// chain's scratch in device memory (bjt_fused_nuts_scratch_floats a chain;
// null where it is 0); form 0 the registers form.
int bjt_fused_nuts(const float* x0, const float* imm, const float* sigma_m,
                   const float* inv_var, const float* X, const float* Xt, const float* y,
                   float* out_x, int* out_steps, float* out_grads, float* out_hist,
                   float* out_trace, float* cold, float* slots, int C, int d, int S,
                   int n_track, int max_depth, int budget, int trace, int target, int rows,
                   int trace_cols, int form, float eps, float threshold, float k0, float k1,
                   uint32_t seed, void* stream) {
  Params p{x0, imm, sigma_m, inv_var, out_x, out_steps, out_grads, out_hist, out_trace,
           cold, slots, C, d, S, n_track, max_depth, budget, trace, target, eps, threshold,
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
  if (form != 0 && (form != 1 || trace > 0 || target == kLogisticRegression))
    return cudaErrorInvalidValue;
  if (C <= 0) return cudaSuccess;
  return for_width(d, [&](auto width) {
    return launch_target<decltype(width)::value>(p, form == 1, s);
  }, cudaErrorInvalidValue);
}

// a chain's floats of scratch in device memory that a launch in the form
// reads and writes, which the wrapper allocates: out[0] the cold vectors,
// out[1] the checkpoint slots (where they do not fit in shared memory);
// returns -1 where no instantiation takes d
int bjt_fused_nuts_scratch_floats(int d, int form, int max_depth, long long* out) {
  return for_width(d, [&](auto width) {
    constexpr int N = decltype(width)::value;
    out[0] = form ? resident_cold_floats<N>() : 0;
    out[1] = form && !resident_slots_shared<N>(max_depth) ? slot_floats<N>(max_depth) : 0;
    return 0;
  }, -1);
}

// the analytic target's instantiation for d in the form (1: resident) at
// max_depth: out[0] its resident warps an SM, out[1] its registers a
// thread, out[2] its local memory a thread in bytes (spills); returns the
// CUDA error code
int bjt_fused_nuts_occupancy(int d, int target, int form, int max_depth, int* out) {
  if (target != kHierarchical && target != kGaussian) return cudaErrorInvalidValue;
  return for_width(d, [&](auto width) {
    constexpr int N = decltype(width)::value;
    if (form) {
      const size_t smem = resident_block_bytes<N>(max_depth);
      const int carveout = carveout_for(resident_slots_shared<N>(max_depth));
      return (int)(target == kHierarchical
                       ? occupancy_of(nuts_resident<N, kHierarchical>, kResidentBlockWarps,
                                      smem, out, carveout)
                       : occupancy_of(nuts_resident<N, kGaussian>, kResidentBlockWarps, smem,
                                      out, carveout));
    }
    return (int)occupancy_of(nuts_kernel<N, 0, false>, kWarps,
                             registers_block_bytes<N>(max_depth), out);
  }, (int)cudaErrorInvalidValue);
}

const char* bjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
