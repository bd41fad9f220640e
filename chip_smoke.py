"""Smoke test of blackjax_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It drives the port's thirteen main paths once, five at the flagship's full
width (the 100-dim hierarchical posterior, 4,096 chains), one at the
Finnish horseshoe's (N=100, M=200, d=404, 512 chains), three at the
covertype-class logistic regression's (4,096 x 54; 1,024 chains under NUTS,
4,096 under MCLMC), one at the tracked eight-schools configuration's
(d=10, 512 chains x 800 transitions), one at the tracked tempered-SMC
configuration's (d=10, 16,384 particles), one at the tracked static-HMC
configuration's (d=100, 128 chains) under the MCMC family beyond NUTS and
one at the tracked SG-MCMC configurations' (SGLD on the covertype-class
logistic regression, one chain and 4,096 chains), and reads the card's
FP32 roofline through which their bounds are read, and checks them in
phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the builds of
   ``csrc/fused_nuts_dc.cu``, ``csrc/fused_nuts_dc_dense.cu``,
   ``csrc/fused_nuts_dc_low_rank.cu`` (the dc machine of
   ``csrc/fused_nuts_dc.cuh`` for each metric), ``csrc/fused_leapfrog.cu``,
   ``csrc/fused_mclmc.cu``, ``csrc/fused_nuts.cu`` and ``csrc/vpu_peak.cu``
   (with the shared headers ``csrc/counter_rng.cuh``,
   ``csrc/analytic_targets.cuh``, ``csrc/matrix_targets.cuh`` and
   ``csrc/resident_form.cuh``) with nvcc, one process each, all started
   together, with their seconds and the register and spill report of each
   instantiation (N registers per vector, target family F, metric M, trace
   flag; a resident form by its analytic target T; the VPU-peak kernel by
   N, its rounding and its mode). Then the VPU-peak kernel
   (``ops.vpu_peak``, the port of ``benchmarks/vpu_peak.py:58``): in both
   modes (``fma``: ``x = x * a + b``; ``select``: ``x = where(x > t, x * a +
   b, x + b)``) and both roundings of ``x * a + b`` (fused, one rounding;
   unfused, a multiply and an add, as ``--fmad=false`` compiles it), at
   every N values a lane (1, 2, 4, 8, 13, 16) and 20 and 32 warps an SM,
   on a full grid and a partial block, bit for bit its plain version after
   64 iterations, and the kernels line's call (unfused ``fma``, N = 4, 32
   warps, 4,096 iterations) bit for bit its plain version; then, launch
   counts reset, its sustained element-updates a second at each mode,
   rounding and N at 20 and 32 warps an SM (a two-point slope, ``iters``
   against ``4 * iters``, by CUDA events, distinct inputs for each call, as
   the reference's ``measure`` reads it), each as a share of the spec rate
   (one FMA a lane a clock), and the SM clock ``nvidia-smi`` reads under
   load. Twice the unfused ``fma`` rate at the N nearest a kernel's own,
   the better of the two warp counts, is the measured FP32 operation rate
   of the kernels line's ``bound_measured_ms``;
2. the dc kernel's own threefry2x32 device function against the plain
   version, bit for bit, on 100,000 counters, and with a key per element
   (the draws of ``blackjax_tpu_torch.prng``) on 1,048,576 keys, with both
   times; and the MCLMC kernel's counter normals (4,096 chains x 100 dims):
   the threefry words bit for bit, the normals to 1e-6 (``logf`` and
   ``cosf`` may differ from torch by an ulp);
3. the dc NUTS machine against its plain PyTorch version on the card at
   d=100, 4,096 chains, 16 transitions: identical step counts, the share of
   chains that agree to 1e-5 above the CPU test's floor, pooled moments, and
   both times;
4. the NUTS path, launch counts reset just before it: the port's
   single-chain ``window_adaptation(nuts)`` (400 steps, as ``bench.py``
   adapts; its ms per leaf beside the figure before the keyed draws), then
   the port's NUTS for 5 transitions from a numpy-seeded init
   on the adapted step size and metric, then ``fused_nuts_run_dc`` for 256
   transitions, then min-ESS; every chain must complete, everything must be
   finite, the kernel must have been launched in the resident form (all
   chains' state and slots out of registers, the SM's warps at the
   instantiation's launch bound), and ``log_tau``'s moments over the second
   half must match its N(0, 1) marginal. The line gives the launch's bound
   (as phase 3's) and kernel / bound, the per-chain iterations (max, p99,
   mean, from a second launch on the same inputs), the instantiation's
   resident warps an SM, registers and local memory
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the form. Then, for the
   comparison only, the kernel once more and its plain version on the first
   512 chains for 16 transitions (draws are keyed on the call's
   ``num_steps``, so the plain version is held against a call of its own
   length);
5. the fused leapfrog kernel against its plain version on the card at
   d=100, 4,096 chains, 10 steps, for both targets: the share of chains
   whose positions, momenta and energy agree to 1e-5 (floor 0.99), the
   largest difference, both times per call by CUDA events, and the
   kernel's device time per launch by torch.profiler; then the HMC
   transition kernel (``hmc_transition`` in ``csrc/fused_leapfrog.cu``, a
   whole ``fused_hmc`` transition in one launch) against its plain version
   on the same inputs and draws: the share of chains whose positions, log
   densities and p_accept agree to 1e-5 with the same accept flag (floor
   0.99), both times per call by CUDA events, the kernel's device time by
   torch.profiler and its bound;
6. the HMC path, launch counts reset just before it: the port's
   ``window_adaptation(hmc)`` over all 4,096 chains (pooled, 10 leapfrog
   steps, 400 steps), then ``fused_hmc`` for 1,000 transitions (one launch
   of the transition kernel each, beside the two draws), then min-ESS over
   8 tracked coordinates; everything must be finite, all 1,000 transitions
   in the transition form, the mean acceptance in [0.5, 0.99], and
   ``log_tau``'s second-half moments near N(0, 1); the line gives the
   milliseconds a transition;
7. the MCLMC kernel in its resident form against its plain version on the
   card at d=100, 4,096 chains, 64 steps, for both targets with the refresh
   off and on: the share of chains whose positions, momenta, log density and
   history agree to 1e-5 (floor 0.9), the largest difference and how it
   grows with depth (to 512 steps), the resident form's outputs against the
   registers form's bit for bit on the first 512 chains, the times per call
   of both forms and the plain version by CUDA events, and the kernel's
   device time by torch.profiler;
8. the MCLMC path, launch counts reset just before it: the port's
   single-chain ``mclmc_find_L_and_step_size`` (2,000 steps' worth: 200 +
   266 + 200 tuning steps), then the port's ``mclmc`` for 5 transitions over
   the numpy-seeded init of phase 4, then ``fused_mclmc`` for 1,000 steps
   (one launch, which must take the resident form), then min-ESS over 8
   tracked coordinates; everything must be finite, momenta unit-norm to
   1e-5, ``log_tau``'s second-half moments near N(0, 1), and the registers
   form on the same inputs the same bits; the line gives the form's warps
   an SM, registers, local memory and steps a pool, both forms' times, and
   the launch's bound, also with Box-Muller's transcendentals counted, and
   kernel / bound;
9. each new (kernel, target) pair against its plain version on the card:
   the dc machine on eight schools (d=10, 512 chains, in the form the plan
   picks: one chain a warp, the registers form) and on logistic
   regression at the covertype-class shape (4,096 points x 54, numpy seed,
   512 chains), the fused leapfrog (4,096 chains, 10 steps) and the fused
   MCLMC (4,096 chains, 64 steps, all 54 coordinates tracked, as phase 14
   tracks them) on the same logistic regression. The dc
   machine's steps must be identical, the share of chains agreeing to
   MATRIX_TOL above the floor, and every chain that agrees must take the same
   gradient count (so the totals are identical wherever every chain agrees;
   a chain that parts beyond MATRIX_TOL may turn at another leaf): its
   contractions sum row by row where the plain version's cuBLAS sums in
   tiles, and the difference
   grows along a trajectory to ~1.5e-4 in 4 transitions, as it does between
   the plain version on the card and on the CPU; the fused kernels are held
   as in phases 5 and 7, and each must launch once in the tiles form (the
   block's chains sharing each gradient, X streamed through shared memory in
   tiles; its chains a block, rows a tile and bytes are printed). Each
   prints both times by CUDA events, the kernel's device time by
   torch.profiler ("not measured" where the trace lost kernel records) and
   the card. The dc machine's logistic
   regression must launch in the tiles form (the block's eight chains in
   lockstep, sharing tiles of X streamed through shared memory); its line
   gives the kernel's time against its bound and their ratio, the share of
   warp-iterations in which a warp of the lockstep was not live, and the
   leaves per transition. The horseshoe's pair is held
   after phase 10, on its adapted step size and metric: from an unadapted
   start every horseshoe tree diverges at its first leaf;
10. the horseshoe path, launch counts reset just before it: the port's
   single-chain ``window_adaptation(nuts, finnish_horseshoe())`` from zeros,
   then ``fused_nuts_run_dc`` on 512 chains from 0.05 N(0, I) (numpy seed)
   for 128 transitions at the tracked configuration's v6 settings
   (``max_num_doublings=10``, ``pack=4``, ``restart_every=16``, ``chunk=256``,
   a budget of 1600 x 128 x 4 leaves), tracking all 404 coordinates, then
   min-ESS over all of them. The warmup is cut: the tracked configuration
   warms up for 600 steps at ``max_num_doublings=10``, but the port's generic
   NUTS step is host-bound (9.6 ms a leaf here), so this runs 100 steps at
   ``max_num_doublings=6`` (at most 6,300 leaves; on an H100 200 steps took
   104 s, 100 steps 68 s).
   Every chain must complete its transitions, everything must be finite, the
   dc kernel must be launched exactly once, in the form that copies X into
   shared memory once per block, and the second-half means of
   ``alpha`` and ``log_sigma`` must lie in bands from the JAX package's own
   NUTS on the CPU (``reference_bands`` in
   ``tests/test_torch_horseshoe_slice.py``). The line gives the block's
   bytes of shared memory, the instantiation's registers and spills from
   ``-Xptxas -v``, and a shared-memory bound beside the FP32 one: X read
   twice a gradient (2 x 100 x 200 x 4 bytes) at 128 bytes a clock on each
   SM that holds a block, at the SM clock of phase 1. Then the horseshoe's
   phase-9 pair: 128 chains from the path's final positions, 4 transitions,
   ``max_num_doublings=6``, with the form it launched;
11. the dense and the low-rank path on phase 9's logistic regression, launch
   counts reset just before each: the port's single-chain
   ``window_adaptation(nuts, is_mass_matrix_diagonal=False)``, or
   ``window_adaptation_low_rank(nuts, max_rank=10)`` (which restarts at its
   ``mu*``), 250 steps from zeros at ``max_num_doublings=6`` (cut from 400
   steps and from depth 8 for time), then ``fused_nuts_run_dc`` with the adapted
   ``(54, 54)`` or low-rank metric on 1,024 chains from the warmup's position
   plus 0.01 N(0, I) (numpy seed) for 256 transitions, tracking all 54
   coordinates, in one launch in the tiles form (required), then min-ESS over
   the second half; the line gives the kernel's time, its bound and their
   ratio, the lockstep's idle warp-iteration share (from a second launch on
   the same inputs, which gives the same outputs) and the leaves per
   transition. Every chain
   must complete, everything must be finite, and each coordinate's
   second-half mean must lie within 0.15 posterior sd, and its variance
   within [0.8, 1.25], of the JAX package's NUTS posterior on the CPU
   (``reference_moments`` in ``tests/test_torch_metric_slice.py``). Then each
   metric's kernel against its plain version on the path's step size and
   metric (512 chains x 8 transitions from the path's final positions: steps
   identical, gradient counts identical on every chain that agrees to
   MATRIX_TOL, share at MATRIX_TOL above the floor) and on
   a Gaussian at phase 3's width (d=100, 4,096 chains x 16 transitions, share
   at 1e-5), and the consistency pins of
   ``tests/ops/test_fused_nuts_dc_metrics.py`` on the card: ``diag(v)`` as a
   dense matrix and a low-rank payload with ``lam = 1``, each against the
   diagonal kernel;
12. the continuous-runner path, launch counts reset just before it:
   ``mcmc.nuts.build_fused_many_steps`` on phase 4's step size and metric,
   4,096 chains from phase 4's final positions, 64 transitions (cut from the
   bench's 256: the runner reads its loop condition on the host once per
   block) at ``unroll=4``, 8 tracked coordinates, keys ``(64, 4096, 2)``
   split as ``bench.py:230-232`` splits them; seconds, loop iterations (one
   leaf each), ms per iteration (and at ``unroll=1`` over 8 transitions),
   leaves per transition, grads/s, min-ESS and ESS/s. Every chain must
   complete, everything be finite, the threefry kernel launched,
   ``log_tau``'s second-half moments near N(0, 1), and the leaves per
   transition within 10% of the dc machine's from the same positions. Then,
   on 256 chains x 8 transitions, the runner (m=1, unroll=1) and the runner
   (m=4, unroll=4, restart_every=2) against a loop over ``nuts.build_kernel``
   with the same keys: gradient totals identical, history and finals
   reported bit for bit and held to the reference's f32 tolerance, 1e-4;
13. the older machine's path, launch counts reset just before it: one launch
   of ``ops.fused_nuts.fused_nuts_run`` (``csrc/fused_nuts.cu``) for 4,096
   chains x 256 transitions from phase 4's positions on its step size and
   metric (``budget=112 x 256``, ``chunk=256``), which must take the
   resident form; every chain must complete,
   everything be finite, ``log_tau``'s moments near N(0, 1), and the leaves
   per transition within 10% of phase 4's dc run; the line gives the
   launch's bound and kernel / bound, and each form's warps an SM,
   registers and local memory. The registers form on the same inputs must
   give all four outputs bit for bit. Then the kernel against its
   plain version: 512 x 16 on the flagship (the resident form and the
   registers form bit for bit; identical steps and gradient
   totals, share at 1e-5 above the floor, both times, the bound),
   ``trace=64`` on 64 x 4 in the registers form (every column identical on
   the floor's share of chains), and phase 9's logistic regression on 512 x
   8 (share at 1e-3);
14. the MCLMC path on phase 9's logistic regression, launch counts reset
   just before it: the port's single-chain ``mclmc_find_L_and_step_size``
   (2,000 steps' worth) from zeros, then ``fused_mclmc`` on 4,096 chains
   from the tuned position plus 0.01 N(0, I) (numpy seed 14) with unit
   momenta for 1,000 steps in one launch, tracking all 54 coordinates, then
   min-ESS over the second half; everything must be finite and the kernel
   launched once, in the tiles form. The line gives the kernel's time by
   CUDA events (a warm call after the main path's, whose time also holds the
   history's allocation, is printed beside it) and by torch.profiler, its
   bound at this shape, grads/s,
   min-ESS and ESS/s, the form with its chains a block and rows a tile, and
   the largest offset of a coordinate's second-half mean from the JAX
   package's NUTS posterior (phase 11's reference), in posterior sd,
   reported and not gated: unadjusted MCLMC keeps a bias of its step size.
15. the tracked eight-schools path (``benchmarks/tracked.py:396-480``),
   launch counts reset just before it: the port's single-chain
   ``window_adaptation(nuts, eight_schools_noncentered().logdensity_fn)``
   (400 steps from zeros, torch seed SEED on the card), then
   ``fused_nuts_run_dc`` on 512 chains from 0.1 N(0, I) (numpy seed 15) in
   the machine's layout (``eight_schools_dc_perm``) for 800 transitions at
   the tracked settings (``max_num_doublings=10``, ``pack=4``,
   ``restart_every=16``, ``chunk=256``, a budget of 160 x 800 x 4 leaves), all
   10 coordinates tracked, in one launch of the form the plan picks
   (required: its count 1, the other form's 0; the registers form, one
   chain a warp, since the thread form, one chain a thread, measured slower:
   PERF.md §6), then min-ESS over all 10. Every chain must complete,
   everything must be finite, the second-half means and variances of mu and
   log_tau must lie in bands around the JAX package's NUTS posterior
   (``reference_bands`` in ``tests/test_torch_dc_eight_schools.py``), and a
   launch of each form on the same inputs must give every output
   (positions, steps, gradients, history, iterations) bit for bit (SHA-256
   of the history printed). Then the plan's form against the plain version
   on the path's own start, step size, metric and settings, cut only to 16
   transitions (and the budget to 160 x 16 x 4), under phase 9's gate:
   steps identical, the share of chains agreeing to MATRIX_TOL above the
   floor, and the same gradient count on every chain that agrees. The line gives the launch's ms by CUDA events,
   ESS/s, grads/s, leaves per transition, the per-chain iterations (max,
   p99, mean), the bound at this shape and the launch / bound, each form's warps
   an SM, registers and local memory and its time on the per-chain
   launches, and the warmup's seconds and ms per leaf.
16. the tracked adaptive-tempered SMC path
   (``benchmarks/tracked.py:566-624``), launch counts reset just before it,
   nothing cut: ``adaptive_tempered_smc`` with ``mala`` moves (a shared step
   size of 0.1, 5 MCMC steps), ``resampling.systematic``, target ESS 0.5, on
   16,384 particles of d=10 from 3 N(0, I) (numpy seed 1), in f32, the
   prior N(0, 9 I) and the likelihood N(obs, I) with obs = linspace(-1, 1,
   10), run by the reference's host-paced loop (lambda read once a step, at
   most 50 steps): one warm run (key 17), three timed runs (split(key 18,
   3)), best of 3 as runs/sec (full tempering), then one waste-free run
   (``waste_free_smc(16384, 8)``, key 19). Each run must take lambda
   strictly up to exactly 1.0, keep everything finite and on the card, its
   weights summing to 1 within 1e-5, log Z (the summed log increments)
   within 0.25 of the exact -5 ln 10 - sum obs^2 / 20, every weighted mean
   within 0.06 of 0.9 obs and every weighted variance in [0.8, 1.0] (the
   waste-free run: 0.6 and 0.15), and a mean MALA acceptance above 0.9 at
   every step; the path must launch the threefry kernel (every draw of the
   path goes through ``prng``). The lines give each run's lambda schedule,
   log Z and its error, the largest mean and variance errors, the
   acceptance per step, seconds and host ms a tempering step, the threefry
   launches a run, one run's device records by torch.profiler against
   its time, and the median ms of each part of a tempering step (the ESS
   solver and its objective evaluations, resampling, the key split, the
   MALA moves, the reweight) and of the whole step. Then the same run in f64 at 1,024 particles on the card and on
   the CPU, on key 18: the same step count, lambda within 1e-10, ancestors
   identical at every step, particles within 1e-9.
17. the MCMC family beyond NUTS on the tracked static-HMC configuration
   (``benchmarks/tracked.py:112-163``: ``ill_conditioned_gaussian(100)``,
   128 chains from 0.5 N(0, I) of numpy seed 7, step size 0.08, 10
   integration steps, unit inverse mass, f32), threefry launch counts reset
   just before it, each transition's keys split as the configuration splits
   them: ``hmc`` for 1,024 transitions (cut from 131,072: the generic step
   is host-bound), then ``mhmc``, ``dhmc``, ``ghmc``, ``barker``,
   ``normal_random_walk``, ``irmh``, ``adjusted_mclmc``,
   ``adjusted_mclmc_dynamic``, ``elliptical_slice`` and ``mgrad_gaussian``
   (the prior N(0, diag(var)), a likelihood N(1, 1) per coordinate),
   ``slice_sampling``, ``coordinate_slice`` and ``orbital_hmc`` (in f64:
   its weights underflow f32), each for the transitions of
   ``FAM_TRANSITIONS``; every state and info tensor must stay on the card
   and finite, each sampler must launch the threefry kernel, and its mean
   acceptance (elliptical slice: mean ``subiter``; the slice samplers: mean
   ``num_shrink``) must lie within 0.03 (the counts: 15 %) of the JAX
   package's own CPU run at the same settings and keys
   (``tools/mcmc_family_reference.py``). Each line gives transitions/sec
   (chains x transitions, the configuration's unit), host ms a transition,
   threefry launches a transition, the device's busy share over a few
   transitions by torch.profiler, the statistic and the last state's
   moments against the target's. Then the registry's ``fused_hmc`` on the
   same configuration for all 131,072 transitions (one launch of the
   transition kernel each, all required), its mean acceptance in the same
   band as ``hmc``'s and its variances, every 16th transition after 1,024,
   within [0.9, 1.1] of the target's. Then each sampler in f64 at 16 chains
   x d = 5 for 20 transitions on the card and on the CPU, on the same keys:
   positions within 1e-12, accept flags, drawn step counts, ``subiter`` and
   the slice counts identical. The GIST samplers run among them
   (``gist_step_size`` at the configuration's step size as its initial one
   and 10 integration steps, ``gist_trajectory_length`` at its step size),
   their step indices or step counts and U-turn counts held identical too.
18. the tracked SG-MCMC configurations (``benchmarks/tracked.py``), threefry
   launch counts reset just before them, on the reference's dataset,
   ``logistic_regression(num_points=4096, dim=54)`` drawn on the card from
   ``jax.random.key(0)``'s words, in f32: ``config_sgld`` (``:486-563``:
   ``sgld``, one chain, batch 512, step size 1e-5, minibatch keys
   ``split(key(13))``, step keys ``split(key(14))``, the start of
   ``split(key(15), 4)[0]``) and ``config_sgld_chains`` (``:790-856``: 4,096
   chains, batch 256, one shared minibatch a step, the start of key 25, the
   run key ``split(key(26), 4)[0]``), each cut from 20,000 steps to 5,000
   (host-bound). Each line gives the
   configuration's unit (updates/sec, chain-updates/sec), host ms a step,
   threefry launches a step and the device's busy share over 64 steps; the
   final position (one chain) must lie within 0.05 second-half sd of the JAX
   package's on the CPU at the same keys, and the mean over the 4,096 chains
   within 0.25 standard errors (``tools/sgmcmc_reference.py``); the
   minibatch indices are int32, JAX's default integer without x64. Then ``sgld``,
   ``sghmc``, ``sgnht`` and ``csgld`` in f64 at 16 chains x 20 steps, batch 64,
   on the card and on the CPU on the same keys: minibatch indices (and
   csgld's bins) identical, positions within 1e-12.

A line then gives the host-clock seconds of each phase. The line before
the last is the per-kernel JSON record: one entry per
kernel of the main paths (``ms`` and ``plain_ms`` are phase 3's, 5's and 7's
like-for-like times), one per new (kernel, target) pair (phase 9's and
10's times) and one per metric of the dc machine (phase 11's logistic
regression comparison), one for the older machine (phase 13's 512 x 16 times; eight schools'
launches are phase 15's)
and one for the threefry kernel with a key per element (phase 2's times on
1,048,576 keys; its launches are phases 12's, 16's, 17's and 18's), and one
for the VPU-peak kernel (its unfused ``fma`` at N = 4 and 32 warps an SM,
4,096 iterations; its launches are phase 1's sweep). ``launches`` is the count from the
main path's run, or, for a pair that no main path drives, from the pair's checked
call; ``fused_leapfrog`` counts ``leapfrog_kernel``'s own launches on phase 6,
apart from the transition kernel's (its own entry: phases 6's and 17's), so none.
``bound_ms`` is
the larger of the bytes the call must move over 3.35 TB/s and its FP32
operations over 132 SMs x 128 lanes x 2 x the SM clock ``nvidia-smi``
reads, from the call's inputs and outputs (gradient counts from the run);
``bound_measured_ms`` the same with phase 1's measured FP32 rate;
``library_ms`` is null: no single PyTorch call computes any of these
functions. The last line is ``{"ok": true, "device": {...}}``. Any failed
check raises and exits non-zero without that line; so does a machine
without CUDA, and a directory without the package.
"""
import hashlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

D, C = 100, 4096
SEED = 7
STEP_SIZE = 0.2
MAX_DOUBLINGS = 8
NUM_TRACK = 8
AGREE_TOL = 1e-5
AGREE_FLOOR = 0.9  # tests/test_torch_fused_nuts_dc.py::AGREE_FLOOR
WARMUP_STEPS = 400  # bench.py's WARMUP_STEPS
PLAIN_CHAINS = 512  # phase 4's plain-version comparison: chains ...
PLAIN_TRANSITIONS = 16  # ... and transitions (cut from 32: its plain version took 38-46 s)
LEAPFROG_FLOOR = 0.99
HMC_STEPS = 10  # leapfrog steps per HMC transition
HMC_TRANSITIONS = 1000
MCLMC_CMP_STEPS = 64  # phase 7's comparison depth ...
MCLMC_DEPTH = 512  # ... and how deep it reports the growth of differences
MCLMC_FLOOR = 0.9
MCLMC_EQUAL_CHAINS = 512  # phase 7's resident form against the registers form
MCLMC_TUNE_STEPS = 2000
MCLMC_STEPS = 1000
MATRIX_TOL = 1e-3  # the dc machine's matrix targets against their plain version
LR_N, LR_D = 4096, 54  # the covertype-class logistic regression (benchmarks/tracked.py:495)
DC_CHAINS = 512  # phase 9's dc comparisons
HS_N, HS_M = 100, 200  # the Finnish horseshoe at the reference benchmark's size
HS_CHAINS, HS_TRANSITIONS = 512, 128  # benchmarks/tracked.py:918, v6
HS_MAX_DOUBLINGS = 10  # benchmarks/tracked.py:329
HS_PACK, HS_RESTART_EVERY, HS_CHUNK = 4, 16, 256
HS_BUDGET = 1600 * HS_TRANSITIONS * HS_PACK  # budget_factor 1600 (tracked.py:946)
HS_WARMUP_STEPS, HS_WARMUP_DOUBLINGS = 100, 6  # cut from 600 at 10: see phase 10
HS_CMP_CHAINS, HS_CMP_TRANSITIONS, HS_CMP_DOUBLINGS = 128, 4, 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# phase 1: the VPU-peak kernel (csrc/vpu_peak.cu, the port of benchmarks/vpu_peak.py:58)
# held bit for bit against its plain version at VP_HOLD_ITERS iterations, then
# its rates at each values a lane and these warps an SM, each call's shorter
# run VP_UPDATES element-updates (about 1.2 ms unfused on an NVIDIA H100 80GB
# HBM3 at 700.00 W)
VP_A, VP_HOLD_ITERS, VP_WARPS, VP_UPDATES = 0.999, 64, (20, 32), 2e10
VP_ENTRY_ITERS = 4096  # the kernels line's call: unfused fma, N = 4, 32 warps an SM
TF_KEYS = 1 << 20  # phase 2's per-element-key threefry check
# phase 12: the continuous runner, cut from the bench's 256 transitions
# because it reads its loop condition on the host once per block of leaves
RUNNER_TRANSITIONS, RUNNER_UNROLL = 64, 4
RUNNER_CMP_CHAINS, RUNNER_CMP_TRANSITIONS = 256, 8  # its bit-identity check
RUNNER_TOL = 1e-4  # tests/mcmc/test_nuts.py:327, the reference's f32 tolerance
LEAVES_REL = 0.1  # leaves per transition against the dc machine's
# phase 13: the older machine, one launch at the bench's depth
LEGACY_TRANSITIONS, LEGACY_CHUNK = 256, 256
LEGACY_BUDGET = 112 * LEGACY_TRANSITIONS
LEGACY_CMP_CHAINS, LEGACY_CMP_TRANSITIONS = 512, 16
LEGACY_TRACE_CHAINS, LEGACY_TRACE_TRANSITIONS, LEGACY_TRACE = 64, 4, 64
UNKEYED_WARMUP_MS_PER_LEAF = 48.44e3 / 9151  # phase 4's warmup before the keyed draws
# phase 14: MCLMC on phase 9's logistic regression, one launch at full depth
LR_MCLMC_STEPS = 1000
# phase 15: the tracked eight-schools configuration (benchmarks/tracked.py:
# 396-480, 317-337): 512 chains x 800 transitions after a 400-step warmup
ES_CHAINS, ES_TRANSITIONS, ES_WARMUP_STEPS = 512, 800, 400
ES_MAX_DOUBLINGS, ES_PACK, ES_RESTART_EVERY, ES_CHUNK = 10, 4, 16, 256
ES_BUDGET = 160 * ES_TRANSITIONS * ES_PACK  # budget_factor 160 (tracked.py:451)
ES_PLAIN_TRANSITIONS = 16  # the pair against the plain version, at the same settings
# The posterior of mu and log_tau by the JAX package's own NUTS on the CPU
# (tests/test_torch_dc_eight_schools.py:reference_bands: window_adaptation
# 1,000 steps from zeros, then 128 chains from 0.1 N(0, I) x 2,000
# transitions, key 15, second half): mean, variance, the mean's MCSE.
ES_REFERENCE = {"mu": (4.56320, 10.24402, 0.01208), "log_tau": (-2.77182, 11.80050, 0.01602)}
# bands: the mean within 0.1 posterior sd and the variance within [0.9, 1.1]
# of the reference's; 512 chains x 400 draws leave a Monte Carlo error of
# about 0.01 sd in the mean and 0.02 in the variance ratio
ES_MEAN_SD, ES_VAR_RATIO = 0.1, (0.9, 1.1)
# phase 16: the tracked adaptive-tempered SMC configuration
# (benchmarks/tracked.py:566-624): d = 10, 16,384 particles from 3 N(0, I),
# prior N(0, 9 I), likelihood N(obs, I) with obs = linspace(-1, 1, 10), MALA
# moves at a shared step size of 0.1, systematic resampling, target ESS 0.5,
# 5 MCMC steps, at most 50 tempering steps; nothing cut
SMC_D, SMC_PARTICLES, SMC_MAX_STEPS = 10, 16384, 50
SMC_STEP_SIZE, SMC_TARGET_ESS, SMC_MCMC_STEPS = 0.1, 0.5, 5
SMC_WASTE_FREE_P = 8  # waste_free_smc(16384, 8), num_mcmc_steps=None
SMC_OBS = np.linspace(-1.0, 1.0, SMC_D)
# the exact posterior: mean 0.9 obs, variance 0.9; log Z = -5 ln 10 - sum obs^2 / 20
SMC_LOG_Z = -0.5 * SMC_D * np.log(10.0) - float((SMC_OBS**2).sum()) / 20.0
# gates, about three times the worst errors of the JAX package's own runs of
# this configuration on a CPU, keys 18-22 (log Z off by up to 0.084, means by
# 0.030; waste-free, keys 18-20: 0.29 and 0.078): log Z and means by form,
# the variances' band, the smallest mean acceptance a step
SMC_GATES = {"adaptive": (0.25, 0.06), "waste-free": (0.6, 0.15)}
SMC_VAR_BAND, SMC_MIN_ACCEPT = (0.8, 1.0), 0.9
SMC_CMP_PARTICLES, SMC_CMP_TOL = 1024, 1e-9  # the f64 run on the card against the CPU
# phase 17: the MCMC family beyond NUTS on the tracked static-HMC configuration
# (benchmarks/tracked.py:112-163): ill_conditioned_gaussian(100), 128 chains from
# 0.5 N(0, I) of numpy seed 7, step size 0.08, 10 integration steps, unit inverse
# mass, f32; a transition's keys split as tracked.py:134 splits them (split(run
# key, 131072)[i], then a key a chain), the run key split(key(8), 4)[0], the
# first of the configuration's variants (tracked.py:139)
FAM_D, FAM_CHAINS, FAM_X0_SEED = 100, 128, 7
FAM_STEP_SIZE, FAM_STEPS = 0.08, 10
FAM_TRACKED_TRANSITIONS = 131072  # tracked.py:120 on the chip; fused_hmc runs all
FAM_FUSED_BURN, FAM_FUSED_THIN = 1024, 16  # fused_hmc's moments: after 1,024, every 16th
FAM_FUSED_VAR_BAND = (0.9, 1.1)  # its variances over the target's
# Transitions a sampler. The generic samplers are host-bound (about 20-25 us a
# torch op, 21 ms a transition of hmc's 10 leapfrog steps on an H100's host),
# so each is cut from the configuration's 131,072 to a few seconds' worth (hmc
# to 1,024, about 22 s); coordinate_slice sweeps 100 univariate slices a
# transition, each a few host-paced loops (9 s), so it takes 1.
FAM_TRANSITIONS = {
    "hmc": 1024, "mhmc": 128, "dhmc": 128, "ghmc": 512, "barker": 512,
    "normal_random_walk": 1024, "irmh": 1024, "adjusted_mclmc": 128,
    "adjusted_mclmc_dynamic": 128, "elliptical_slice": 128, "slice_sampling": 32,
    "coordinate_slice": 1, "orbital_hmc": 64, "mgrad_gaussian": 512,
    "gist_step_size": 32, "gist_trajectory_length": 16,
}
FAM_IRMH_SCALE, FAM_PERIOD = 1.05, 8  # irmh's proposal N(0, 1.1025 diag(var)); orbital_hmc's
# orbital_hmc runs in f64: its weights exp(logdensity - K) at d = 100 underflow
# f32 (to 0 / 0 once a whole orbit does), in the reference as in the port
FAM_F64 = ("orbital_hmc",)
FAM_MGRAD_DELTA, FAM_MCLMC_STEP, FAM_MCLMC_STEPS = 1.0, 1.0, 5
FAM_BUSY_TRANSITIONS = 8  # the transitions of the busy-share run, but for the slowest:
FAM_BUSY_SHORT = {"coordinate_slice": 1, "gist_trajectory_length": 2}
# Bands of the mean acceptance (elliptical slice: mean subiter; the slice
# samplers: mean num_shrink), from the JAX package's own run of each sampler on
# the CPU at the same settings, keys and transitions
# (tools/mcmc_family_reference.py): its mean, +- FAM_BAND_WIDTH (relative for
# the counts)
FAM_REFERENCE = {
    "hmc": 0.982564, "mhmc": 0.984720, "dhmc": 0.984613, "ghmc": 0.995384,
    "barker": 0.836033, "normal_random_walk": 0.558916, "irmh": 0.620505,
    "adjusted_mclmc": 0.999528, "adjusted_mclmc_dynamic": 0.999546,
    "elliptical_slice": 6.647827, "slice_sampling": 2.852783,
    "coordinate_slice": 285.523438, "mgrad_gaussian": 0.332422,
    "gist_step_size": 0.710899, "gist_trajectory_length": 0.313429,
}
FAM_REFERENCE["fused_hmc"] = FAM_REFERENCE["hmc"]  # the same HMC, its own draws
FAM_BAND_WIDTH, FAM_COUNT_BAND = 0.03, 0.15
FAM_COUNTED = ("elliptical_slice", "slice_sampling", "coordinate_slice")
FAM_CMP_CHAINS, FAM_CMP_D, FAM_CMP_TRANSITIONS, FAM_CMP_TOL = 16, 5, 20, 1e-12
# phase 18: the tracked SG-MCMC configurations (benchmarks/tracked.py:486-563,
# config_sgld, and :790-856, config_sgld_chains) at their chip sizes: SGLD on
# logistic_regression(num_points=4096, dim=54) of jax.random.key(0) (rebuilt on the
# card from the same key words), step size 1e-5, f32; the steps cut
SG_N, SG_D, SG_STEP_SIZE = 4096, 54, 1e-5
# Steps cut from the configurations' 20,000 to 5,000 for the script's time
# limit: the path is host-bound, 3.5-4.7 host ms a step on the slowest host
# seen (NVIDIA H100 80GB HBM3, 700.00 W: 165 s for both at 20,000); the rates are per step, so the cut leaves
# them as they are
SG_STEPS, SG_BATCH = 5000, 512  # config_sgld: one chain (tracked.py:496)
SG_CHAINS, SG_CHAINS_STEPS, SG_CHAINS_BATCH = 4096, 5000, 256  # config_sgld_chains (:797-798)
# The JAX package's own run of both on the CPU at the same keys and steps, each
# configuration's first variant (tools/sgmcmc_reference.py --steps 5000, f32): config_sgld's
# final position and each coordinate's sd over the second half of its path;
# config_sgld_chains' mean of the final positions over the chains and their sd
SG_REFERENCE = {
    "final": np.array([
        -1.819085, -1.603215, 0.1873654, -0.2362033, -0.4770269, -1.019885, -0.8274411,
        0.3738279, -0.908547, 1.757591, -0.1956443, 0.7076208, -1.062181, -0.5357544,
        -0.2312086, 0.3295972, -0.8578554, -0.2386726, -0.5836334, -1.48494, -0.7068718,
        -0.2883728, 0.7173298, 0.6459404, -0.7142124, -0.3434721, 0.5401345, 1.345892,
        -0.3869458, -0.007621103, -0.6261434, -1.315481, -0.1668209, 0.6826252, -0.9782977,
        -0.6570091, -1.84334, -1.24404, -0.4299658, -1.206998, -1.585694, -1.19704,
        -0.2529073, -0.5046874, 0.4513108, -0.8356835, 1.215136, 0.4046865, -0.1273224,
        0.6770605, 0.5044151, -0.7258906, 0.5443416, -0.9518069,
    ]),
    "second_half_sd": np.array([
        0.1141192, 0.1271819, 0.04436543, 0.05592619, 0.03658879, 0.08406787, 0.08625795,
        0.03977094, 0.04748584, 0.09277409, 0.07145383, 0.04263968, 0.08198582, 0.07336894,
        0.04991065, 0.06683867, 0.06244345, 0.05528003, 0.04303041, 0.1202726, 0.06414911,
        0.06339868, 0.03980412, 0.07051702, 0.04850467, 0.03080023, 0.03519541, 0.1451348,
        0.03821668, 0.03594237, 0.07580478, 0.05031082, 0.04530316, 0.0981418, 0.07099992,
        0.07870327, 0.1213138, 0.08845272, 0.05023422, 0.06764634, 0.08328339, 0.1122095,
        0.06795481, 0.046452, 0.05875515, 0.09606201, 0.09678213, 0.04810083, 0.03881906,
        0.03660685, 0.05791528, 0.06876022, 0.08600952, 0.07745489,
    ]),
    "mean": np.array([
        -1.727482, -1.461765, 0.2024845, -0.1931868, -0.4876084, -0.9305537, -0.7842476,
        0.2352747, -0.8988873, 1.560292, -0.1483768, 0.6464502, -0.965542, -0.5281513,
        -0.1994255, 0.3041494, -0.8093485, -0.1095939, -0.5957328, -1.297739, -0.7538126,
        -0.2522543, 0.8563341, 0.6081879, -0.7541219, -0.4086341, 0.5604503, 1.310848,
        -0.3249289, 0.02255092, -0.4719694, -1.37839, -0.2121394, 0.7162133, -0.9504989,
        -0.5409011, -1.741322, -1.169232, -0.3085513, -1.221615, -1.484882, -1.152384,
        -0.1974775, -0.4511559, 0.3410877, -0.730858, 1.256566, 0.4371473, -0.1486333,
        0.6245088, 0.5047882, -0.6764551, 0.4304737, -0.9410118,
    ]),
    "sd": np.array([
        0.07928643, 0.07545574, 0.06555492, 0.06126855, 0.0667757, 0.06902723, 0.0688014,
        0.06475879, 0.06760615, 0.07502422, 0.06111808, 0.06506749, 0.06921493, 0.06626017,
        0.06501641, 0.06621442, 0.06659357, 0.06441295, 0.06529031, 0.07363868, 0.06685714,
        0.06338947, 0.06584104, 0.06677722, 0.06953185, 0.06566641, 0.06760511, 0.07327747,
        0.06586295, 0.06874856, 0.06474507, 0.07354447, 0.06403091, 0.0691295, 0.06948566,
        0.06826858, 0.07814831, 0.07209067, 0.06483111, 0.07163059, 0.07550089, 0.07229092,
        0.06336217, 0.06474867, 0.0655148, 0.06722875, 0.07400421, 0.06848945, 0.06458481,
        0.06641068, 0.06688292, 0.06542008, 0.06777839, 0.0692323,
    ]),
}
# Bands: config_sgld's final position within 0.05 of the second half's sd of the
# reference's, every coordinate; config_sgld_chains' mean over the chains within
# 0.25 standard errors (sd / sqrt(4,096)) of the reference's. The same keys
# drive the same noise and minibatches, so the port's paths follow the
# reference's up to rounding and the dataset's last bits (torch's f32 erfinv):
# on a CPU the port came within 7.4e-6 sd (20,000 steps) and 0.0023 standard
# errors (4,096 chains x 2,000 steps), on an NVIDIA H100 80GB HBM3 at 700.00 W
# under 5e-5 sd and within 0.0016 standard errors (20,000 steps). Other minibatches (int64 indices, which draw
# other numbers from the same keys) moved the single chain 0.38 sd
SG_SINGLE_BAND, SG_CHAINS_BAND = 0.05, 0.25
SG_BUSY_STEPS = 64  # the steps of each configuration's busy-share run
# the f64 hold, the card against the CPU: chains x steps x batch
SG_CMP_CHAINS, SG_CMP_STEPS, SG_CMP_BATCH, SG_CMP_TOL = 16, 20, 64, 1e-12
SG_SAMPLERS = ("sgld", "sghmc", "sgnht", "csgld")
# The horseshoe's posterior by the JAX package's own NUTS on the CPU
# (tests/test_torch_horseshoe_slice.py:reference_bands: window_adaptation 600
# steps from zeros, then 64 chains from 0.05 N(0, I) x 256 transitions, seed
# 31, second half): alpha 0.00138 (sd 0.12253, MCSE 0.00136), log_sigma
# -0.15748 (sd 0.13073, MCSE 0.00315). Bands of +-0.1 around those means
# (0.8 and 0.76 posterior sd) leave room for the cut warmup and 64
# transitions' Monte Carlo error; a sampler stuck at its start (log_sigma
# near 0) falls outside the log_sigma band.
ALPHA_BAND = (0.00138 - 0.1, 0.00138 + 0.1)
LOG_SIGMA_BAND = (-0.15748 - 0.1, -0.15748 + 0.1)
# phase 11's warmups, cut to max_num_doublings=6: the dense one's early
# windows (25 and 50 draws in 54 dims) give a rank-deficient metric, and at 8
# its 400 steps ran 17,389 leaves in 156 s on an H100; then cut to 250 steps
# for the script's time limit (both warmups took 242.9 s at 400 steps on the
# slowest host seen, NVIDIA H100 80GB HBM3, 700.00 W); the last slow window
# keeps 100 draws
MET_WARMUP_STEPS, MET_WARMUP_DOUBLINGS = 250, 6
MET_CHAINS, MET_TRANSITIONS, MET_DOUBLINGS = 1024, 256, 8  # phase 11's dc runs
MET_MAX_RANK = 10  # window_adaptation_low_rank's max_rank
MET_CMP_CHAINS, MET_CMP_TRANSITIONS = 512, 8  # phase 11's pairs on logistic regression
MET_MEAN_SD, MET_VAR_RATIO = 0.15, (0.8, 1.25)  # phase 11's gates against the reference
# The posterior of phase 9's logistic regression (4,096 x 54, numpy seed 9,
# prior scale 10) by the JAX package's own NUTS on the CPU
# (tests/test_torch_metric_slice.py:reference_moments: dense window_adaptation
# 1,000 steps from zeros, then 64 chains from its position + 0.01 N(0, I) x 512
# transitions, key 51, second half; min ESS over the 54 coordinates 15,213.5,
# MCSE at most 0.0081 sd): each coordinate's mean and sd.
LR_POSTERIOR_MEAN = np.array([
    1.475994, -0.776927, -1.741585, -0.154613, -1.245173, 0.621612,
    -0.508942, -0.003998, -2.353193, -0.529176, -0.203734, 0.197036,
    -0.550997, -1.111968, -0.888287, -0.863221, -1.042868, -0.111472,
    0.069723, 0.265807, 0.124341, 0.146252, -1.538106, 0.373150,
    0.628189, -1.090270, -0.100414, -0.553694, -1.030760, -0.275952,
    -0.469394, -0.698872, -0.372698, -1.297230, 0.561292, 0.353565,
    1.791416, -0.000556, -0.551947, -0.530247, -0.547802, -0.705782,
    -1.183671, -0.503766, -0.390398, 1.351005, 0.454338, 0.035359,
    -0.245321, 0.959065, -1.435195, -0.294008, 0.100524, -0.789602,
])
LR_POSTERIOR_SD = np.array([
    0.082390, 0.068197, 0.088860, 0.063060, 0.075502, 0.069488, 0.066286, 0.063135,
    0.102497, 0.066806, 0.065135, 0.066487, 0.065815, 0.073659, 0.070368, 0.070192,
    0.074094, 0.064200, 0.062868, 0.062604, 0.064386, 0.060513, 0.083175, 0.065237,
    0.068702, 0.074363, 0.063669, 0.066334, 0.072495, 0.061268, 0.063937, 0.067332,
    0.063466, 0.081018, 0.067080, 0.065838, 0.090285, 0.061030, 0.064787, 0.067699,
    0.067507, 0.067818, 0.074880, 0.067105, 0.063916, 0.078338, 0.066084, 0.062257,
    0.065265, 0.071953, 0.080941, 0.064688, 0.063923, 0.069900,
])


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _timed(torch, fn):
    """(result, milliseconds) of one call, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _ptxas_summary(log: str) -> list:
    """'kernel: registers, spill stores/loads' from nvcc's -Xptxas -v report;
    kernels are named by their registers per lane and vector (N), their
    target family (F: 0 analytic, 2 logistic regression, 3 horseshoe, 4
    eight schools) and, for the dc machine, their metric (M: 0 diagonal, 1
    dense, 2 low-rank) and where the horseshoe reads X (shared=1: a copy in
    shared memory); the dc machine's resident form by N, its analytic target
    (T: 0 hierarchical, 1 Gaussian) and M; the older NUTS machine by its
    trace flag; the MCLMC kernel's resident form by N, T and its unrolled
    stages (S, 0 for the stage loop at run time); the HMC transition by N
    and T; the dc machine's thread form by F and M."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry and "vpu_peak_kernel" in entry.group(1):
            v = re.search(r"vpu_peak_kernelILi(\d+)ELb(\d)ELb(\d)E", entry.group(1))
            name = f"vpu_peak N={v.group(1)} fused={v.group(2)} select={v.group(3)}"
        elif entry:
            n = re.search(r"(nuts_dc|nuts|leapfrog|mclmc|hmc)_"
                          r"(kernel|resident|transition|thread)ILi(\d+)"
                          r"ELi(\d+)E(?:Li(\d+)E)?(?:Lb(\d)E)?", entry.group(1))
            export = "threefry" if "threefry" in entry.group(1) else "counter_normals"
            metric = ""
            if n and n.group(5):  # the dc machine's metric, or MCLMC's unrolled stages
                metric = f" {'S' if n.group(1) == 'mclmc' else 'M'}={n.group(5)}"
            flag = ""
            if n and n.group(6):
                flag = f" {'shared' if n.group(1) == 'nuts_dc' else 'trace'}={n.group(6)}"
            if n and n.group(2) == "thread":  # the dc machine's thread form: F and M
                name = f"nuts_dc thread F={n.group(3)} M={n.group(4)}"
            elif n and n.group(2) == "transition":  # N and the analytic target T
                name = f"hmc_transition N={n.group(3)} T={n.group(4)}"
            elif n and n.group(2) == "resident":  # the analytic target T in the resident form
                name = f"{n.group(1)} resident N={n.group(3)} T={n.group(4)}{metric}"
            else:
                name = (f"{n.group(1)} N={n.group(3)} F={n.group(4)}{metric}{flag}" if n
                        else f"{export} export")
        spill = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            out.append(f"{name}: stack {spill.group(1)} B, spills "
                       f"{spill.group(2)}/{spill.group(3)} B")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out:
            out[-1] += f", {regs.group(1)} registers"
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                out[-1] += f", {smem.group(1)} B static smem"
    return out


def _agreement(torch, a, b, tol=AGREE_TOL):
    """Share of chains whose positions and history agree to ``tol``, and
    the largest absolute difference."""
    (ax, ah), (bx, bh) = a, b
    close = torch.isclose(ax, bx, rtol=tol, atol=tol).all(1)
    close &= torch.isclose(ah, bh, rtol=tol, atol=tol).flatten(1).all(1)
    err = max(float((ax - bx).abs().max()), float((ah - bh).abs().max()))
    return float(close.float().mean()), err


def _per_chain(torch, module, launch, x, imm, step, kw):
    """One machine run through ``module``'s kernel launch (``launch=True``,
    counted in its ``LAUNCHES``) or its plain version, with the per-chain
    outputs the public wrappers sum away: ``(final positions, steps,
    gradients, history)`` per chain, and the milliseconds by CUDA events."""
    x32, operands, machine = module._prepare(x, imm, **kw)
    fn = module._launch_cuda if launch else module._machine_plain
    out, ms = _timed(torch, lambda: fn(x32, operands, float(step), **machine))
    return out[:4], ms


def _matrix_pair(torch, name, kern, plain, num_steps):
    """The gates of a kernel against its plain version on a matrix target,
    chain by chain: identical steps; the share of chains whose positions and
    history agree to MATRIX_TOL at least the floor; identical gradient counts
    on every chain that agrees. Their contractions with the data sum in
    other orders (kernel: row by row; plain: cuBLAS tiles), the difference
    grows along a trajectory, and a chain whose path parts beyond MATRIX_TOL
    may take a U-turn at another leaf (PERF.md §6). Returns the share at
    MATRIX_TOL and at AGREE_TOL, the largest difference, the gradient totals
    and the number of chains with other gradient counts."""
    (kx, ks, kg, kh), (px, ps, pg, ph) = kern, plain
    _require(torch.equal(ks, ps) and bool((ks == num_steps).all()),
             f"{name}: steps differ or fall short")
    _require(bool(torch.isfinite(kx).all() and torch.isfinite(kh).all()),
             f"{name}: non-finite output")
    share, err = _agreement(torch, (kx, kh), (px, ph), MATRIX_TOL)
    share5, _ = _agreement(torch, (kx, kh), (px, ph))
    close = torch.isclose(kx, px, rtol=MATRIX_TOL, atol=MATRIX_TOL).all(1)
    close &= torch.isclose(kh, ph, rtol=MATRIX_TOL, atol=MATRIX_TOL).flatten(1).all(1)
    other = kg != pg
    _require(not bool((other & close).any()),
             f"{name}: a chain that agrees to {MATRIX_TOL} has other gradient counts")
    _require(share >= AGREE_FLOOR, f"{name}: only {share} of chains agree to {MATRIX_TOL}")
    return share, share5, err, float(kg.sum()), float(pg.sum()), int(other.sum())


def _tiles_idle_share(torch, dc, x, imm, step, kw):
    """The share of warp-iterations in which a warp of the tiles form's
    lockstep was not live, in one more launch of the dc kernel on the same
    inputs (it gives the same per-chain outputs), and the forms it took."""
    x32, operands, machine = dc._prepare(x, imm, **kw)
    before = dict(dc.LAUNCHES)
    out = dc._launch_cuda(x32, operands, float(step), **machine)
    forms = [key.split(":x_")[1] for key, v in dc.LAUNCHES.items()
             if ":x_" in key and v > before[key]]
    return dc.lockstep_idle_share(out[1], out[4], machine["num_steps"], machine["budget"]), forms


def _timed_mean(torch, fn, repeats):
    """Milliseconds per call over ``repeats`` calls, by CUDA events, after
    one untimed call."""
    fn()
    _, ms = _timed(torch, lambda: [fn() for _ in range(repeats)])
    return ms / repeats


def _device_ms(torch, fn, kernel, repeats=20):
    """Device time per call of the kernels whose name holds ``kernel``, by
    torch.profiler (CUPTI): their records' durations, summed over
    ``repeats`` calls. The trace can drop kernel records (PERF.md §7), so
    a count of records that is not a multiple of ``repeats`` is refused.
    None where the trace holds no record or lost some."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        runs = [e for e in prof.events() if kernel in e.name]
    if not runs or len(runs) % repeats:
        return None
    return sum(e.time_range.elapsed_us() for e in runs) / 1e3 / repeats


# FP32 operations per element, counted from the kernels' code: the dc
# machine's own per leaf and dim (leapfrog 7, energy 4, sums 1, U-turn
# checks 8 on average); the leapfrog's per step and dim (two kicks, a
# drift); MCLMC's per McLachlan step and dim (three kicks of 13, two drifts
# of 3, two refreshes of 5); the analytic gradients per dim. threefry2x32
# is about 70 integer operations a block (20 rounds and the key schedule).
DC_LEAF_OPS, LEAPFROG_STEP_OPS, MCLMC_STEP_OPS = 24, 7, 55
# the HMC transition's own per dim beside its trajectory: the momentum (a
# square root and a division), both kinetic energies (3 each) and the select
TRANSITION_OPS = 9
GRAD_OPS = {"hierarchical": 4, "gaussian": 3}
THREEFRY_OPS = 70
# MCLMC_STEP_OPS leaves out Box-Muller's logf, sqrtf and cosf. Recounted
# from the SASS of the registers form's refresh draws (dc_kernel_ms.py
# --machine mclmc --sass, PR 13: 661 integer, 368 FP32, 8 MUFU and 40
# conversion warp-instructions for a step's 8 blocks a lane at d = 100), a
# normal is 46 FP32 operations, 6 on the special-function pipe (MUFU and
# conversions) and 12.6 integer ones beside its block's THREEFRY_OPS.
BOX_MULLER_OPS = {"fp32": 46.0, "sfu": 6.0, "int32": 82.625 - THREEFRY_OPS}


def _mclmc_bound(peaks, chains, steps, d, tracked, box_muller=False):
    """The bound of a ``fused_mclmc`` launch on the hierarchical target:
    x and m in and out, the log densities and the history; two gradients
    and MCLMC_STEP_OPS a step and dim; a threefry block a refresh normal,
    two refreshes a step; with ``box_muller``, each normal's Box-Muller
    too."""
    normals = chains * steps * 2 * d
    extra = BOX_MULLER_OPS if box_muller else dict.fromkeys(BOX_MULLER_OPS, 0.0)
    return _bound(4 * chains * d * 4 + chains * 4 + chains * steps * tracked * 4,
                  chains * steps * (2 * GRAD_OPS["hierarchical"] * d + MCLMC_STEP_OPS * d)
                  + normals * extra["fp32"], peaks,
                  normals * (THREEFRY_OPS + extra["int32"]), normals * extra["sfu"], d=d)


def _legacy_bound(peaks, chains, transitions, grads):
    """The bound of a ``fused_nuts_run`` launch on the flagship (d = D),
    from its gradient total: positions in and out, the history and the two
    per-chain totals; the dc leaf's operations and the gradient (whose
    theta^2 sum gives the log density too) at each leaf; and the fewest
    threefry blocks that give its bits: one a leaf, the direction and
    proposal pair of at least one subtree a transition, and the momentum."""
    return _bound(2 * chains * D * 4 + chains * transitions * NUM_TRACK * 4 + 2 * chains * 4,
                  grads * (DC_LEAF_OPS + GRAD_OPS["hierarchical"]) * D, peaks,
                  (grads + 2 * chains * transitions + chains * transitions * D) * THREEFRY_OPS,
                  d=D)


def _grad_ops(kind, d, n=0, m=0):
    """FP32 operations of one gradient (with its log density): the two
    contractions (4 n d, or 4 N M for the horseshoe) and the elementwise
    work around them."""
    if kind == "logreg":
        return 4 * n * d + 12 * n + 5 * d
    if kind == "horseshoe":
        return 4 * n * m + 30 * m + 20 * d
    if kind == "eight_schools":
        return 20 * d
    return GRAD_OPS[kind] * d


def _measured_fp32(peaks, d):
    """The measured FP32 operation rate for a kernel of width ``d``: twice
    phase 1's unfused ``fma`` updates a second (a multiply and an add each,
    as ``--fmad=false`` compiles ``a * x + b``) at the values a lane nearest
    the kernel's ``ceil(d / 32)``, the better of the two warp counts."""
    measured = peaks.get("fp32_measured")
    if not measured:
        raise RuntimeError("no measured FP32 rate: phase 1's vpu_peak sweep has not run")
    lanes = min(measured, key=lambda n: (abs(n - math.ceil(d / 32)), n))
    return measured[lanes]


def _bound(nbytes, fp32_ops, peaks, int_ops=0.0, sfu_ops=0.0, *, d):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rates. Returns
    ``(ms, "bytes" or "operations", measured ms)``: the last with the FP32
    operations over the measured rate for width ``d`` (phase 1)."""
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    other_s = int_ops / peaks["int32"] + sfu_ops / peaks["sfu"]
    op_ms = (fp32_ops / peaks["fp32"] + other_s) * 1e3
    measured_ms = max(byte_ms, (fp32_ops / _measured_fp32(peaks, d) + other_s) * 1e3)
    return ((byte_ms, "bytes", measured_ms) if byte_ms >= op_ms
            else (op_ms, "operations", measured_ms))


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound):
    return {"name": name, "route": "cuda", "source": f"blackjax_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
            "bound_measured_ms": bound[2], "library_ms": None}


def _log_tau_moments(hist):
    """Mean and variance of log_tau (tracked column 0) over the second half
    of a (chains, samples, k) history."""
    log_tau = hist[:, hist.shape[1] // 2:, 0].flatten()
    return float(log_tau.mean()), float(log_tau.var())


def flagship_init(torch, dev):
    """The flagship's C starting positions: 0.5 N(0, I) of numpy seed 1."""
    return torch.from_numpy((0.5 * np.random.default_rng(1).standard_normal((C, D)))
                            .astype(np.float32)).to(dev)


def vpu_peak_phase(torch, vp, dev, sms, sm_mhz, peaks, smi):
    """Phase 1's VPU-peak part (see the head of this file): the kernel held
    bit for bit against its plain version in every mode, rounding and
    values a lane; the rate sweep, its launches counted from 0; the SM
    clock under load; ``peaks["fp32_measured"]`` set for the bounds.
    Returns the ``kernels`` entry's numbers."""
    generator = torch.Generator(device=dev).manual_seed(SEED)
    held = 0
    for warps in VP_WARPS:
        for lanes in vp.LANES:
            for rows in (vp.block_rows(sms, lanes, warps), 8):  # a full grid; a partial block
                x = torch.randn((rows, vp.COLS), generator=generator, device=dev)
                for mode in vp.MODES:
                    for fused in (True, False):
                        got = vp.vpu_peak(x, VP_A, VP_HOLD_ITERS, mode, fused, lanes=lanes,
                                          warps=warps)
                        plain = vp.vpu_peak_plain(x, VP_A, VP_HOLD_ITERS, mode, fused)
                        _require(torch.equal(got, plain),
                                 f"phase 1: vpu_peak {mode} fused={fused} N={lanes} "
                                 f"warps={warps} rows={rows} differs from its plain version by "
                                 f"{float((got - plain).abs().max())}")
                        held += 1
    # the entry's call: the unfused fma (what the port's kernels compile a * x + b to),
    # held against its plain version on the same x
    rows = vp.block_rows(sms, 4, VP_WARPS[1])
    x = 0.5 + 0.01 * torch.randn((rows, vp.COLS), generator=generator, device=dev)
    ms = _timed_mean(torch, lambda: vp.vpu_peak(x, VP_A, VP_ENTRY_ITERS, "fma", False,
                                                 lanes=4, warps=VP_WARPS[1]), 5)
    plain, plain_ms = _timed(
        torch, lambda: vp.vpu_peak_plain(x, VP_A, VP_ENTRY_ITERS, "fma", False))
    got = vp.vpu_peak(x, VP_A, VP_ENTRY_ITERS, "fma", False, lanes=4, warps=VP_WARPS[1])
    err = float((got - plain).abs().max())
    _require(bool(torch.isfinite(got).all()) and err == 0.0,
             f"phase 1: vpu_peak's entry call differs from its plain version by {err}")
    # the sweep, launches counted from 0
    vp.LAUNCHES["vpu_peak"] = 0
    rates = {}
    for warps in VP_WARPS:
        for lanes in vp.LANES:
            elements = sms * warps * 32 * lanes
            iters = max(16, round(VP_UPDATES / elements / 16) * 16)
            for mode in vp.MODES:
                for fused in (True, False):
                    rates[mode, fused, lanes, warps] = vp.updates_per_second(
                        mode, fused, lanes, warps, iters, device=dev)
    launches = vp.LAUNCHES["vpu_peak"]
    _require(launches == 4 * len(rates), f"phase 1: vpu_peak launches {launches}")
    # the SM clock while a long unfused launch (about half a second) runs
    long_iters = int(VP_UPDATES * 400 / x.numel())
    vp.vpu_peak(x, VP_A, long_iters, "fma", False, lanes=4, warps=VP_WARPS[1])
    time.sleep(0.1)
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    spec = sms * 128 * sm_mhz * 1e6  # one FMA instruction a lane a clock
    peaks["fp32_measured"] = {
        lanes: 2 * max(rates["fma", False, lanes, w] for w in VP_WARPS) for lanes in vp.LANES}
    bound = _bound(2 * x.numel() * 4, 2.0 * x.numel() * VP_ENTRY_ITERS, peaks, d=32 * 4)  # N = 4
    for warps in VP_WARPS:
        parts = []
        for lanes in vp.LANES:
            cells = [f"{mode} {'fused' if fused else 'unfused'} "
                     f"{rates[mode, fused, lanes, warps] / 1e9:.1f} "
                     f"({rates[mode, fused, lanes, warps] / spec:.3f})"
                     for mode in vp.MODES for fused in (True, False)]
            parts.append(f"N={lanes}: " + ", ".join(cells))
        print(f"phase 1: vpu_peak at {warps} warps an SM ({sms} blocks of {warps} warps), G "
              f"element-updates/s (share of the spec {spec / 1e12:.2f}e12: {sms} SMs x 128 lanes "
              f"x {sm_mhz:.0f} MHz, one FMA a lane a clock), two-point slope by CUDA events: "
              + "; ".join(parts) + f" ({smi})")
    print(f"phase 1: vpu_peak held bit for bit against its plain version in {held} cases "
          f"(both modes, both roundings, N = {', '.join(map(str, vp.LANES))}, a full grid and a "
          f"partial block, {' and '.join(map(str, VP_WARPS))} warps an SM, {VP_HOLD_ITERS} "
          f"iterations); SM clock under load {clock} (spec "
          f"{sm_mhz:.0f} MHz); measured FP32 rate (twice the unfused fma rate, the better warp "
          f"count) " + ", ".join(f"N={n} {r / 1e12:.2f}e12" for n, r in
                                  peaks["fp32_measured"].items())
          + f" ops/s against the spec {peaks['fp32'] / 1e12:.2f}e12; the entry's call (unfused "
          f"fma, N=4, {VP_WARPS[1]} warps, {x.numel()} elements x {VP_ENTRY_ITERS}) {ms:.4f} ms, "
          f"max_abs_err {err} against its plain version, "
          f"plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]}, measured bound "
          f"{bound[2]:.4f} ms; launches in the sweep {launches} ({smi})")
    return {"launches": launches, "err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound,
            "clock": clock}


def warm_start(torch, dev):
    """Phase 4's start, from which phases 4, 12 and 13 run: window
    adaptation of NUTS on the flagship (one chain, WARMUP_STEPS steps, torch
    seed SEED), then five NUTS transitions of C chains from 0.5 N(0, I) of
    numpy seed 1. Returns the positions, the step size, the metric, the
    adaptation's leaves and the seconds of each part."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.mcmc import nuts
    from blackjax_tpu_torch.models import hierarchical_gaussian
    from blackjax_tpu_torch.util import run_inference_algorithm

    flagship = hierarchical_gaussian(D)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmup = blackjax_tpu_torch.window_adaptation(
        nuts, flagship.logdensity_fn, max_num_doublings=MAX_DOUBLINGS,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}),
    )
    (_, params), warm_info = warmup.run(generator, torch.zeros(D, device=dev), WARMUP_STEPS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    step, imm = params["step_size"], params["inverse_mass_matrix"]
    algo = blackjax_tpu_torch.nuts(flagship.logdensity_fn, step_size=step,
                                   inverse_mass_matrix=imm, max_num_doublings=6)
    t0 = time.perf_counter()
    state, _ = run_inference_algorithm(generator, algo, 5,
                                       initial_position=flagship_init(torch, dev))
    torch.cuda.synchronize()
    return (state.position, step, imm, int(warm_info.info.num_integration_steps.sum()), warm_s,
            time.perf_counter() - t0)


def hmc_start(torch, dev):
    """Phase 6's start: window adaptation of the generic HMC pooled over C
    chains from 0.5 N(0, I) of numpy seed 1 (HMC_STEPS leapfrog steps,
    WARMUP_STEPS steps, torch seed SEED). Returns the positions, the step
    size, the metric, the generator that goes on into the sampling, the
    seconds and the mean acceptance."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.mcmc import hmc
    from blackjax_tpu_torch.models import hierarchical_gaussian

    generator = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmup = blackjax_tpu_torch.window_adaptation(
        hmc, hierarchical_gaussian(D).logdensity_fn, n_chains=C,
        num_integration_steps=HMC_STEPS,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"acceptance_rate"}),
    )
    (warm_state, params), warm_info = warmup.run(generator, flagship_init(torch, dev),
                                                 WARMUP_STEPS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    step, imm = params["step_size"], params["inverse_mass_matrix"]
    _require(np.isfinite(step) and step > 0, f"warmup step size {step}")
    _require(bool(torch.isfinite(imm).all() and (imm > 0).all()), "warmup metric")
    return (warm_state.position, step, imm, generator, warm_s,
            float(warm_info.info.acceptance_rate.mean()))


def hmc_path(torch, sampler, generator, positions):
    """Phase 6's sampling: HMC_TRANSITIONS transitions of ``sampler`` from
    ``positions`` on ``generator``, tracking the first NUM_TRACK coordinates
    and the acceptance rates. Returns them (stacked over transitions), the
    milliseconds by CUDA events and the seconds by the host clock."""
    from blackjax_tpu_torch.util import run_inference_algorithm

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (_, history), ms = _timed(torch, lambda: run_inference_algorithm(
        generator, sampler, HMC_TRANSITIONS, initial_position=positions,
        transform=lambda s, i: (s.positions[:, :NUM_TRACK], i.acceptance_rate)))
    return history, ms, time.perf_counter() - t0


def mclmc_start(torch, dev):
    """Phase 8's start: ``mclmc_find_L_and_step_size`` on one flagship chain
    (MCLMC_TUNE_STEPS steps' worth from zeros, torch seed SEED), then five
    ``mclmc`` transitions of C chains from 0.5 N(0, I) of numpy seed 1 on the
    same generator. Returns the positions, the momenta, L, the step size, the
    metric, the tuning steps and the seconds of each part."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch.mcmc import mclmc
    from blackjax_tpu_torch.models import hierarchical_gaussian
    from blackjax_tpu_torch.util import run_inference_algorithm

    flagship = hierarchical_gaussian(D)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tune_state = mclmc.init(torch.zeros(D, device=dev), flagship.logdensity_fn, generator)
    _, tuned, tune_total = blackjax_tpu_torch.mclmc_find_L_and_step_size(
        mclmc.build_kernel(), MCLMC_TUNE_STEPS, tune_state, generator,
        logdensity_fn=flagship.logdensity_fn)
    L, step, imm = float(tuned.L), float(tuned.step_size), tuned.inverse_mass_matrix
    tune_s = time.perf_counter() - t0
    _require(np.isfinite([L, step]).all() and L > 0 and step > 0,
             f"tuned L {L}, step size {step}")
    _require(bool(torch.isfinite(imm).all() and (imm > 0).all()), "tuned metric")
    algo = blackjax_tpu_torch.mclmc(flagship.logdensity_fn, L=L, step_size=step,
                                    inverse_mass_matrix=imm)
    t0 = time.perf_counter()
    state, _ = run_inference_algorithm(generator, algo, 5,
                                       initial_position=flagship_init(torch, dev))
    torch.cuda.synchronize()
    return (state.position, state.momentum, L, step, imm, tune_total, tune_s,
            time.perf_counter() - t0)


def eight_schools_start(torch, dev):
    """Phase 15's start: window adaptation of NUTS on non-centered eight
    schools (one chain from zeros, ES_WARMUP_STEPS steps, torch seed SEED on
    the card), and ES_CHAINS positions 0.1 N(0, I) of numpy seed 15. Returns
    the positions and the metric in the machine's layout
    (``eight_schools_dc_perm``), the step size, the adaptation's leaves and
    its seconds."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.mcmc import nuts
    from blackjax_tpu_torch.models import eight_schools_noncentered
    from blackjax_tpu_torch.ops.targets_dc import eight_schools_dc_perm

    generator = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmup = blackjax_tpu_torch.window_adaptation(
        nuts, eight_schools_noncentered().logdensity_fn,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}),
    )
    (_, params), warm_info = warmup.run(generator, torch.zeros(10, device=dev), ES_WARMUP_STEPS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    step, imm = params["step_size"], params["inverse_mass_matrix"]
    _require(np.isfinite(step) and step > 0, f"eight schools: warmup step size {step}")
    _require(bool(torch.isfinite(imm).all() and (imm > 0).all()), "eight schools: warmup metric")
    to_dc = torch.from_numpy(eight_schools_dc_perm()[0]).to(dev)
    x0 = np.zeros((ES_CHAINS, 10)) + 0.1 * np.random.default_rng(15).standard_normal(
        (ES_CHAINS, 10))
    x0 = torch.from_numpy(x0.astype(np.float32)).to(dev)[:, to_dc].contiguous()
    return (x0, step, imm[to_dc].contiguous(), int(warm_info.info.num_integration_steps.sum()),
            warm_s)


def _eight_schools_form(dc):
    """The form the plan gives eight schools under the diagonal metric."""
    return "thread" if dc._EIGHT_SCHOOLS_THREAD else "registers"


def eight_schools_path(torch, dev, es_target, peaks, smi):
    """Phase 15: the tracked eight-schools configuration end to end, with its
    gates and its line (see the head of this file). Returns the dc launches
    counted on the path, before the comparison launches, and the form the
    plan took."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    planned = _eight_schools_form(dc)
    other = "registers" if planned == "thread" else "thread"

    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    x15, step15, imm15, warm15_leaves, warm15_s = eight_schools_start(torch, dev)
    es_kw = dict(target=es_target, num_steps=ES_TRANSITIONS, max_num_doublings=ES_MAX_DOUBLINGS,
                 seed=SEED, num_track=10, pack=ES_PACK, restart_every=ES_RESTART_EVERY,
                 chunk=ES_CHUNK, budget=ES_BUDGET)
    (fx15, hist15, grads15, steps15), ms15 = _timed(
        torch, lambda: dc.fused_nuts_run_dc(x15, imm15, step15, **es_kw))
    launches15 = dict(dc.LAUNCHES)  # counted before the comparison launches
    ess15 = blackjax_tpu_torch.ess(hist15)
    min_ess15 = float(ess15.min())
    _require(launches15["fused_nuts_dc"] == 1 and launches15[f"fused_nuts_dc:{planned}"] == 1
             and launches15[f"fused_nuts_dc:{other}"] == 0,
             f"phase 15: the dc launches {launches15}, not one in the {planned} form")
    _require(bool((steps15 == ES_TRANSITIONS).all()),
             f"eight-schools chains short of {ES_TRANSITIONS} transitions: {int(steps15.min())}")
    for name, t in [("positions", fx15), ("history", hist15), ("ess", ess15)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite eight-schools {name}")
    _require(hist15.shape == (ES_CHAINS, ES_TRANSITIONS, 10), "eight-schools history shape")
    second15 = hist15[:, ES_TRANSITIONS // 2:].double()
    moments15 = {}
    for name, column in (("mu", 8), ("log_tau", 9)):  # the machine's layout [z(8), mu, log_tau]
        mean, var = float(second15[..., column].mean()), float(second15[..., column].var())
        ref_mean, ref_var, _ = ES_REFERENCE[name]
        _require(abs(mean - ref_mean) <= ES_MEAN_SD * ref_var**0.5,
                 f"eight schools: {name}'s second-half mean {mean} more than {ES_MEAN_SD} sd "
                 f"from the reference's {ref_mean}")
        _require(ES_VAR_RATIO[0] <= var / ref_var <= ES_VAR_RATIO[1],
                 f"eight schools: {name}'s second-half variance {var} against the reference's "
                 f"{ref_var}")
        moments15[name] = (mean, var)
    # the same inputs through both forms, per chain: every output bit for bit
    x32, metric15, machine15 = dc._prepare(x15, imm15, **es_kw)
    planned_out, planned_ms = _timed(
        torch, lambda: dc._launch_cuda(x32, metric15, float(step15), **machine15))
    dc._EIGHT_SCHOOLS_THREAD = other == "thread"
    try:
        before = dc.LAUNCHES[f"fused_nuts_dc:{other}"]
        other_out, other_ms = _timed(
            torch, lambda: dc._launch_cuda(x32, metric15, float(step15), **machine15))
        _require(dc.LAUNCHES[f"fused_nuts_dc:{other}"] == before + 1,
                 f"phase 15: the comparison did not take the {other} form")
    finally:
        dc._EIGHT_SCHOOLS_THREAD = planned == "thread"
    same15 = all(torch.equal(a, b) for a, b in zip(planned_out, other_out))
    digests = [hashlib.sha256(out[3].cpu().numpy().tobytes()).hexdigest()[:16]
               for out in (planned_out, other_out)]
    _require(same15 and digests[0] == digests[1],
             "phase 15: the thread form and the registers form differ")
    _require(torch.equal(planned_out[0], fx15) and torch.equal(planned_out[3], hist15)
             and torch.equal(planned_out[1], steps15)
             and float(planned_out[2].sum()) == float(grads15),
             "phase 15: the per-chain launch differs from the path's")
    # the plan's form against the plain version at the path's settings, cut
    # only in its transitions
    cut_kw = dict(es_kw, num_steps=ES_PLAIN_TRANSITIONS,
                  budget=160 * ES_PLAIN_TRANSITIONS * ES_PACK)
    before = dc.LAUNCHES[f"fused_nuts_dc:{planned}"]
    kern_cut, cut_ms = _per_chain(torch, dc, True, x15, imm15, step15, cut_kw)
    _require(dc.LAUNCHES[f"fused_nuts_dc:{planned}"] == before + 1,
             f"phase 15: the cut pair did not take the {planned} form")
    plain_cut, plain_cut_ms = _per_chain(torch, dc, False, x15, imm15, step15, cut_kw)
    cut_share, cut_share5, cut_err, cut_grads, cut_plain_grads, cut_other = _matrix_pair(
        torch, "phase 15's cut pair", kern_cut, plain_cut, ES_PLAIN_TRANSITIONS)
    iters15 = planned_out[4].double().cpu()
    secs15 = ms15 / 1e3
    grads15 = float(grads15)
    bound15 = _bound(2 * ES_CHAINS * 10 * 4 + hist15.numel() * 4 + 3 * ES_CHAINS * 4,
                     grads15 * (DC_LEAF_OPS * 10 + _grad_ops("eight_schools", 10)), peaks,
                     (grads15 + ES_CHAINS * ES_TRANSITIONS * 10) * THREEFRY_OPS, d=10)
    occ15 = {form: dc.occupancy(10, target=es_target.cuda_target, max_depth=ES_MAX_DOUBLINGS,
                                form=2 if form == "thread" else 0)
             for form in (planned, other)}
    occ_words = "; ".join(f"{form} form {o['warps_per_sm']} warps an SM, {o['registers']} "
                          f"registers, {o['local_bytes']} B local a thread"
                          for form, o in occ15.items())
    print(f"phase 15: window_adaptation(nuts, eight_schools_noncentered) single chain, "
          f"{ES_WARMUP_STEPS} steps, {warm15_leaves} leaves in {warm15_s:.2f} s "
          f"({warm15_s / warm15_leaves * 1e3:.2f} ms a leaf): step size {step15:.5f}, mean imm "
          f"{float(imm15.mean()):.5f}; fused_nuts_run_dc d=10 C={ES_CHAINS} S={ES_TRANSITIONS} "
          f"max_doublings={ES_MAX_DOUBLINGS} pack={ES_PACK} restart_every={ES_RESTART_EVERY} "
          f"budget={ES_BUDGET}, all 10 tracked: all chains completed, one launch in the plan's "
          f"{planned} form ({occ_words}): the call {ms15:.3f} ms by CUDA events (pack's lane "
          f"accounting on the host included; the launch alone {planned_ms:.3f} ms), "
          f"{grads15:.0f} grads ({grads15 / secs15:.4g} grads/s, "
          f"{grads15 / (ES_CHAINS * ES_TRANSITIONS):.3f} leaves per transition), min-ESS over "
          f"all 10 coordinates {min_ess15:.1f} ({min_ess15 / secs15:.4g} ESS/s); bound "
          f"{bound15[0]:.5f} ms by {bound15[1]} (launch / bound {planned_ms / bound15[0]:.1f}); "
          f"iterations a chain max {float(iters15.max()):.0f}, p99 "
          f"{float(np.percentile(iters15.numpy(), 99)):.0f}, mean {float(iters15.mean()):.1f}; "
          f"second-half mu mean {moments15['mu'][0]:.4f} var {moments15['mu'][1]:.4f}, log_tau "
          f"mean {moments15['log_tau'][0]:.4f} var {moments15['log_tau'][1]:.4f} (the JAX "
          f"package's NUTS: {ES_REFERENCE}; bands {ES_MEAN_SD} sd, variance ratio "
          f"{ES_VAR_RATIO}); the {planned} form and the {other} form on the same inputs: every "
          f"output bit for bit, history SHA-256 {digests[0]} / {digests[1]}, per-chain launches "
          f"{planned_ms:.3f} / {other_ms:.3f} ms; the {planned} form against the plain version "
          f"at these settings cut to {ES_PLAIN_TRANSITIONS} transitions (budget "
          f"{cut_kw['budget']}): steps identical, {cut_share:.4f} of chains agree to "
          f"{MATRIX_TOL} (floor {AGREE_FLOOR}; {cut_share5:.4f} to {AGREE_TOL}), max |diff| "
          f"{cut_err:.3g}, grads kernel {cut_grads:.0f} plain {cut_plain_grads:.0f} ({cut_other} "
          f"chains with other counts, all among those that part), kernel {cut_ms:.3f} ms, plain "
          f"{plain_cut_ms:.1f} ms; launches {launches15} ({smi})")
    return launches15, planned


def smc_init(torch, n, device, dtype):
    """Phase 16's starting particles: 3 N(0, I) of numpy seed 1, the first
    ``n`` of SMC_PARTICLES rows."""
    x = 3.0 * np.random.default_rng(1).standard_normal((SMC_PARTICLES, SMC_D))[:n]
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def smc_target(torch, device, dtype):
    """The tracked SMC target's log prior, N(0, 9 I), and log likelihood,
    N(obs, I): each maps ``(n, d)`` particles to ``(n,)``."""
    obs = torch.from_numpy(SMC_OBS).to(device=device, dtype=dtype)

    def logprior_fn(x):
        return -0.5 * (x**2).sum(-1) / 9.0

    def loglikelihood_fn(x):
        return -0.5 * ((x - obs) ** 2).sum(-1)

    return logprior_fn, loglikelihood_fn


def smc_run(torch, x0, key, waste_free=False, max_steps=SMC_MAX_STEPS):
    """One full run of the tracked SMC configuration from particles ``x0``,
    as ``benchmarks/tracked.py:591-616`` runs it: the host-paced loop that
    splits ``key`` into the next key and the step's key and reads lambda
    once a step. Returns the final state and each step's ``(state, info)``."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.mcmc import mala
    from blackjax_tpu_torch.smc import resampling
    from blackjax_tpu_torch.smc.waste_free import waste_free_smc

    logprior_fn, loglikelihood_fn = smc_target(torch, x0.device, x0.dtype)
    strategy = ({"update_strategy": waste_free_smc(x0.shape[0], SMC_WASTE_FREE_P)}
                if waste_free else {})
    algo = blackjax_tpu_torch.adaptive_tempered_smc(
        logprior_fn, loglikelihood_fn, mala.build_kernel(), mala.init,
        {"step_size": torch.full((1,), SMC_STEP_SIZE, dtype=x0.dtype, device=x0.device)},
        resampling.systematic, target_ess=SMC_TARGET_ESS,
        num_mcmc_steps=None if waste_free else SMC_MCMC_STEPS, **strategy)
    state = algo.init(x0)
    steps = []
    while float(state.tempering_param) < 1.0 and len(steps) < max_steps:
        key, step_key = prng.split(key)
        state, info = algo.step(step_key, state)
        steps.append((state, info))
    return state, steps


def smc_summary(torch, state, steps):
    """A run's lambda schedule, log Z (the sum of the log increments), the
    weighted posterior means and variances, and each step's mean MALA
    acceptance, on the host."""
    w = state.weights.double()
    x = state.particles.double()
    mean = (w[:, None] * x).sum(0)
    var = (w[:, None] * (x - mean) ** 2).sum(0)
    return {"lambdas": [float(step.tempering_param) for step, _ in steps],
            "log_z": float(sum(info.log_likelihood_increment.double() for _, info in steps)),
            "mean": mean.cpu().numpy(), "var": var.cpu().numpy(),
            "accept": [float(info.update_info.acceptance_rate.double().mean())
                       for _, info in steps]}


def smc_gates(torch, label, state, steps):
    """Phase 16's gates on one run (see the head of this file); returns its
    summary."""
    log_z_tol, mean_tol = SMC_GATES["waste-free" if label.startswith("waste-free") else
                                     "adaptive"]
    s = smc_summary(torch, state, steps)
    lams = s["lambdas"]
    _require(len(steps) <= SMC_MAX_STEPS and lams[-1] == 1.0,
             f"phase 16 {label}: lambda ends at {lams[-1]} after {len(steps)} steps")
    _require(all(b > a for a, b in zip([0.0] + lams, lams)),
             f"phase 16 {label}: lambda does not rise strictly: {lams}")
    tensors = [state.particles, state.weights, state.tempering_param] + [
        t for _, info in steps for t in (info.ancestors, info.log_likelihood_increment,
                                         *info.update_info)]
    _require(all(t.device.type == "cuda" for t in tensors),
             f"phase 16 {label}: a state or info tensor is on the CPU")
    _require(all(bool(torch.isfinite(t).all()) for t in tensors if t.is_floating_point()),
             f"phase 16 {label}: non-finite values")
    _require(abs(float(state.weights.double().sum()) - 1.0) <= 1e-5,
             f"phase 16 {label}: weights sum to {float(state.weights.double().sum())}")
    _require(abs(s["log_z"] - SMC_LOG_Z) <= log_z_tol,
             f"phase 16 {label}: log Z {s['log_z']} against {SMC_LOG_Z} (tolerance {log_z_tol})")
    mean_err = float(np.abs(s["mean"] - 0.9 * SMC_OBS).max())
    _require(mean_err <= mean_tol, f"phase 16 {label}: a mean {mean_err} from 0.9 obs")
    _require(bool(((s["var"] >= SMC_VAR_BAND[0]) & (s["var"] <= SMC_VAR_BAND[1])).all()),
             f"phase 16 {label}: variances {s['var']} outside {SMC_VAR_BAND}")
    _require(min(s["accept"]) > SMC_MIN_ACCEPT,
             f"phase 16 {label}: mean MALA acceptance {s['accept']}")
    s["mean_err"], s["var_err"] = mean_err, float(np.abs(s["var"] - 0.9).max())
    return s


def smc_step_parts(torch, state, repeats=20):
    """Where a tempering step from ``state`` spends its time: the median
    host-clock ms, around a synchronize, of ``repeats`` calls after a warm
    one, of each part of ``adaptive_tempered_smc``'s step and of the whole
    step, and the number of objective evaluations of the ESS solver."""
    import functools
    import statistics

    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.mcmc import mala
    from blackjax_tpu_torch.smc import adaptive_tempered, base, ess, resampling, solver
    from blackjax_tpu_torch.util import value_and_grad

    x, lam, n = state.particles, state.tempering_param, state.particles.shape[0]
    dev, dtype = x.device, x.dtype
    logprior_fn, loglikelihood_fn = smc_target(torch, dev, dtype)

    def target(y):
        return logprior_fn(y) + lam * loglikelihood_fn(y)

    evaluations = [0]

    def counted_dichotomy(fun, lo, hi):
        def counted(delta):
            evaluations[0] += 1
            return fun(delta)
        return solver.dichotomy(counted, lo, hi)

    kernel = mala.build_kernel()
    step_size = torch.tensor(SMC_STEP_SIZE, dtype=dtype, device=dev)
    keys = prng.split(prng.key(5, dev), n)
    mala_state = mala.init(x, target)
    update, _ = base.update_and_take_last(
        mala.init, target, functools.partial(kernel, step_size=step_size), SMC_MCMC_STEPS, n)
    step = adaptive_tempered.build_kernel(logprior_fn, loglikelihood_fn, kernel, mala.init,
                                          resampling.systematic, SMC_TARGET_ESS)
    params = {"step_size": torch.full((1,), SMC_STEP_SIZE, dtype=dtype, device=dev)}

    def reweight():
        log_weights = 0.1 * loglikelihood_fn(x)
        return torch.exp(log_weights - torch.logsumexp(log_weights, 0))

    parts = {
        "the ESS solver (a host loop of bisections)": lambda: ess.ess_solver(
            loglikelihood_fn, x, SMC_TARGET_ESS, 1.0 - lam, counted_dichotomy),
        "systematic resampling and the gather": lambda: x[
            resampling.systematic(prng.key(6, dev), state.weights, n)],
        "the particles' key split": lambda: prng.split(prng.key(7, dev), n),
        f"mala.init and {SMC_MCMC_STEPS} MALA moves": lambda: update(keys, x, {}),
        "one MALA move": lambda: kernel(keys, mala_state, target, step_size),
        "its value_and_grad": lambda: value_and_grad(target, x),
        "the reweight": reweight,
        "the whole step": lambda: step(prng.key(8, dev), state, SMC_MCMC_STEPS, params),
    }

    def ms(fn):
        fn()
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    times = {name: ms(fn) for name, fn in parts.items()}
    evaluations[0] = 0
    parts["the ESS solver (a host loop of bisections)"]()
    return times, evaluations[0]


def _device_busy(torch, fn):
    """One call of ``fn`` under torch.profiler (CUPTI): the summed durations
    of its device records (kernels, copies, sets), their number, and the
    call's host-clock milliseconds under the profiler. None where the trace
    holds no device record."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the profiler's own records: building its Python events takes about
        # 60 us each, a minute for a run of half a million launches
        records = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
    if not records:
        return None
    return sum(records) / 1e6, len(records), wall_ms


def smc_path(torch, dev, smi):
    """Phase 16: the tracked adaptive-tempered SMC configuration end to end,
    with its gates and its lines (see the head of this file). Returns the
    threefry launches counted on the path."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    x0 = smc_init(torch, SMC_PARTICLES, dev, torch.float32)

    def run(key, waste_free=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, steps = smc_run(torch, x0, key, waste_free)
        torch.cuda.synchronize()
        return state, steps, time.perf_counter() - t0

    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    runs = [("warm run (key 17)", *run(prng.key(17, dev)))]
    for i, key in enumerate(prng.split(prng.key(18, dev), 3)):
        runs.append((f"timed run {i} (split(key 18, 3)[{i}])", *run(key)))
    per_run = dc.LAUNCHES["threefry2x32"] / len(runs)
    runs.append(("waste-free run (key 19)", *run(prng.key(19, dev), waste_free=True)))
    launches16 = dict(dc.LAUNCHES)  # counted before the comparison's launches
    _require(launches16["threefry2x32"] > 0, "phase 16: the SMC path launched no threefry kernel")
    summaries = [(label, smc_gates(torch, label, state, steps), len(steps), secs)
                 for label, state, steps, secs in runs]
    timed = [(secs, n) for label, _, n, secs in summaries if label.startswith("timed")]
    best_s, best_steps = min(timed)
    for label, s, n, secs in summaries:
        moves = (f"waste_free_smc({SMC_PARTICLES}, {SMC_WASTE_FREE_P})"
                 if label.startswith("waste") else f"{SMC_MCMC_STEPS} MCMC steps")
        print(f"phase 16 {label}: adaptive_tempered_smc(mala) {moves}, {SMC_PARTICLES} particles x {SMC_D}, f32: {n} tempering steps, lambda "
              f"{', '.join(f'{lam:.6f}' for lam in s['lambdas'])}; log Z {s['log_z']:.5f} "
              f"(exact {SMC_LOG_Z:.5f}, error {s['log_z'] - SMC_LOG_Z:+.5f}); largest |mean - "
              f"0.9 obs| {s['mean_err']:.5f}, largest |var - 0.9| {s['var_err']:.5f} (variances "
              f"{float(s['var'].min()):.4f}-{float(s['var'].max()):.4f}); mean acceptance a step "
              f"{', '.join(f'{a:.4f}' for a in s['accept'])}; {secs:.4f} s by host clock, "
              f"{secs / n * 1e3:.3f} ms a tempering step ({smi})")
    busy = _device_busy(torch, lambda: smc_run(torch, x0, prng.split(prng.key(18, dev), 3)[0]))
    busy_words = "not measured (no device record in the trace)" if busy is None else (
        f"{busy[0]:.3f} ms of device records ({busy[1]} records) in a {busy[2]:.3f} ms run "
        f"under torch.profiler: busy {busy[0] / busy[2]:.4f} of it, {busy[0] / (best_s * 1e3):.4f} "
        f"of the best run's time")
    print(f"phase 16: runs/sec (full tempering) {1.0 / best_s:.4f}, best of 3 timed runs "
          f"{best_s:.4f} s ({best_steps} steps, {best_s / best_steps * 1e3:.3f} ms a tempering step "
          f"by host clock); threefry launches {per_run:.1f} a run, "
          f"{launches16['threefry2x32']} on the path (warm, 3 timed and waste-free runs); "
          f"device {busy_words} ({smi})")
    step3 = runs[1][2][2][0]  # timed run 0's state after its third step
    parts, evaluations = smc_step_parts(torch, step3)
    print(f"phase 16 a tempering step's parts, from timed run 0's state after its third step "
          f"(lambda {float(step3.tempering_param):.6f}), medians of 20 by host clock: "
          + "; ".join(f"{name} {t:.3f} ms" for name, t in parts.items())
          + f"; the solver evaluates its objective {evaluations} times, reading each to the "
          f"host ({smi})")

    # the card against the port on the CPU: the same run in float64 at
    # SMC_CMP_PARTICLES particles on the same key
    xc = smc_init(torch, SMC_CMP_PARTICLES, "cpu", torch.float64)
    card_state, card_steps = smc_run(torch, xc.to(dev), prng.key(18, dev))
    cpu_state, cpu_steps = smc_run(torch, xc, prng.key(18))
    _require(len(card_steps) == len(cpu_steps),
             f"phase 16 f64: {len(card_steps)} steps on the card, {len(cpu_steps)} on the CPU")
    lam_err = x_err = 0.0
    for (card, card_info), (cpu, cpu_info) in zip(card_steps, cpu_steps):
        _require(torch.equal(card_info.ancestors.cpu(), cpu_info.ancestors),
                 "phase 16 f64: ancestors differ between the card and the CPU")
        lam_err = max(lam_err, abs(float(card.tempering_param) - float(cpu.tempering_param)))
        x_err = max(x_err, float((card.particles.cpu() - cpu.particles).abs().max()))
    _require(lam_err <= 1e-10 and x_err <= SMC_CMP_TOL,
             f"phase 16 f64: lambda {lam_err}, particles {x_err} between the card and the CPU")
    print(f"phase 16 f64 hold, {SMC_CMP_PARTICLES} particles, key 18: the card and the port on "
          f"the CPU take {len(card_steps)} steps each, ancestors identical at every step, "
          f"largest lambda difference {lam_err:.3g} (tolerance 1e-10), largest particle "
          f"difference {x_err:.3g} (tolerance {SMC_CMP_TOL}); launches {launches16} ({smi})")
    return launches16["threefry2x32"]


def family_algorithms(bj, asarray, normal, d):
    """Phase 17's samplers, built by the package ``bj`` on the
    ill-conditioned Gaussian of width ``d`` (variances logspace(-1, 1, d)):
    name -> (algorithm, whether ``init`` takes a key). ``asarray`` makes the
    package's arrays from numpy, ``normal(key, shape)`` its standard normals
    of a key; ``elliptical_slice`` and ``mgrad_gaussian`` take the prior N(0,
    diag(var)) and a likelihood N(1, 1) per coordinate. The JAX package's
    counterpart of this run (tools/mcmc_family_reference.py) builds the same
    samplers through this function."""
    var = asarray(np.logspace(-1.0, 1.0, d))
    ones, zeros = asarray(np.ones(d)), asarray(np.zeros(d))

    def logdensity(x):
        return -0.5 * (x**2 / var).sum(-1)

    def loglikelihood(x):
        return -0.5 * ((x - 1.0) ** 2).sum(-1)

    def irmh_draw(key):
        return FAM_IRMH_SCALE * var**0.5 * normal(key, (d,))

    def irmh_logdensity(new, old):  # log q(new -> old): the proposal's density at old
        return -0.5 * (old.position**2 / (FAM_IRMH_SCALE**2 * var)).sum(-1)

    step, steps = FAM_STEP_SIZE, FAM_STEPS
    return {
        "hmc": (bj.hmc(logdensity, step, ones, steps), False),
        "mhmc": (bj.mhmc(logdensity, step, ones, steps), False),
        "dhmc": (bj.dhmc(logdensity, step, ones), True),
        "ghmc": (bj.ghmc(logdensity, step, ones, 0.05, 0.01), True),
        "barker": (bj.barker(logdensity, 0.2), False),
        "normal_random_walk": (bj.normal_random_walk(logdensity, 0.08), False),
        "irmh": (bj.irmh(logdensity, irmh_draw, irmh_logdensity), False),
        "adjusted_mclmc": (bj.adjusted_mclmc(
            logdensity, FAM_MCLMC_STEP, num_integration_steps=FAM_MCLMC_STEPS), False),
        "adjusted_mclmc_dynamic": (bj.adjusted_mclmc_dynamic(logdensity, FAM_MCLMC_STEP), True),
        "elliptical_slice": (bj.elliptical_slice(loglikelihood, mean=zeros, cov=var), False),
        "slice_sampling": (bj.slice_sampling(logdensity), False),
        "coordinate_slice": (bj.coordinate_slice(logdensity), False),
        "orbital_hmc": (bj.orbital_hmc(logdensity, step, ones, FAM_PERIOD), False),
        "mgrad_gaussian": (bj.mgrad_gaussian(
            loglikelihood, covariance=asarray(np.diag(np.logspace(-1.0, 1.0, d))),
            step_size=FAM_MGRAD_DELTA), False),
        "gist_step_size": (bj.gist_step_size(logdensity, ones, step, steps), False),
        "gist_trajectory_length": (bj.gist_trajectory_length(logdensity, ones, step), False),
    }


def family_statistic(name, info):
    """What phase 17 reads of a transition's info: the acceptance rate (the
    slice samplers and elliptical slice have none: mean ``num_shrink`` and
    ``subiter``), and the count it holds identical between the card and the
    CPU."""
    if name == "elliptical_slice":
        return info.subiter, ("subiter",)
    if name in ("slice_sampling", "coordinate_slice"):
        return info.num_shrink, ("is_accepted", "num_expansions", "num_shrink")
    if name == "orbital_hmc":
        return None, ()
    drawn = ("num_integration_steps",) if name in ("dhmc", "adjusted_mclmc_dynamic") else ()
    if name == "gist_step_size":
        drawn = ("step_index", "reverse_step_index", "search_exhausted")
    if name == "gist_trajectory_length":
        drawn = ("num_integration_steps", "num_steps_to_uturn_forward",
                 "num_steps_to_uturn_reverse")
    return info.acceptance_rate, ("is_accepted",) + drawn


def _samples(state):
    """A state's draws and their weights: ``(C, d)`` and None, or periodic
    orbital's weighted orbits ``(C, period, d)`` and ``(C, period)``."""
    if hasattr(state, "positions"):
        return state.positions, state.weights
    return state.position, None


def _weighted_moments(x, w):
    x = x.double()
    if w is None:
        return x.mean(0), x.var(0, correction=0)
    w = w.double()[..., None] / w.shape[0]
    mean = (w * x).sum((0, 1))
    return mean, (w * (x - mean) ** 2).sum((0, 1))


def family_run(algo, keys_of, state, n):
    """``n`` transitions of ``algo`` on the tracked keys: the last state and
    info."""
    info = None
    for i in range(n):
        state, info = algo.step(keys_of(i), state)
    return state, info


def _on_card(torch, tree):
    from blackjax_tpu_torch.util import tree_leaves

    leaves = [x for x in tree_leaves(tuple(tree)) if torch.is_tensor(x)]
    return all(x.is_cuda for x in leaves), all(
        bool(torch.isfinite(x).all()) for x in leaves if x.is_floating_point())


def family_path(torch, dev, smi):
    """Phase 17: the tracked static-HMC configuration through ``hmc`` (cut)
    and ``fused_hmc`` (all 131,072 transitions), and every new sampler on
    the card, with their gates and lines (see the head of this file).
    Returns the threefry launches and the transition kernel's launches."""
    import importlib

    import blackjax_tpu_torch
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    lf = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
    dtype = torch.float32
    x0 = torch.from_numpy(0.5 * np.random.default_rng(FAM_X0_SEED).standard_normal(
        (FAM_CHAINS, FAM_D))).to(dtype).to(dev)
    var = np.logspace(-1.0, 1.0, FAM_D)

    def build(dtype):
        def on_card(values):
            return torch.from_numpy(np.asarray(values)).to(dtype).to(dev)

        return family_algorithms(blackjax_tpu_torch, on_card,
                                 lambda key, shape: prng.normal(key, shape, dtype), FAM_D)

    algorithms = build(dtype)
    algorithms.update({name: build(torch.float64)[name] for name in FAM_F64})
    run_key = prng.split(prng.key(8, dev), 4)[0]
    step_keys = prng.split(run_key, FAM_TRACKED_TRANSITIONS)  # tracked.py:134

    def keys_of(i):
        return prng.split(step_keys[i], FAM_CHAINS)

    init_keys = prng.split(prng.key(9, dev), FAM_CHAINS)
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    threefry17 = 0
    for name, (algo, keyed_init) in algorithms.items():
        n = FAM_TRANSITIONS[name]
        start = x0.double() if name in FAM_F64 else x0
        state0 = algo.init(start, init_keys) if keyed_init else algo.init(start)
        before = dc.LAUNCHES["threefry2x32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats, state, info = [], state0, None
        for i in range(n):
            state, info = algo.step(keys_of(i), state)
            stat, _ = family_statistic(name, info)
            if stat is not None:
                stats.append(stat)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dc.LAUNCHES["threefry2x32"] - before
        threefry17 += launches
        card, finite = _on_card(torch, tuple(state) + tuple(info))
        _require(card, f"phase 17 {name}: a state or info tensor is not on the card")
        _require(finite, f"phase 17 {name}: non-finite values")
        _require(launches > 0, f"phase 17 {name}: no threefry launch")
        mean_stat = float(torch.stack(stats).double().mean()) if stats else None
        busy_n = FAM_BUSY_SHORT.get(name, FAM_BUSY_TRANSITIONS)
        busy = _device_busy(torch, lambda: family_run(algo, keys_of, state, busy_n))
        x, w = _samples(state)
        mean, variance = _weighted_moments(x, w)
        z = float((mean.cpu() / np.sqrt(var)).abs().max())
        ratio = variance.cpu().numpy() / var
        if mean_stat is not None:
            ref = FAM_REFERENCE[name]
            width = FAM_COUNT_BAND * ref if name in FAM_COUNTED else FAM_BAND_WIDTH
            _require(abs(mean_stat - ref) <= width,
                     f"phase 17 {name}: mean statistic {mean_stat} outside {ref} +- {width}")
        stat_name = {"elliptical_slice": "mean subiter",
                     "slice_sampling": "mean num_shrink",
                     "coordinate_slice": "mean num_shrink (a sweep)"}.get(name, "mean acceptance")
        extra = ""
        if name in ("slice_sampling", "coordinate_slice"):
            extra = f", last transition's mean num_expansions {float(info.num_expansions.double().mean()):.3f}"
        busy_words = "not measured (no device record)" if busy is None else (
            f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
            f"{busy[0] / busy[2]:.4f}")
        stat_words = "no acceptance (weighted orbit)" if mean_stat is None else (
            f"{stat_name} {mean_stat:.4f} (the JAX package on the CPU {FAM_REFERENCE[name]:.4f})")
        print(f"phase 17 {name}: {FAM_CHAINS} chains x {FAM_D}, "
              f"{'f64' if name in FAM_F64 else 'f32'}, {n} transitions in "
              f"{secs:.3f} s: {FAM_CHAINS * n / secs:.1f} transitions/sec (chains x transitions), "
              f"{secs / n * 1e3:.3f} host ms a transition, {launches / n:.2f} threefry launches a "
              f"transition; device over {busy_n} transitions {busy_words}; {stat_words}{extra}; "
              f"last state's largest |mean| / sd {z:.3f}, variance / target's "
              f"{ratio.min():.3f}-{ratio.max():.3f} ({smi})")

    # the same configuration through fused_hmc: all 131,072 transitions
    for name in lf.LAUNCHES:
        lf.LAUNCHES[name] = 0
    fused = blackjax_tpu_torch.fused_hmc(lf.make_gaussian_target(FAM_D, var), FAM_STEP_SIZE,
                                         torch.ones(FAM_D, device=dev), FAM_STEPS)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    state = fused.init(x0)
    s1 = torch.zeros(FAM_D, dtype=torch.float64, device=dev)
    s2 = torch.zeros(FAM_D, dtype=torch.float64, device=dev)
    accept = torch.zeros((), dtype=torch.float64, device=dev)
    kept = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(FAM_TRACKED_TRANSITIONS):
        state, info = fused.step(generator, state)
        if i >= FAM_FUSED_BURN and i % FAM_FUSED_THIN == 0:
            x = state.positions.double()
            s1 += x.sum(0)
            s2 += (x * x).sum(0)
            accept += info.acceptance_rate.double().sum()
            kept += 1
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    transition_launches = lf.LAUNCHES["fused_leapfrog:hmc_transition"]
    _require(transition_launches == FAM_TRACKED_TRANSITIONS,
             f"phase 17 fused_hmc: {transition_launches} transition launches")
    card, finite = _on_card(torch, tuple(state) + tuple(info))
    _require(card and finite, "phase 17 fused_hmc: a tensor off the card or not finite")
    n_draws = kept * FAM_CHAINS
    fmean = (s1 / n_draws).cpu().numpy()
    fvar = (s2 / n_draws).cpu().numpy() - fmean**2
    fratio = fvar / var
    faccept = float(accept) / n_draws
    _require(FAM_FUSED_VAR_BAND[0] <= fratio.min() and fratio.max() <= FAM_FUSED_VAR_BAND[1],
             f"phase 17 fused_hmc: variance / target's {fratio.min()}-{fratio.max()} outside "
             f"{FAM_FUSED_VAR_BAND}")
    _require(abs(faccept - FAM_REFERENCE["fused_hmc"]) <= FAM_BAND_WIDTH,
             f"phase 17 fused_hmc: mean acceptance {faccept}")
    busy = _device_busy(torch, lambda: [fused.step(generator, state) for _ in range(64)])
    busy_words = "not measured (no device record)" if busy is None else (
        f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
        f"{busy[0] / busy[2]:.4f}")
    print(f"phase 17 fused_hmc (the registry's fused form, make_gaussian_target({FAM_D}, "
          f"variances)): {FAM_CHAINS} chains, all {FAM_TRACKED_TRANSITIONS} transitions in "
          f"{fused_s:.3f} s: {FAM_CHAINS * FAM_TRACKED_TRANSITIONS / fused_s:.1f} transitions/sec "
          f"(chains x transitions), {fused_s / FAM_TRACKED_TRANSITIONS * 1e3:.4f} host ms a "
          f"transition (with the moments' sums every {FAM_FUSED_THIN}th), "
          f"{transition_launches} launches of the transition kernel, 0 threefry (a "
          f"torch.Generator draws); device over 64 transitions {busy_words}; mean acceptance "
          f"{faccept:.4f}; over {kept} kept transitions after {FAM_FUSED_BURN}: largest |mean| / "
          f"sd {float(np.abs(fmean / np.sqrt(var)).max()):.4f}, variance / target's "
          f"{fratio.min():.4f}-{fratio.max():.4f} (band {FAM_FUSED_VAR_BAND}) ({smi})")

    # the card against the port on the CPU: f64, FAM_CMP_CHAINS chains of the
    # d = FAM_CMP_D configuration, FAM_CMP_TRANSITIONS transitions on the same keys
    def f64_run(device):
        asarray = lambda v: torch.from_numpy(np.asarray(v, dtype=np.float64)).to(device)  # noqa: E731
        algos = family_algorithms(blackjax_tpu_torch, asarray, lambda key, shape: prng.normal(
            key, shape, torch.float64), FAM_CMP_D)
        xc = asarray(0.5 * np.random.default_rng(FAM_X0_SEED).standard_normal(
            (FAM_CMP_CHAINS, FAM_CMP_D)))
        keys = prng.split(prng.split(prng.key(8, device), 4)[0], FAM_CMP_TRANSITIONS)
        ikeys = prng.split(prng.key(9, device), FAM_CMP_CHAINS)
        out = {}
        for name, (algo, keyed_init) in algos.items():
            st = algo.init(xc, ikeys) if keyed_init else algo.init(xc)
            trace = []
            for i in range(FAM_CMP_TRANSITIONS):
                st, inf = algo.step(prng.split(keys[i], FAM_CMP_CHAINS), st)
                _, exact = family_statistic(name, inf)
                trace.append((_samples(st)[0].cpu(), [getattr(inf, f).cpu() for f in exact]))
            out[name] = trace
        return out

    card_runs, cpu_runs = f64_run(dev), f64_run("cpu")
    worst = 0.0
    for name in card_runs:
        for (xa, fa), (xb, fb) in zip(card_runs[name], cpu_runs[name]):
            _require(all(torch.equal(a, b) for a, b in zip(fa, fb)),
                     f"phase 17 f64 {name}: flags or counts differ between the card and the CPU")
            err = float((xa - xb).abs().max())
            _require(err <= FAM_CMP_TOL, f"phase 17 f64 {name}: positions differ by {err}")
            worst = max(worst, err)
    print(f"phase 17 f64 hold: every sampler ({len(card_runs)}), {FAM_CMP_CHAINS} chains x "
          f"{FAM_CMP_D} for {FAM_CMP_TRANSITIONS} transitions on the same keys, the card against "
          f"the port on the CPU: accept flags, drawn step counts, subiter and the slice counts "
          f"identical, largest position difference {worst:.3g} (tolerance {FAM_CMP_TOL}); "
          f"threefry launches on the path {threefry17}, transition kernel launches "
          f"{transition_launches} ({smi})")
    return threefry17, transition_launches


def sgld_model(torch):
    """The tracked configurations' log prior and the log-likelihood of ONE
    data point (tracked.py:501-507, which the reference maps over a
    minibatch's points), for positions ``(..., 54)``: ``(logprior_fn,
    loglikelihood_fn)``."""

    def logprior_fn(w):
        return -0.5 * (w**2).sum(-1)

    def loglikelihood_fn(w, point):
        x, y = point
        logits = w @ x
        return y * logits - torch.logaddexp(torch.zeros_like(logits), logits)

    return logprior_fn, loglikelihood_fn


def sgld_dataset(torch, prng, device, dtype):
    """``logistic_regression(num_points=4096, dim=54)`` of key 0, drawn on
    ``device`` from the reference's key words: ``(X, y)``."""
    from blackjax_tpu_torch.models import logistic_regression

    _, X, y = logistic_regression(prng.key(0, device), SG_N, SG_D, dtype=dtype)
    return X, y


def _sgmcmc_algorithm(bj, torch, name, data_size):
    logprior_fn, loglikelihood_fn = sgld_model(torch)
    grad = bj.sgmcmc.gradients.grad_estimator(logprior_fn, loglikelihood_fn, data_size)
    if name == "sgld":
        return bj.sgld(grad)
    if name == "sghmc":
        return bj.sghmc(grad, num_integration_steps=5)
    if name == "sgnht":
        return bj.sgnht(grad)
    estimate = bj.sgmcmc.gradients.logdensity_estimator(logprior_fn, loglikelihood_fn, data_size)
    return bj.csgld(estimate, grad)


def _index_dtype(torch, X):
    """The minibatch indices' dtype: JAX's default integer, int64 under x64
    (an f64 run) and int32 without (the f32 configurations), whose
    ``randint`` draws other numbers from the same keys."""
    return torch.int64 if X.dtype == torch.float64 else torch.int32


def sgld_single(torch, bj, prng, X, y, num_steps, batch):
    """``config_sgld``'s run on ``(X, y)``'s device (tracked.py:509-530,
    its first variant): the minibatch indices ``randint(split(key(13),
    num_steps)[i], (batch,), 0, 4096)``, the step keys ``split(key(14),
    num_steps)``, the start ``0.01 N(0, I)`` of ``split(key(15), 4)[0]``.
    Returns the final position and the indices ``(num_steps, batch)``."""
    dev, (data_size, d) = X.device, X.shape
    step = _sgmcmc_algorithm(bj, torch, "sgld", data_size).step
    batch_idx = prng.randint(prng.split(prng.key(13, dev), num_steps), (batch,), 0, data_size,
                             _index_dtype(torch, X))
    step_keys = prng.split(prng.key(14, dev), num_steps)
    w = 0.01 * prng.normal(prng.split(prng.key(15, dev), 4)[0], (d,), X.dtype)
    for i in range(num_steps):
        idx = batch_idx[i]
        w = step(step_keys[i], w, (X[idx], y[idx]), SG_STEP_SIZE)
    return w, batch_idx


def sgmcmc_chains(torch, bj, prng, X, y, name, num_chains, num_steps, batch, trace=False):
    """``config_sgld_chains``'s run (tracked.py:815-833, its first variant)
    through the sampler ``name`` on ``(X, y)``'s device: the start ``0.1 N(0,
    I)`` of key 25, the run key ``split(key(26), 4)[0]`` split a step, each
    step's key split into the minibatch's (``randint(k, (batch,), 0, 4096)``)
    and the chains' (``split(k, num_chains)``); ``sgnht`` starts its momenta
    from ``split(key(27), num_chains)``. Returns the final state, the
    indices ``(num_steps, batch)`` and, with ``trace``, every step's
    positions."""
    dev, (data_size, d) = X.device, X.shape
    algo = _sgmcmc_algorithm(bj, torch, name, data_size)
    w0 = 0.1 * prng.normal(prng.key(25, dev), (num_chains, d), X.dtype)
    state = (algo.init(w0, prng.split(prng.key(27, dev), num_chains)) if name == "sgnht"
             else algo.init(w0))
    run_keys = prng.split(prng.split(prng.key(26, dev), 4)[0], num_steps)
    idx_keys, chain_keys = prng.split(run_keys).unbind(-2)
    batch_idx = prng.randint(idx_keys, (batch,), 0, data_size, _index_dtype(torch, X))
    path = []
    for i in range(num_steps):
        idx = batch_idx[i]
        state = algo.step(prng.split(chain_keys[i], num_chains), state, (X[idx], y[idx]),
                          SG_STEP_SIZE)
        if trace:
            path.append(state if torch.is_tensor(state) else state.position)
    return state, batch_idx, path


def sgmcmc_path(torch, dev, smi):
    """Phase 18: the two tracked SGLD configurations at their chip sizes on
    the reference's dataset, their gates, lines and busy shares, then the f64
    hold of every SG-MCMC sampler, the card against the CPU (see the head of
    this file). Returns the threefry launches of the two runs."""
    import blackjax_tpu_torch as bj
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    X, y = sgld_dataset(torch, prng, dev, torch.float32)
    _require(X.is_cuda and y.is_cuda, "phase 18: the dataset is not on the card")
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    lines, threefry18 = [], 0
    for label, steps, chains in (("config_sgld", SG_STEPS, 1),
                                 ("config_sgld_chains", SG_CHAINS_STEPS, SG_CHAINS)):
        before = dc.LAUNCHES["threefry2x32"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if chains == 1:
            w, idx = sgld_single(torch, bj, prng, X, y, steps, SG_BATCH)
        else:
            w, idx, _ = sgmcmc_chains(torch, bj, prng, X, y, "sgld", chains, steps,
                                      SG_CHAINS_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dc.LAUNCHES["threefry2x32"] - before
        threefry18 += launches
        _require(w.is_cuda and bool(torch.isfinite(w).all()),
                 f"phase 18 {label}: the positions are off the card or not finite")
        _require(launches > 0, f"phase 18 {label}: no threefry launch")
        final = w.double().cpu().numpy()
        if chains == 1:
            ref, scale = SG_REFERENCE["final"], SG_REFERENCE["second_half_sd"]
            off = float((np.abs(final - ref) / scale).max())
            band, what = SG_SINGLE_BAND, "final position"
            unit, rate = "updates/sec", steps / secs
        else:
            ref, scale = SG_REFERENCE["mean"], SG_REFERENCE["sd"] / np.sqrt(chains)
            off = float((np.abs(final.mean(0) - ref) / scale).max())
            band, what = SG_CHAINS_BAND, "mean over the chains"
            unit, rate = "chain-updates/sec", chains * steps / secs
        _require(off <= band, f"phase 18 {label}: the {what} is {off} band units from the JAX "
                              f"package's (band {band})")
        busy_w = w.clone()

        def busy_run():
            logprior_fn, loglik = sgld_model(torch)
            step = bj.sgld(bj.sgmcmc.gradients.grad_estimator(logprior_fn, loglik, SG_N)).step
            keys = prng.split(prng.key(28, dev), SG_BUSY_STEPS)
            v = busy_w
            for i in range(SG_BUSY_STEPS):
                k = prng.split(keys[i], chains) if chains > 1 else keys[i]
                v = step(k, v, (X[idx[i]], y[idx[i]]), SG_STEP_SIZE)
            return v

        busy = _device_busy(torch, busy_run)
        busy_words = "not measured (no device record)" if busy is None else (
            f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
            f"{busy[0] / busy[2]:.4f}")
        lines.append(
            f"phase 18 {label}: sgld on logistic_regression({SG_N} x {SG_D}) of key 0, "
            f"{chains} chain{'s' if chains > 1 else ''}, {steps} steps, batch "
            f"{SG_BATCH if chains == 1 else SG_CHAINS_BATCH}, step size {SG_STEP_SIZE}, f32, in "
            f"{secs:.3f} s: {rate:.1f} {unit}, {secs / steps * 1e3:.4f} host ms a step, "
            f"{launches / steps:.2f} threefry launches a step; device over {SG_BUSY_STEPS} steps "
            f"{busy_words}; {what} within {off:.3g} of the JAX package's on the CPU (band "
            f"{band} {'second-half sd' if chains == 1 else 'standard errors'}) ({smi})")
    for line in lines:
        print(line)

    # the card against the port on the CPU: f64, every sampler at the cut size,
    # the dataset drawn once on the CPU
    X64, y64 = sgld_dataset(torch, prng, "cpu", torch.float64)
    worst = {}
    for name in SG_SAMPLERS:
        runs = [sgmcmc_chains(torch, bj, prng, X64.to(device), y64.to(device), name,
                              SG_CMP_CHAINS, SG_CMP_STEPS, SG_CMP_BATCH, trace=True)
                for device in (dev, "cpu")]
        (card_state, card_idx, card_path), (cpu_state, cpu_idx, cpu_path) = runs
        _require(torch.equal(card_idx.cpu(), cpu_idx),
                 f"phase 18 f64 {name}: minibatch indices differ between the card and the CPU")
        if name == "csgld":
            _require(torch.equal(card_state.energy_idx.cpu(), cpu_state.energy_idx),
                     "phase 18 f64 csgld: energy bins differ between the card and the CPU")
        worst[name] = max(float((a.cpu() - b).abs().max()) for a, b in zip(card_path, cpu_path))
        _require(worst[name] <= SG_CMP_TOL,
                 f"phase 18 f64 {name}: positions differ by {worst[name]}")
    print(f"phase 18 f64 hold: {', '.join(SG_SAMPLERS)} on config_sgld_chains' keys, "
          f"{SG_CMP_CHAINS} chains x {SG_CMP_STEPS} steps, batch {SG_CMP_BATCH}, the card "
          f"against the port on the CPU: minibatch indices identical, largest position "
          f"difference " + ", ".join(f"{n} {e:.3g}" for n, e in worst.items())
          + f" (tolerance {SG_CMP_TOL}); threefry launches on the two runs {threefry18} ({smi})")
    return threefry18


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import importlib

    import blackjax_tpu_torch
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.mcmc import mclmc, nuts
    from blackjax_tpu_torch.models import hierarchical_gaussian
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.mcmc import integrators
    from blackjax_tpu_torch.ops import counter_rng
    from blackjax_tpu_torch.ops import fused_nuts as fn
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc
    from blackjax_tpu_torch.ops import vpu_peak as vp

    lf = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
    fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: card and build ----
    marks = [(1, time.perf_counter())]  # (phase, host clock at its start)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # FP32 outside the tensor cores: 128 lanes a multiply-add per clock; INT32
    # 64; special functions and conversions 16
    peaks = {"fp32": sms * 128 * 2 * sm_mhz * 1e6, "int32": sms * 64 * sm_mhz * 1e6,
             "sfu": sms * 16 * sm_mhz * 1e6}

    def build(module):
        t = time.perf_counter()
        log = module.build()
        return time.perf_counter() - t, log

    t0 = time.perf_counter()
    # one nvcc per source: dc.build() starts its three (one per metric) itself
    with ThreadPoolExecutor(max_workers=5) as pool:
        builds = [pool.submit(build, module) for module in (dc, lf, fm, fn, vp)]
        (dc_s, dc_log), (lf_s, lf_log), (fm_s, fm_log), (fn_s, fn_log), (vp_s, vp_log) = (
            b.result() for b in builds)
    build_s = time.perf_counter() - t0
    print(f"phase 1: card {kind!r} ({smi}); built the seven sources in {build_s:.2f} s: "
          f"csrc/fused_nuts_dc.cu, fused_nuts_dc_dense.cu and fused_nuts_dc_low_rank.cu "
          f"{dc_s:.2f} s, ptxas {'; '.join(_ptxas_summary(dc_log))}; "
          f"csrc/fused_leapfrog.cu {lf_s:.2f} s, ptxas {'; '.join(_ptxas_summary(lf_log))}; "
          f"csrc/fused_mclmc.cu {fm_s:.2f} s, ptxas {'; '.join(_ptxas_summary(fm_log))}; "
          f"csrc/fused_nuts.cu {fn_s:.2f} s, ptxas {'; '.join(_ptxas_summary(fn_log))}; "
          f"csrc/vpu_peak.cu {vp_s:.2f} s, ptxas {'; '.join(_ptxas_summary(vp_log))}")
    vpu = vpu_peak_phase(torch, vp, dev, sms, sm_mhz, peaks, smi)

    # ---- phase 2: threefry export, bit for bit ----
    marks.append((2, time.perf_counter()))
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (2, 100_000), dtype=np.uint64).astype(np.int64)
    words[:, :16] = 2**32 - 1 - np.arange(16)
    c0, c1 = torch.from_numpy(words[0]), torch.from_numpy(words[1])
    on_card = dc.threefry2x32_device(SEED, counter_rng.KEY1, c0.to(dev), c1.to(dev))
    plain = counter_rng.threefry2x32(SEED, counter_rng.KEY1, c0, c1)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, plain))
    _require(same, "threefry2x32 device function != plain version")
    # the MCLMC kernel's refresh noise: chains 5.., the refresh after step 17
    mw1, mw2, mz = fm.counter_normals_device(SEED, 5, 2 * 17 + 1, C, D, dev)
    pw1, pw2, pz = fm.counter_normals_device(SEED, 5, 2 * 17 + 1, C, D, "cpu")
    words_same = torch.equal(mw1.cpu(), pw1) and torch.equal(mw2.cpu(), pw2)
    _require(words_same, "MCLMC counter-normal words != plain version")
    z_err = float((mz.cpu() - pz).abs().max())
    z_same = float((mz.cpu() == pz).float().mean())
    _require(torch.allclose(mz.cpu(), pz, rtol=1e-6, atol=1e-6), "MCLMC normals differ")
    # the same device function with a key per element, as prng draws through it
    keyed = torch.from_numpy(rng.integers(0, 2**32, (4, TF_KEYS), dtype=np.uint64)
                             .astype(np.int64))
    keyed_dev = [w.to(dev) for w in keyed]
    tf_card, tf_ms = _timed(torch, lambda: prng.threefry2x32(*keyed_dev))
    tf_ms = _timed_mean(torch, lambda: prng.threefry2x32(*keyed_dev), 20)
    tf_plain_ms = _timed_mean(torch, lambda: counter_rng.threefry2x32(*keyed_dev), 5)
    tf_plain = prng.threefry2x32(*keyed)
    keyed_same = all(torch.equal(a.cpu(), b) for a, b in zip(tf_card, tf_plain))
    tf_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(tf_card, tf_plain))
    _require(keyed_same, "per-element-key threefry2x32 kernel != prng's plain version")
    tf_bound = _bound(TF_KEYS * 6 * 8, 0.0, peaks, TF_KEYS * THREEFRY_OPS, d=1)  # no FP32 work
    print(f"phase 2: threefry2x32 device function equals the plain version bit for bit "
          f"on {c0.numel()} counters: {same}; with a key per element on {TF_KEYS} keys "
          f"(prng's draws): bit for bit {keyed_same}, kernel {tf_ms:.4f} ms, plain (int64 torch "
          f"ops on the card) {tf_plain_ms:.4f} ms, bound {tf_bound[0]:.4f} ms by {tf_bound[1]}; "
          f"the MCLMC kernel's counter normals on "
          f"{mz.numel()} elements: threefry words bit for bit {words_same}, normals max |diff| "
          f"{z_err:.3g} (tolerance 1e-6), {z_same:.4f} of them identical ({smi})")

    # ---- phase 3: kernel against its plain version on the card ----
    marks.append((3, time.perf_counter()))
    target = dc.make_hierarchical_target_dc(D)
    imm = torch.ones(D, dtype=torch.float32, device=dev)
    x0 = torch.from_numpy((0.5 * rng.standard_normal((C, D))).astype(np.float32)).to(dev)

    def compare(x, num_steps):
        budget = 2**MAX_DOUBLINGS * num_steps  # guarantees completion
        kw = dict(target=target, num_steps=num_steps, max_num_doublings=MAX_DOUBLINGS,
                  seed=SEED, num_track=NUM_TRACK, budget=budget)
        kern, ms = _timed(torch, lambda: dc.fused_nuts_run_dc(x, imm, STEP_SIZE, **kw))
        plain, plain_ms = _timed(
            torch, lambda: dc.fused_nuts_run_dc_plain(x, imm, STEP_SIZE, **kw))
        _require(torch.equal(kern[3], plain[3]), f"steps differ at S={num_steps}")
        share, err = _agreement(torch, kern[:2], plain[:2])
        _require(share >= AGREE_FLOOR, f"only {share} of chains agree at S={num_steps}")
        return kern, plain, ms, plain_ms, share, err

    dc.fused_nuts_run_dc(x0[:64], imm, STEP_SIZE, target=target, num_steps=2,
                         num_track=NUM_TRACK, seed=SEED)  # first launch, untimed
    kern, plain, ms3, plain_ms3, share3, err3 = compare(x0, 16)
    grads3 = float(kern[2])
    kv, pv = kern[1].flatten(0, 1).var(0), plain[1].flatten(0, 1).var(0)
    _require(torch.allclose(kv, pv, rtol=0.05), "pooled variances differ")
    print(f"phase 3: d={D} C={C} S=16 max_doublings={MAX_DOUBLINGS}: steps identical, "
          f"{share3:.4f} of chains agree to {AGREE_TOL} (floor {AGREE_FLOOR}), max |diff| "
          f"{err3:.3g}, grads kernel {float(kern[2]):.0f} plain {float(plain[2]):.0f}, "
          f"pooled var log_tau kernel {float(kv[0]):.5f} plain {float(pv[0]):.5f}; "
          f"kernel {ms3:.3f} ms, plain {plain_ms3:.1f} ms ({smi})")

    # ---- phase 4: the NUTS path ----
    marks.append((4, time.perf_counter()))
    S = 256
    flagship = hierarchical_gaussian(D)
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    positions, step4, imm4, warm_leaves, warm4_s, nuts_s = warm_start(torch, dev)
    _require(np.isfinite(step4) and step4 > 0, f"warmup step size {step4}")
    _require(bool(torch.isfinite(imm4).all() and (imm4 > 0).all()), "warmup metric")
    run_kw = dict(target=target, num_steps=S, max_num_doublings=MAX_DOUBLINGS, seed=SEED,
                  num_track=NUM_TRACK, budget=2**MAX_DOUBLINGS * S)
    (fx, hist, grads, steps), ms4 = _timed(
        torch, lambda: dc.fused_nuts_run_dc(positions, imm4, step4, **run_kw))
    ess = blackjax_tpu_torch.ess(hist)  # (chains, samples, tracked)
    min_ess = float(ess.min())
    launches = dict(dc.LAUNCHES)
    fx4, grads4 = fx, float(grads)
    warm4_ms_per_leaf = warm4_s / warm_leaves * 1e3

    _require(launches["fused_nuts_dc"] > 0, "the NUTS path launched no kernel")
    _require(launches["fused_nuts_dc:analytic_resident"] > 0,
             "the NUTS path's dc run did not launch the resident form")
    _require(bool((steps == S).all()), f"chains short of {S} transitions: {int(steps.min())}")
    for name, t in [("positions", fx), ("history", hist), ("ess", ess)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite {name}")
    _require(fx.shape == (C, D) and hist.shape == (C, S, NUM_TRACK), "output shapes")
    # log_tau's marginal is N(0, 1); the chains start from 0.5 * N(0, I), in
    # the funnel's neck, and the bound is a sanity check on the second half
    mean_lt, var_lt = _log_tau_moments(hist)
    _require(abs(mean_lt) < 0.3 and abs(var_lt - 1.0) < 0.3,
             f"log_tau moments {mean_lt}, {var_lt} far off its N(0, 1) marginal")
    secs = ms4 / 1e3
    # the launch's bound, as phase 3's, and its per-chain iterations from a
    # second launch on the same inputs (it gives the same outputs)
    bound4 = _bound(2 * C * D * 4 + C * S * NUM_TRACK * 4 + 3 * C * 4,
                    grads4 * (DC_LEAF_OPS + GRAD_OPS["hierarchical"]) * D, peaks,
                    (grads4 + C * S * D) * THREEFRY_OPS, d=D)
    x4, operands4, machine4 = dc._prepare(positions, imm4, **run_kw)
    iters4 = dc._launch_cuda(x4, operands4, float(step4), **machine4)[4].double().cpu()
    occ4 = dc.occupancy(D)
    form4 = [key.split(":analytic_")[1] for key, v in launches.items()
             if ":analytic_" in key and v > 0]
    print(f"phase 4: window_adaptation(nuts) single chain, {WARMUP_STEPS} steps, "
          f"{warm_leaves} leaves in {warm4_s:.2f} s ({warm4_ms_per_leaf:.2f} ms a leaf with the "
          f"keyed draws; {UNKEYED_WARMUP_MS_PER_LEAF:.2f} ms before them, 48.44 s / 9,151 leaves): "
          f"step size {step4:.5f}, mean imm "
          f"{float(imm4.mean()):.5f}, imm[log_tau] {float(imm4[0]):.5f}; nuts 5 transitions x "
          f"{C} chains in {nuts_s:.2f} s; fused_nuts_run_dc d={D} C={C} S={S}: all {C} "
          f"chains completed {S} transitions, kernel {ms4:.2f} ms, {float(grads):.0f} grads "
          f"({float(grads) / secs:.4g} grads/s), min-ESS over {NUM_TRACK} tracked dims "
          f"{min_ess:.1f} ({min_ess / secs:.4g} ESS/s), log_tau over the second half: mean "
          f"{mean_lt:.4f} var {var_lt:.4f}; launches {launches}; the dc launch in the "
          f"{'/'.join(form4)} form: bound {bound4[0]:.4f} ms by {bound4[1]}, kernel / bound "
          f"{ms4 / bound4[0]:.1f}; iterations a chain max {float(iters4.max()):.0f}, p99 "
          f"{float(iters4.quantile(0.99)):.0f}, mean {float(iters4.mean()):.1f}; "
          f"{occ4['warps_per_sm']} warps an SM resident, {occ4['registers']} registers, "
          f"{occ4['local_bytes']} B local a thread ({smi})")

    # the comparison only: draws are keyed on chain * num_steps + steps, so
    # the plain version is held against a kernel call of its own length
    cmp_kw = dict(run_kw, num_steps=PLAIN_TRANSITIONS,
                  budget=2**MAX_DOUBLINGS * PLAIN_TRANSITIONS)
    head = positions[:PLAIN_CHAINS]
    kern, kern_ms4 = _timed(torch, lambda: dc.fused_nuts_run_dc(head, imm4, step4, **cmp_kw))
    plain, plain_ms4 = _timed(
        torch, lambda: dc.fused_nuts_run_dc_plain(head, imm4, step4, **cmp_kw))
    _require(torch.equal(kern[3], plain[3]), "phase 4 steps differ")
    share4, err4 = _agreement(torch, kern[:2], plain[:2])
    _require(share4 >= AGREE_FLOOR, f"only {share4} of chains agree at phase 4")
    print(f"phase 4 comparison on the first {PLAIN_CHAINS} chains, {PLAIN_TRANSITIONS} "
          f"transitions: kernel {kern_ms4:.2f} ms, plain {plain_ms4:.1f} ms, {share4:.4f} of "
          f"chains agree to {AGREE_TOL}, max |diff| {err4:.3g}")

    # ---- phase 5: the leapfrog kernel against its plain version ----
    marks.append((5, time.perf_counter()))
    rng5 = np.random.default_rng(5)
    x5 = torch.from_numpy((0.5 * rng5.standard_normal((C, D))).astype(np.float32)).to(dev)
    m5 = torch.from_numpy(rng5.standard_normal((C, D)).astype(np.float32)).to(dev)
    imm5 = torch.from_numpy(rng5.uniform(0.5, 1.5, D).astype(np.float32)).to(dev)
    lf_targets = {
        "hierarchical": lf.make_hierarchical_gaussian_target(D),
        "gaussian": lf.make_gaussian_target(D, np.logspace(-1, 1, D)),
    }
    lf_times, err5 = {}, 0.0
    for name, lf_target in lf_targets.items():
        lf_kw = dict(target=lf_target, num_steps=HMC_STEPS)
        kern = lf.fused_leapfrog(x5, m5, imm5, 0.1, **lf_kw)
        plain = lf.fused_leapfrog_plain(x5, m5, imm5, 0.1, **lf_kw)
        close = torch.ones(C, dtype=torch.bool, device=dev)
        for a, b in zip(kern, plain):
            ok = torch.isclose(a, b, rtol=AGREE_TOL, atol=AGREE_TOL)
            close &= ok.all(1) if ok.dim() == 2 else ok
            err5 = max(err5, float((a - b).abs().max()))
        share5 = float(close.float().mean())
        _require(share5 >= LEAPFROG_FLOOR, f"only {share5} of leapfrog chains agree ({name})")
        ms5 = _timed_mean(torch, lambda: lf.fused_leapfrog(x5, m5, imm5, 0.1, **lf_kw), 50)
        plain_ms5 = _timed_mean(
            torch, lambda: lf.fused_leapfrog_plain(x5, m5, imm5, 0.1, **lf_kw), 10)
        dev_ms5 = _device_ms(
            torch, lambda: lf.fused_leapfrog(x5, m5, imm5, 0.1, **lf_kw), "leapfrog_kernel")
        lf_times[name] = (ms5, plain_ms5)
        device_time = "not measured" if dev_ms5 is None else f"{dev_ms5:.4f} ms"
        print(f"phase 5: fused_leapfrog {name} d={D} C={C} num_steps={HMC_STEPS}: "
              f"{share5:.4f} of chains agree to {AGREE_TOL} in x, m and energy (floor "
              f"{LEAPFROG_FLOOR}), max |diff| so far {err5:.3g}; per call by CUDA events: "
              f"kernel {ms5:.4f} ms, plain {plain_ms5:.4f} ms; the kernel's device time by "
              f"torch.profiler {device_time} per launch ({smi})")
    # the HMC transition kernel on the same inputs, with m5 as its normal
    # draws and uniforms of its own
    u5 = torch.from_numpy(rng5.random(C).astype(np.float32)).to(dev)
    # x0 and z in, x out; the log density and u in; the log density,
    # p_accept, energy1 and the accept flag out; the metric
    tr_bytes = 3 * C * D * 4 + C * (4 * 5 + 1) + D * 4
    tr_ops = C * ((HMC_STEPS + 1) * GRAD_OPS["hierarchical"] * D
                  + HMC_STEPS * LEAPFROG_STEP_OPS * D + TRANSITION_OPS * D)
    tr_bound = _bound(tr_bytes, tr_ops, peaks, d=D)
    tr_times, err5t = {}, 0.0
    for name, lf_target in lf_targets.items():
        ld5 = lf_target.logdensity_fn(x5)
        tr_args = (x5, ld5, m5, u5, imm5, 0.1)
        tr_kw = dict(target=lf_target, num_steps=HMC_STEPS)
        before5 = dict(lf.LAUNCHES)
        kern = lf._hmc_transition_cuda(*tr_args, **tr_kw)
        torch.cuda.synchronize()
        _require(lf.LAUNCHES["fused_leapfrog:hmc_transition"]
                 == before5["fused_leapfrog:hmc_transition"] + 1,
                 "phase 5: the transition kernel was not counted")
        plain = lf._hmc_transition_plain(*tr_args, **tr_kw)
        same = kern[3] == plain[3]
        for a, b in zip(kern[:3], plain[:3]):
            ok = torch.isclose(a, b, rtol=AGREE_TOL, atol=AGREE_TOL)
            same &= ok.all(1) if ok.dim() == 2 else ok
            err5t = max(err5t, float((a - b).abs().max()))
        share5t = float(same.float().mean())
        _require(share5t >= LEAPFROG_FLOOR,
                 f"only {share5t} of the transition's chains agree ({name})")
        _require(all(bool(torch.isfinite(a).all()) for a in kern[:3]),
                 f"phase 5: non-finite transition output ({name})")
        ms5t = _timed_mean(torch, lambda: lf._hmc_transition_cuda(*tr_args, **tr_kw), 50)
        plain_ms5t = _timed_mean(torch, lambda: lf._hmc_transition_plain(*tr_args, **tr_kw), 10)
        dev_ms5t = _device_ms(
            torch, lambda: lf._hmc_transition_cuda(*tr_args, **tr_kw), "hmc_transition")
        tr_times[name] = (ms5t, plain_ms5t, dev_ms5t)
        device_time = "not measured" if dev_ms5t is None else f"{dev_ms5t:.4f} ms"
        print(f"phase 5: hmc_transition {name} d={D} C={C} num_steps={HMC_STEPS}: {share5t:.4f} "
              f"of chains agree to {AGREE_TOL} in x, log density and p_accept with the same "
              f"accept flag (floor {LEAPFROG_FLOOR}), accepted {float(kern[3].float().mean()):.4f}, "
              f"max |diff| so far {err5t:.3g}; per call by CUDA events: kernel {ms5t:.4f} ms, "
              f"plain {plain_ms5t:.4f} ms; the kernel's device time by torch.profiler "
              f"{device_time} per launch; bound {tr_bound[0]:.5f} ms by {tr_bound[1]} ({smi})")

    # ---- phase 6: the HMC path ----
    marks.append((6, time.perf_counter()))
    for name in lf.LAUNCHES:
        lf.LAUNCHES[name] = 0
    warm6, step6, imm6, generator, warm6_s, warm_acc6 = hmc_start(torch, dev)
    sampler = blackjax_tpu_torch.fused_hmc(
        lf.make_hierarchical_gaussian_target(D), step6, imm6, HMC_STEPS)
    (track, acc), ms6, host6_s = hmc_path(torch, sampler, generator, warm6)
    hist6 = track.permute(1, 0, 2)  # (chains, samples, tracked)
    ess6 = blackjax_tpu_torch.ess(hist6.double())
    min_ess6 = float(ess6.min())
    lf_launches = lf.LAUNCHES["fused_leapfrog"]
    tr_launches = lf.LAUNCHES["fused_leapfrog:hmc_transition"]
    # leapfrog_kernel's own launches: the library's, less the transition's and
    # the tiles form's
    leapfrog6 = lf_launches - tr_launches - lf.LAUNCHES["fused_leapfrog:logreg_tiles"]
    mean_acc = float(acc.mean())

    for name, t in [("history", hist6), ("acceptance", acc), ("ess", ess6)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite {name} at phase 6")
    _require(hist6.shape == (C, HMC_TRANSITIONS, NUM_TRACK), "phase 6 history shape")
    _require(lf_launches == HMC_TRANSITIONS,
             f"fused_leapfrog launched {lf_launches} times, not {HMC_TRANSITIONS}")
    _require(tr_launches == HMC_TRANSITIONS,
             f"{tr_launches} of {HMC_TRANSITIONS} transitions in the transition form")
    _require(0.5 <= mean_acc <= 0.99, f"mean acceptance {mean_acc}")
    mean_lt6, var_lt6 = _log_tau_moments(hist6)
    _require(abs(mean_lt6) < 0.3 and abs(var_lt6 - 1.0) < 0.3,
             f"log_tau moments {mean_lt6}, {var_lt6} far off its N(0, 1) marginal")
    secs6 = ms6 / 1e3
    grads6 = C * HMC_TRANSITIONS * HMC_STEPS
    print(f"phase 6: window_adaptation(hmc) pooled over {C} chains, {WARMUP_STEPS} steps "
          f"x {HMC_STEPS} leapfrogs, in {warm6_s:.2f} s (warmup acceptance "
          f"{warm_acc6:.4f}): step size {step6:.5f}, mean "
          f"imm {float(imm6.mean()):.5f}, imm[log_tau] {float(imm6[0]):.5f}; fused_hmc "
          f"{HMC_TRANSITIONS} transitions x {C} chains: {ms6:.2f} ms by CUDA events "
          f"({host6_s:.2f} s host clock; {ms6 / HMC_TRANSITIONS:.4f} ms a transition), {grads6} "
          f"grads ({grads6 / secs6:.4g} grads/s), "
          f"min-ESS over {NUM_TRACK} tracked dims {min_ess6:.1f} ({min_ess6 / secs6:.4g} "
          f"ESS/s), mean acceptance {mean_acc:.4f}, log_tau over the second half: mean "
          f"{mean_lt6:.4f} var {var_lt6:.4f}; fused_leapfrog launches {lf_launches}, "
          f"{tr_launches} of them the transition form, {leapfrog6} leapfrog_kernel ({smi})")

    # ---- phase 7: the MCLMC kernel against its plain version ----
    marks.append((7, time.perf_counter()))
    rng7 = np.random.default_rng(7)
    x7 = torch.from_numpy((0.5 * rng7.standard_normal((C, D))).astype(np.float32)).to(dev)
    m7 = torch.from_numpy(rng7.standard_normal((C, D)).astype(np.float32)).to(dev)
    m7 = m7 / torch.linalg.vector_norm(m7, dim=1, keepdim=True)
    imm7 = torch.from_numpy(rng7.uniform(0.5, 1.5, D).astype(np.float32)).to(dev)
    step7, L7 = 0.5, 5.0
    err7, ms7, plain_ms7 = 0.0, None, None
    for (name, mclmc_target), refresh in itertools.product(lf_targets.items(), (False, True)):
        kw7 = dict(target=mclmc_target, num_steps=MCLMC_CMP_STEPS, seed=SEED,
                   track_dims=range(NUM_TRACK), refresh=refresh)
        before7 = fm.LAUNCHES["fused_mclmc:resident"]
        kern = fm.fused_mclmc(x7, m7, imm7, step7, L7, **kw7)
        _require(fm.LAUNCHES["fused_mclmc:resident"] == before7 + 1,
                 f"phase 7 ({name}, refresh={refresh}) did not launch the resident form")
        plain = fm.fused_mclmc_plain(x7, m7, imm7, step7, L7, **kw7)
        close = torch.ones(C, dtype=torch.bool, device=dev)
        errs = []
        for a, b in zip(kern, plain):
            ok = torch.isclose(a, b, rtol=AGREE_TOL, atol=AGREE_TOL)
            close &= ok.flatten(1).all(1) if ok.dim() > 1 else ok
            errs.append(float((a - b).abs().max()))
        share7 = float(close.float().mean())
        _require(share7 >= MCLMC_FLOOR,
                 f"only {share7} of MCLMC chains agree ({name}, refresh={refresh})")
        err7 = max(err7, errs[0], errs[1], errs[3])
        # the resident form against the registers form on the first chains
        first = slice(0, MCLMC_EQUAL_CHAINS)
        same7 = all(torch.equal(a, b) for a, b in zip(
            fm.fused_mclmc(x7[first], m7[first], imm7, step7, L7, **kw7),
            fm.fused_mclmc(x7[first], m7[first], imm7, step7, L7, form="registers", **kw7)))
        _require(same7, f"phase 7 ({name}, refresh={refresh}): the resident and the registers "
                        f"forms differ")
        line = (f"phase 7: fused_mclmc {name} refresh={refresh} d={D} C={C} "
                f"num_steps={MCLMC_CMP_STEPS}, resident form: {share7:.4f} of chains agree to "
                f"{AGREE_TOL} in x, m, log density and history (floor {MCLMC_FLOOR}); max |diff| "
                f"x {errs[0]:.3g}, m {errs[1]:.3g}, log density {errs[2]:.3g}, history "
                f"{errs[3]:.3g}; the registers form's outputs the same bits on "
                f"{MCLMC_EQUAL_CHAINS} x {MCLMC_CMP_STEPS}")
        if name == "hierarchical" and refresh:  # the main path's kernel
            def call(form=None):
                return fm.fused_mclmc(x7, m7, imm7, step7, L7, form=form, **kw7)

            ms7 = _timed_mean(torch, call, 20)
            registers_ms7 = _timed_mean(torch, lambda: call("registers"), 20)
            plain_ms7 = _timed_mean(
                torch, lambda: fm.fused_mclmc_plain(x7, m7, imm7, step7, L7, **kw7), 2)
            dev_ms7 = _device_ms(torch, call, "mclmc_", repeats=5)
            device_time = "not measured" if dev_ms7 is None else f"{dev_ms7:.4f} ms"
            line += (f"; per call by CUDA events: kernel {ms7:.4f} ms (the registers form "
                     f"{registers_ms7:.4f} ms), plain {plain_ms7:.2f} ms; the kernel's device "
                     f"time by torch.profiler {device_time} per launch")
        print(f"{line} ({smi})")
    # how the difference grows with depth, on the main path's target
    for refresh in (False, True):
        deep_kw = dict(target=lf_targets["hierarchical"], num_steps=MCLMC_DEPTH, seed=SEED,
                       track_dims=range(NUM_TRACK), refresh=refresh)
        kern = fm.fused_mclmc(x7, m7, imm7, step7, L7, **deep_kw)
        plain = fm.fused_mclmc_plain(x7, m7, imm7, step7, L7, **deep_kw)
        by_step = (kern[3] - plain[3]).abs().amax(dim=(0, 2))
        growth = ", ".join(f"{s}: {float(by_step[s - 1]):.3g}" for s in (1, 16, 64, 128, 256, 512))
        print(f"phase 7: hierarchical refresh={refresh}, largest |kernel - plain| of the tracked "
              f"history after steps {{{growth}}}")

    # ---- phase 8: the MCLMC path ----
    marks.append((8, time.perf_counter()))
    for name in fm.LAUNCHES:
        fm.LAUNCHES[name] = 0
    pos8, mom8, L8, step8, imm8, tune_total, tune8_s, mclmc_s = mclmc_start(torch, dev)
    kw8 = dict(target=lf.make_hierarchical_gaussian_target(D), num_steps=MCLMC_STEPS,
               seed=SEED, track_dims=range(NUM_TRACK))
    (x8, m8, ld8, hist8), ms8 = _timed(
        torch, lambda: fm.fused_mclmc(pos8, mom8, imm8, step8, L8, **kw8))
    ess8 = blackjax_tpu_torch.ess(hist8.double())
    min_ess8 = float(ess8.min())
    launches8 = dict(fm.LAUNCHES)
    fm_launches = launches8["fused_mclmc"]

    _require(fm_launches == 1, f"fused_mclmc launched {fm_launches} times, not once")
    _require(launches8["fused_mclmc:resident"] == 1,
             f"phase 8 did not launch the resident form: {launches8}")
    # the registers form on the same inputs, off the path: the same bits
    registers8, registers_ms8 = _timed(
        torch, lambda: fm.fused_mclmc(pos8, mom8, imm8, step8, L8, form="registers", **kw8))
    _require(all(torch.equal(a, b) for a, b in zip((x8, m8, ld8, hist8), registers8)),
             "phase 8: the resident and the registers forms differ")
    occ8 = fm.occupancy(D)
    for name, t in [("positions", x8), ("momenta", m8), ("log densities", ld8),
                    ("history", hist8), ("ess", ess8)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite {name} at phase 8")
    _require(hist8.shape == (C, MCLMC_STEPS, NUM_TRACK), "phase 8 history shape")
    norm_err8 = float((torch.linalg.vector_norm(m8, dim=1) - 1.0).abs().max())
    _require(norm_err8 <= 1e-5, f"momenta off the unit sphere by {norm_err8}")
    mean_lt8, var_lt8 = _log_tau_moments(hist8)
    _require(abs(mean_lt8) < 0.3 and abs(var_lt8 - 1.0) < 0.3,
             f"log_tau moments {mean_lt8}, {var_lt8} far off its N(0, 1) marginal")
    secs8 = ms8 / 1e3
    grads8 = C * MCLMC_STEPS * 2  # two gradients per McLachlan step
    # the launch's own bound, as phase 7's at its depth, and with Box-Muller
    bound8 = _mclmc_bound(peaks, C, MCLMC_STEPS, D, NUM_TRACK)
    bound8_bm = _mclmc_bound(peaks, C, MCLMC_STEPS, D, NUM_TRACK, box_muller=True)
    print(f"phase 8: mclmc_find_L_and_step_size single chain, {tune_total} tuning steps in "
          f"{tune8_s:.2f} s: L {L8:.5f}, step size {step8:.5f}, mean imm "
          f"{float(imm8.mean()):.5f}, imm[log_tau] {float(imm8[0]):.5f}; mclmc 5 transitions x "
          f"{C} chains in {mclmc_s:.2f} s; fused_mclmc d={D} C={C} {MCLMC_STEPS} steps in the "
          f"resident form ({occ8['warps_per_sm']} warps an SM, {occ8['registers']} registers, "
          f"{occ8['local_bytes']} B local a thread, {occ8['pool_steps']} steps a pool): kernel "
          f"{ms8:.2f} ms (the registers form on the same inputs {registers_ms8:.2f} ms, the same "
          f"bits; bound {bound8[0]:.3f} ms by {bound8[1]}, kernel / bound "
          f"{ms8 / bound8[0]:.1f}; with Box-Muller's logf, sqrtf and cosf recounted from the SASS "
          f"{bound8_bm[0]:.3f} ms, kernel / bound {ms8 / bound8_bm[0]:.1f}), {grads8} grads "
          f"({grads8 / secs8:.4g} grads/s), min-ESS over "
          f"{NUM_TRACK} tracked dims {min_ess8:.1f} ({min_ess8 / secs8:.4g} ESS/s), momenta "
          f"unit-norm to {norm_err8:.2g}, log_tau over the second half: mean {mean_lt8:.4f} var "
          f"{var_lt8:.4f}; fused_mclmc launches {fm_launches}, in the resident form "
          f"{launches8['fused_mclmc:resident']} ({smi})")

    # ---- phase 9: the new (kernel, target) pairs against their plain versions ----
    marks.append((9, time.perf_counter()))
    from blackjax_tpu_torch.models import finnish_horseshoe
    from blackjax_tpu_torch.ops import targets_dc

    rng9 = np.random.default_rng(9)
    X9 = rng9.standard_normal((LR_N, LR_D)).astype(np.float32)
    y9 = (rng9.random(LR_N) < 1.0 / (1.0 + np.exp(-X9 @ rng9.standard_normal(LR_D))))
    y9 = y9.astype(np.float32)
    pairs = {}

    def dc_pair(name, target, x, imm, step, num_steps, max_doublings, kind, n=0, m=0):
        """The dc kernel on ``target`` against its plain version; returns the
        pair's JSON fields."""
        kw = dict(target=target, num_steps=num_steps, max_num_doublings=max_doublings,
                  seed=SEED, num_track=target.dim, budget=2**max_doublings * num_steps)
        dc.fused_nuts_run_dc(x[:8], imm, step, **dict(kw, num_steps=1))  # first launch
        for key in dc.LAUNCHES:
            dc.LAUNCHES[key] = 0
        kern, ms = _per_chain(torch, dc, True, x, imm, step, kw)
        launches = dc.LAUNCHES["fused_nuts_dc"]
        forms = [key.split(":x_")[1] for key, v in dc.LAUNCHES.items() if ":x_" in key and v]
        es_forms = {k: dc.LAUNCHES[f"fused_nuts_dc:{k}"] for k in ("thread", "registers")}
        plain, plain_ms = _per_chain(torch, dc, False, x, imm, step, kw)
        share, share5, err, grads, plain_grads, other = _matrix_pair(
            torch, name, kern, plain, num_steps)
        dev_ms = _device_ms(torch, lambda: dc.fused_nuts_run_dc(x, imm, step, **kw),
                            "nuts_dc_", repeats=3)
        chains, d = x.shape
        data_bytes = 0 if target.matrix.X is None else target.matrix.X.nbytes
        nbytes = 2 * chains * d * 4 + chains * num_steps * d * 4 + 3 * chains * 4 + data_bytes
        ops = grads * (DC_LEAF_OPS * d + _grad_ops(kind, d, n, m))
        bound = _bound(nbytes, ops, peaks, (grads + chains * num_steps * d) * THREEFRY_OPS,
                       d=d)
        device_time = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        form = ""
        if kind == "logreg":
            _require(forms == ["tiles"], f"{name}: the dc kernel took the forms {forms}, not tiles")
            idle, _ = _tiles_idle_share(torch, dc, x, imm, step, kw)
            form = f", lockstep idle warp-iterations {idle:.4f}"
        if kind == "eight_schools":
            planned = _eight_schools_form(dc)
            _require(es_forms[planned] == launches == 1,
                     f"{name}: the dc kernel took the forms {es_forms}, not the {planned} form")
            form = f", the plan's {planned} form"
        if forms:
            plan = dc.shared_memory_plan(dc._register_width(d), target.cuda_target, "diag",
                                         max_doublings, *target.matrix.X.shape)
            form = (f", X read from {'/'.join(forms)} ({plan.nbytes} B of shared memory a "
                    f"block){form}")
        print(f"phase 9: fused_nuts_run_dc {name} d={d} C={chains} S={num_steps} "
              f"max_doublings={max_doublings}{form}: steps identical, grads kernel {grads:.0f} plain "
              f"{plain_grads:.0f} ({other} chains with other counts, all among those that part; "
              f"{grads / (chains * num_steps):.3f} leaves per transition), "
              f"{share:.4f} of chains agree to {MATRIX_TOL} (floor {AGREE_FLOOR}; "
              f"{share5:.4f} to {AGREE_TOL}), max |diff| {err:.3g}; kernel {ms:.3f} ms (device "
              f"{device_time}), plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
              f"(kernel / bound {ms / bound[0]:.1f}) ({smi})")
        return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms, bound=bound)

    es_target = targets_dc.make_eight_schools_target_dc()
    x9 = torch.from_numpy((0.5 * rng9.standard_normal((DC_CHAINS, 10))).astype(np.float32))
    pairs["eight_schools"] = dc_pair("eight_schools", es_target, x9.to(dev),
                                     torch.ones(10, device=dev), 0.2, 8, MAX_DOUBLINGS,
                                     "eight_schools")
    lr_dc = targets_dc.make_logreg_target_dc(X9, y9)
    x9 = torch.from_numpy((0.05 * rng9.standard_normal((DC_CHAINS, LR_D))).astype(np.float32))
    pairs["logreg_dc"] = dc_pair("logreg_dc", lr_dc, x9.to(dev), torch.ones(LR_D, device=dev),
                                 0.01, 8, 6, "logreg", n=lr_dc.matrix.X.shape[0])

    lr = lf.make_logistic_regression_target(X9, y9)
    x9 = torch.from_numpy((0.05 * rng9.standard_normal((C, LR_D))).astype(np.float32)).to(dev)
    m9 = torch.from_numpy(rng9.standard_normal((C, LR_D)).astype(np.float32)).to(dev)
    imm9 = torch.from_numpy(rng9.uniform(0.5, 1.5, LR_D).astype(np.float32)).to(dev)

    def fused_pair(name, run, run_plain, floor, kernel, repeats, nbytes, ops, int_ops=0.0):
        for counts in (lf.LAUNCHES, fm.LAUNCHES):
            for key in counts:
                counts[key] = 0
        kern = run()
        launches = lf.LAUNCHES["fused_leapfrog"] + fm.LAUNCHES["fused_mclmc"]
        tiles = lf.LAUNCHES["fused_leapfrog:logreg_tiles"] + fm.LAUNCHES["fused_mclmc:logreg_tiles"]
        _require(launches == 1 and tiles == 1,
                 f"{name}: {launches} launches, {tiles} in the tiles form; one in the tiles form "
                 f"expected")
        plain = run_plain()
        close = torch.ones(C, dtype=torch.bool, device=dev)
        err = 0.0
        for a, b in zip(kern, plain):
            _require(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
            ok = torch.isclose(a, b, rtol=AGREE_TOL, atol=AGREE_TOL)
            close &= ok.flatten(1).all(1) if ok.dim() > 1 else ok
            err = max(err, float((a - b).abs().max()))
        share = float(close.float().mean())
        _require(share >= floor, f"only {share} of {name} chains agree")
        ms = _timed_mean(torch, run, repeats)
        plain_ms = _timed_mean(torch, run_plain, repeats)
        dev_ms = _device_ms(torch, run, kernel, repeats=repeats)
        bound = _bound(nbytes, ops, peaks, int_ops, d=LR_D)
        device_time = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        plan = lf.tiles_plan(LR_D)
        print(f"phase 9: {name} logistic regression {LR_N} x {LR_D}, C={C}, tiles form "
              f"({plan.chains} chains a block, {plan.tile_rows}-row tiles, {plan.nbytes} B of "
              f"shared memory a block): {share:.4f} of "
              f"chains agree to {AGREE_TOL} (floor {floor}), max |diff| {err:.3g}; per call by "
              f"CUDA events: kernel {ms:.3f} ms (device {device_time}), plain {plain_ms:.3f} ms; "
              f"bound {bound[0]:.4f} ms by {bound[1]} ({smi})")
        return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms, bound=bound)

    lf_kw = dict(target=lr, num_steps=HMC_STEPS)
    lr_grad = _grad_ops("logreg", LR_D, LR_N)
    pairs["leapfrog_logreg"] = fused_pair(
        "fused_leapfrog", lambda: lf.fused_leapfrog(x9, m9, imm9, 0.005, **lf_kw),
        lambda: lf.fused_leapfrog_plain(x9, m9, imm9, 0.005, **lf_kw), LEAPFROG_FLOOR,
        "leapfrog_kernel", 5, 4 * C * LR_D * 4 + C * 4 + X9.nbytes + y9.nbytes,
        C * ((HMC_STEPS + 1) * lr_grad + HMC_STEPS * LEAPFROG_STEP_OPS * LR_D))
    m9 = m9 / torch.linalg.vector_norm(m9, dim=1, keepdim=True)
    # all 54 coordinates tracked, as phase 14 tracks them: the history of
    # both registers of a lane (N = 2) is held against the plain version
    fm_kw = dict(target=lr, num_steps=MCLMC_CMP_STEPS, seed=SEED, track_dims=range(LR_D))
    pairs["mclmc_logreg"] = fused_pair(
        "fused_mclmc", lambda: fm.fused_mclmc(x9, m9, imm9, 0.01, 0.3, **fm_kw),
        lambda: fm.fused_mclmc_plain(x9, m9, imm9, 0.01, 0.3, **fm_kw), MCLMC_FLOOR,
        "mclmc_kernel", 2,
        4 * C * LR_D * 4 + C * 4 + C * MCLMC_CMP_STEPS * LR_D * 4 + X9.nbytes + y9.nbytes,
        C * MCLMC_CMP_STEPS * (2 * lr_grad + MCLMC_STEP_OPS * LR_D),
        C * MCLMC_CMP_STEPS * 2 * LR_D * THREEFRY_OPS)

    # ---- phase 10: the horseshoe path ----
    marks.append((10, time.perf_counter()))
    hs_model = finnish_horseshoe(HS_N, HS_M)
    hs_target = targets_dc.make_finnish_horseshoe_target_dc(HS_N, HS_M)
    hs_d = hs_model.dim
    to_dc, from_dc = (torch.from_numpy(p) for p in targets_dc.horseshoe_dc_perm(HS_M))
    hs_init = np.random.default_rng(10).standard_normal((HS_CHAINS, hs_d))
    hs_init = torch.from_numpy((0.05 * hs_init).astype(np.float32)).to(dev)[:, to_dc.to(dev)]
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    generator = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warmup = blackjax_tpu_torch.window_adaptation(
        nuts, hs_model.logdensity_fn, max_num_doublings=HS_WARMUP_DOUBLINGS,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}),
    )
    (_, params), warm_info = warmup.run(
        generator, torch.zeros(hs_d, device=dev), HS_WARMUP_STEPS)
    torch.cuda.synchronize()
    warm10_s = time.perf_counter() - t0
    step10, imm10 = params["step_size"], params["inverse_mass_matrix"]
    _require(np.isfinite(step10) and step10 > 0, f"horseshoe warmup step size {step10}")
    _require(bool(torch.isfinite(imm10).all() and (imm10 > 0).all()), "horseshoe warmup metric")
    warm10_leaves = int(warm_info.info.num_integration_steps.sum())
    imm10_dc = imm10[to_dc.to(dev)].contiguous()
    hs_kw = dict(target=hs_target, num_steps=HS_TRANSITIONS, max_num_doublings=HS_MAX_DOUBLINGS,
                 seed=SEED, num_track=hs_d, pack=HS_PACK, restart_every=HS_RESTART_EVERY,
                 chunk=HS_CHUNK, budget=HS_BUDGET)
    (fx10, hist10, grads10, steps10), ms10 = _timed(
        torch, lambda: dc.fused_nuts_run_dc(hs_init, imm10_dc, step10, **hs_kw))
    hs_launches = dc.LAUNCHES["fused_nuts_dc"]
    hs_shared = dc.LAUNCHES["fused_nuts_dc:x_shared"]
    ess10 = blackjax_tpu_torch.ess(hist10)
    min_ess10 = float(ess10.min())

    _require(hs_launches == 1, f"the horseshoe path launched the dc kernel {hs_launches} times")
    _require(hs_shared == 1, "the horseshoe path did not launch the dc kernel's shared-memory "
             f"form: {dict(dc.LAUNCHES)}")
    _require(bool((steps10 == HS_TRANSITIONS).all()),
             f"horseshoe chains short of {HS_TRANSITIONS} transitions: {int(steps10.min())}")
    for name, t in [("positions", fx10), ("history", hist10), ("ess", ess10)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite horseshoe {name}")
    _require(hist10.shape == (HS_CHAINS, HS_TRANSITIONS, hs_d), "horseshoe history shape")
    second = hist10[:, HS_TRANSITIONS // 2:]
    alpha_mean = float(second[..., 2 * HS_M].mean())
    log_sigma_mean = float(second[..., 2 * HS_M + 1].mean())
    _require(ALPHA_BAND[0] <= alpha_mean <= ALPHA_BAND[1],
             f"alpha's second-half mean {alpha_mean} outside {ALPHA_BAND}")
    _require(LOG_SIGMA_BAND[0] <= log_sigma_mean <= LOG_SIGMA_BAND[1],
             f"log_sigma's second-half mean {log_sigma_mean} outside {LOG_SIGMA_BAND}")
    secs10 = ms10 / 1e3
    worst10 = int(torch.argmin(ess10))
    hs_ops = float(grads10) * (DC_LEAF_OPS * hs_d + _grad_ops("horseshoe", hs_d, HS_N, HS_M))
    bound10 = _bound(2 * HS_CHAINS * hs_d * 4 + hist10.numel() * 4 + 3 * HS_CHAINS * 4
                     + hs_target.matrix.X.nbytes, hs_ops, peaks,
                     (float(grads10) + HS_CHAINS * HS_TRANSITIONS * hs_d) * THREEFRY_OPS, d=hs_d)
    # the shared-memory bound: X read twice a gradient, at 128 bytes a clock
    # on each SM that holds a block (one block of four chains an SM)
    hs_sms = min(sms, -(-HS_CHAINS // dc._WARPS))
    smem_bound10 = float(grads10) * 2 * HS_N * HS_M * 4 / (128 * hs_sms * sm_mhz * 1e6) * 1e3
    plan10 = dc.shared_memory_plan(dc._register_width(hs_d), hs_target.cuda_target, "diag",
                                   HS_MAX_DOUBLINGS, HS_N, HS_M)
    ptxas10 = [line for line in _ptxas_summary(dc_log)
               if line.startswith(f"nuts_dc N={dc._register_width(hs_d)} F=3 M=0 shared=1:")]
    print(f"phase 10: window_adaptation(nuts, finnish_horseshoe) single chain, "
          f"{HS_WARMUP_STEPS} steps at max_doublings={HS_WARMUP_DOUBLINGS}, {warm10_leaves} "
          f"leaves in {warm10_s:.2f} s: step size {step10:.6f}, mean imm "
          f"{float(imm10.mean()):.5f}; fused_nuts_run_dc d={hs_d} C={HS_CHAINS} "
          f"S={HS_TRANSITIONS} max_doublings={HS_MAX_DOUBLINGS} pack={HS_PACK} "
          f"restart_every={HS_RESTART_EVERY}: all chains completed, X read from shared memory "
          f"({plan10.nbytes} B of shared memory a block; ptxas {'; '.join(ptxas10)}), kernel "
          f"{ms10:.2f} ms (bound {bound10[0]:.3f} ms by {bound10[1]}; shared-memory bound "
          f"{smem_bound10:.3f} ms on {hs_sms} SMs at {sm_mhz:.0f} MHz), "
          f"{float(grads10):.0f} grads ({float(grads10) / secs10:.4g} grads/s, "
          f"{float(grads10) / (HS_CHAINS * HS_TRANSITIONS):.1f} leaves per transition), "
          f"min-ESS over all {hs_d} coordinates {min_ess10:.1f} (dc row {worst10}) "
          f"({min_ess10 / secs10:.4g} ESS/s), second-half means alpha {alpha_mean:.5f} "
          f"(band {ALPHA_BAND}) log_sigma {log_sigma_mean:.5f} (band {LOG_SIGMA_BAND}); "
          f"launches {dict(dc.LAUNCHES)} ({smi})")
    pairs["horseshoe"] = dc_pair(
        "finnish_horseshoe", hs_target, fx10[:HS_CMP_CHAINS].contiguous(), imm10_dc, step10,
        HS_CMP_TRANSITIONS, HS_CMP_DOUBLINGS, "horseshoe", n=HS_N, m=HS_M)
    pairs["horseshoe"]["launches"] = hs_launches

    # ---- phase 11: the dense and low-rank path ----
    marks.append((11, time.perf_counter()))
    from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix

    def metric_ops(imm, d):
        """(bytes, FP32 operations of one M^{-1} product) of a metric: 2 d^2
        (dense) or 4 d k (low-rank: U^T y, then U times k scales)."""
        if isinstance(imm, LowRankInverseMassMatrix):
            k = imm.U.shape[1]
            return (2 * d + d * k + 2 * k) * 4, 4 * d * k
        return 2 * d * d * 4, 2 * d * d

    def metric_bound(imm, chains, d, num_steps, grads, n=0, family="logreg"):
        """The dc machine's bound with a metric: two M^{-1} products a leaf,
        one M^{1/2} and one M^{-1} product a transition."""
        mbytes, mops = metric_ops(imm, d)
        data_bytes = lr_dc.matrix.X.nbytes if family == "logreg" else 0
        nbytes = (2 * chains * d * 4 + chains * num_steps * d * 4 + 3 * chains * 4 + data_bytes
                  + mbytes)
        ops = (grads * (DC_LEAF_OPS * d + _grad_ops(family, d, n) + 2 * mops)
               + chains * num_steps * 2 * mops)
        return _bound(nbytes, ops, peaks, (grads + chains * num_steps * d) * THREEFRY_OPS,
                      d=d)

    rng11 = np.random.default_rng(11)
    jitter11 = torch.from_numpy(
        (0.01 * rng11.standard_normal((MET_CHAINS, LR_D))).astype(np.float32)).to(dev)
    ref_mean = torch.from_numpy(LR_POSTERIOR_MEAN).to(dev)
    ref_sd = torch.from_numpy(LR_POSTERIOR_SD).to(dev)
    n_lr = lr_dc.matrix.X.shape[0]
    met = {}
    for metric_kind in ("dense", "low_rank"):
        for name in dc.LAUNCHES:
            dc.LAUNCHES[name] = 0
        generator = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if metric_kind == "dense":
            warmup = blackjax_tpu_torch.window_adaptation(
                nuts, lr_dc.logdensity_fn, is_mass_matrix_diagonal=False,
                max_num_doublings=MET_WARMUP_DOUBLINGS,
                adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}),
            )
        else:
            warmup = blackjax_tpu_torch.window_adaptation_low_rank(
                nuts, lr_dc.logdensity_fn, max_rank=MET_MAX_RANK,
                max_num_doublings=MET_WARMUP_DOUBLINGS)
        (w_state, params), w_info = warmup.run(
            generator, torch.zeros(LR_D, device=dev), MET_WARMUP_STEPS)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        step11, imm11 = params["step_size"], params["inverse_mass_matrix"]
        _require(np.isfinite(step11) and step11 > 0, f"{metric_kind} warmup step size {step11}")
        if metric_kind == "dense":
            _require(imm11.shape == (LR_D, LR_D) and bool(torch.isfinite(imm11).all()),
                     "dense warmup metric")
            extra = f"mean diagonal of M^-1 {float(imm11.diagonal().mean()):.6f}"
        else:
            _require(isinstance(imm11, LowRankInverseMassMatrix)
                     and all(bool(torch.isfinite(a).all()) for a in imm11)
                     and bool((imm11.lam > 0).all()), "low-rank warmup metric")
            extra = (f"lam {[round(float(v), 4) for v in imm11.lam]}, mean sigma "
                     f"{float(imm11.sigma.mean()):.6f}")
        warm_leaves = int(w_info.info.num_integration_steps.sum())
        start = w_state.position.reshape(-1, LR_D)[0] + jitter11
        run_kw = dict(target=lr_dc, num_steps=MET_TRANSITIONS, max_num_doublings=MET_DOUBLINGS,
                      seed=SEED, num_track=LR_D, budget=2**MET_DOUBLINGS * MET_TRANSITIONS)
        (fx11, hist11, grads11, steps11), ms11 = _timed(
            torch, lambda: dc.fused_nuts_run_dc(start, imm11, step11, **run_kw))
        launches11 = dc.LAUNCHES["fused_nuts_dc"]
        tiles11 = dc.LAUNCHES["fused_nuts_dc:x_tiles"]
        launch_counts11 = dict(dc.LAUNCHES)
        second = hist11[:, MET_TRANSITIONS // 2:]
        ess11 = blackjax_tpu_torch.ess(second)
        min_ess11 = float(ess11.min())

        _require(launches11 == 1, f"the {metric_kind} path launched the dc kernel {launches11} times")
        _require(tiles11 == 1, f"the {metric_kind} path's dc launch did not take the tiles form")
        idle11, forms11 = _tiles_idle_share(torch, dc, start, imm11, step11, run_kw)
        _require(forms11 == ["tiles"], f"{metric_kind}: the idle-share launch took {forms11}")
        _require(bool((steps11 == MET_TRANSITIONS).all()),
                 f"{metric_kind}: chains short of {MET_TRANSITIONS} transitions: {int(steps11.min())}")
        for name, t in [("positions", fx11), ("history", hist11), ("ess", ess11)]:
            _require(bool(torch.isfinite(t).all()), f"non-finite {metric_kind} {name}")
        _require(hist11.shape == (MET_CHAINS, MET_TRANSITIONS, LR_D), f"{metric_kind} history shape")
        pooled = second.reshape(-1, LR_D).double()
        z = (pooled.mean(0) - ref_mean) / ref_sd
        ratio = pooled.var(0) / ref_sd**2
        worst_z, lo, hi = float(z.abs().max()), float(ratio.min()), float(ratio.max())
        _require(worst_z <= MET_MEAN_SD,
                 f"{metric_kind}: a mean {worst_z:.3f} posterior sd off the reference")
        _require(MET_VAR_RATIO[0] <= lo and hi <= MET_VAR_RATIO[1],
                 f"{metric_kind}: variance ratios [{lo:.3f}, {hi:.3f}] outside {MET_VAR_RATIO}")
        secs11 = ms11 / 1e3
        leaves11 = float(grads11) / (MET_CHAINS * MET_TRANSITIONS)
        bound11 = metric_bound(imm11, MET_CHAINS, LR_D, MET_TRANSITIONS, float(grads11), n_lr)
        label = ("window_adaptation(nuts, is_mass_matrix_diagonal=False)" if metric_kind == "dense"
                 else f"window_adaptation_low_rank(nuts, max_rank={MET_MAX_RANK})")
        print(f"phase 11 ({metric_kind}): {label} single chain, {MET_WARMUP_STEPS} steps at max_doublings={MET_WARMUP_DOUBLINGS}, "
              f"{warm_leaves} leaves in {warm_s:.2f} s: step size {step11:.6f}, {extra}; "
              f"fused_nuts_run_dc logistic regression {n_lr} x {LR_D} C={MET_CHAINS} "
              f"S={MET_TRANSITIONS} max_doublings={MET_DOUBLINGS}, tiles form: all chains completed, "
              f"kernel {ms11:.2f} ms by CUDA events (bound {bound11[0]:.4f} ms by {bound11[1]}, "
              f"kernel / bound {ms11 / bound11[0]:.1f}; lockstep idle warp-iterations "
              f"{idle11:.4f}), {float(grads11):.0f} grads ({float(grads11) / secs11:.4g} grads/s, "
              f"{leaves11:.3f} leaves per transition), min-ESS over the second half {min_ess11:.1f} "
              f"({min_ess11 / secs11:.4g} ESS/s); against the JAX package's posterior: worst "
              f"mean offset {worst_z:.4f} sd (gate {MET_MEAN_SD}), variance ratios "
              f"[{lo:.4f}, {hi:.4f}] (gate {MET_VAR_RATIO}); launches {launch_counts11} ({smi})")

        # the kernel against its plain version, on the path's metric and step
        # size, from the path's final positions
        cmp_x = fx11[:MET_CMP_CHAINS].contiguous()
        cmp_kw = dict(target=lr_dc, num_steps=MET_CMP_TRANSITIONS, max_num_doublings=MET_DOUBLINGS,
                      seed=SEED, num_track=LR_D, budget=2**MET_DOUBLINGS * MET_CMP_TRANSITIONS)
        before_cmp = dc.LAUNCHES["fused_nuts_dc:x_tiles"]
        kern, kms = _per_chain(torch, dc, True, cmp_x, imm11, step11, cmp_kw)
        _require(dc.LAUNCHES["fused_nuts_dc:x_tiles"] == before_cmp + 1,
                 f"{metric_kind} comparison: the dc launch did not take the tiles form")
        plain, pms = _per_chain(torch, dc, False, cmp_x, imm11, step11, cmp_kw)
        share, share5, err, cmp_grads, plain_grads, other = _matrix_pair(
            torch, f"{metric_kind} logistic regression", kern, plain, MET_CMP_TRANSITIONS)
        dev_ms = _device_ms(torch, lambda: dc.fused_nuts_run_dc(cmp_x, imm11, step11, **cmp_kw),
                            "nuts_dc_kernel", repeats=3)
        device_time = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        cmp_bound = metric_bound(imm11, MET_CMP_CHAINS, LR_D, MET_CMP_TRANSITIONS, cmp_grads,
                                 n_lr)
        cmp_idle, _ = _tiles_idle_share(torch, dc, cmp_x, imm11, step11, cmp_kw)
        print(f"phase 11 ({metric_kind}) comparison: logistic regression {MET_CMP_CHAINS} chains x "
              f"{MET_CMP_TRANSITIONS} transitions: steps identical, grads kernel {cmp_grads:.0f} "
              f"plain {plain_grads:.0f} ({other} chains with other counts, all among those that "
              f"part), {share:.4f} of chains agree to {MATRIX_TOL} (floor "
              f"{AGREE_FLOOR}; {share5:.4f} to {AGREE_TOL}), max |diff| {err:.3g}; kernel "
              f"{kms:.3f} ms (device {device_time}), plain {pms:.1f} ms, bound "
              f"{cmp_bound[0]:.4f} ms by {cmp_bound[1]} (kernel / bound "
              f"{kms / cmp_bound[0]:.1f}), tiles form, lockstep idle warp-iterations "
              f"{cmp_idle:.4f}, {cmp_grads / (MET_CMP_CHAINS * MET_CMP_TRANSITIONS):.3f} leaves "
              f"per transition ({smi})")
        met[metric_kind] = dict(launches=launches11, err=err, ms=kms, plain_ms=pms, bound=cmp_bound)

    # the same pairs on phase 3's width: a Gaussian at d=100, 4,096 chains x
    # 16 transitions, a correlated dense metric and a rank-10 payload
    rng11 = np.random.default_rng(12)
    g_var = np.linspace(0.5, 2.0, D)
    g_target = dc.make_gaussian_target_dc(D, g_var)
    a11 = rng11.standard_normal((D, D))
    g_dense = torch.from_numpy(
        (0.5 * a11 @ a11.T / D + np.diag(rng11.uniform(0.5, 1.5, D))).astype(np.float32)).to(dev)
    u11, _ = np.linalg.qr(rng11.standard_normal((D, MET_MAX_RANK)))
    g_low_rank = LowRankInverseMassMatrix(*(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng11.uniform(0.6, 1.4, D), u11,
        np.concatenate([rng11.uniform(2.5, 6.0, 5), rng11.uniform(0.1, 0.4, 5)]))))
    g_x = torch.from_numpy((0.5 * rng11.standard_normal((C, D))).astype(np.float32)).to(dev)
    for metric_kind, imm in (("dense", g_dense), ("low_rank", g_low_rank)):
        kw = dict(target=g_target, num_steps=16, max_num_doublings=MAX_DOUBLINGS, seed=SEED,
                  num_track=NUM_TRACK, budget=2**MAX_DOUBLINGS * 16)
        kern, kms = _timed(torch, lambda: dc.fused_nuts_run_dc(g_x, imm, 0.3, **kw))
        plain, pms = _timed(torch, lambda: dc.fused_nuts_run_dc_plain(g_x, imm, 0.3, **kw))
        _require(torch.equal(kern[3], plain[3]), f"{metric_kind} Gaussian: steps differ")
        share, err = _agreement(torch, kern[:2], plain[:2])
        _require(share >= AGREE_FLOOR, f"{metric_kind} Gaussian: only {share} of chains agree")
        bound = metric_bound(imm, C, D, 16, float(kern[2]), family="gaussian")
        print(f"phase 11 ({metric_kind}) comparison: Gaussian d={D} C={C} S=16: steps identical, "
              f"{share:.4f} of chains agree to {AGREE_TOL} (floor {AGREE_FLOOR}), max |diff| "
              f"{err:.3g}, grads kernel {float(kern[2]):.0f} plain {float(plain[2]):.0f}; kernel "
              f"{kms:.3f} ms, plain {pms:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]} ({smi})")
        met[metric_kind]["err"] = max(met[metric_kind]["err"], err)

    # the consistency pins (tests/ops/test_fused_nuts_dc_metrics.py:46-71) on
    # the card: diag(v) as a dense matrix and lam = 1 in a low-rank payload
    # give the diagonal kernel's samples
    pin_target = dc.make_gaussian_target_dc(4, [1.0, 4.0, 0.25, 2.0])
    pin_x = torch.from_numpy((0.2 * np.random.default_rng(0).standard_normal((16, 4)))
                             .astype(np.float32)).to(dev)
    pin_kw = dict(target=pin_target, num_steps=10, max_num_doublings=5, seed=3, num_track=4,
                  budget=400, chunk=16)
    v = torch.tensor([1.0, 2.0, 0.5, 1.5], device=dev)
    pin_sigma = torch.tensor([1.0, 1.5, 0.7, 1.2], device=dev)
    pin_u, _ = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(5).standard_normal((4, 2)).astype(np.float32)).to(dev))
    pins = []
    for name, rich, diag in (
            ("dense diag(v)", torch.diag(v), v),
            ("low-rank lam=1", LowRankInverseMassMatrix(pin_sigma, pin_u,
                                                        torch.ones(2, device=dev)), pin_sigma**2)):
        a = dc.fused_nuts_run_dc(pin_x, rich, 0.4, **pin_kw)
        b = dc.fused_nuts_run_dc(pin_x, diag, 0.4, **pin_kw)
        same = torch.equal(a[3], b[3]) and torch.allclose(a[1], b[1], rtol=2e-5, atol=1e-5)
        _require(same, f"consistency pin {name} against the diagonal kernel")
        pins.append(f"{name}: max |diff| {float((a[1] - b[1]).abs().max()):.3g}")
    print(f"phase 11: consistency pins on the card, each against the diagonal kernel "
          f"(rtol 2e-5, atol 1e-5, steps identical): {'; '.join(pins)}")

    # ---- phase 12: the continuous-runner path ----
    marks.append((12, time.perf_counter()))
    runner_leaves = [0]

    def counted_verlet(logdensity_fn, kinetic_energy):
        """Velocity Verlet counting its calls: one per leaf of the runner's
        loop (a restart integrates nothing)."""
        step = integrators.velocity_verlet(logdensity_fn, kinetic_energy)

        def counted(state, step_size):
            runner_leaves[0] += 1
            return step(state, step_size)

        return counted

    def runner(num_steps, **kw):
        return nuts.build_fused_many_steps(
            flagship.logdensity_fn, step4, imm4, num_steps=num_steps,
            max_num_doublings=MAX_DOUBLINGS, integrator=counted_verlet,
            track_fn=lambda state: state.position[:, :NUM_TRACK], **kw)

    def timed_run(run, keys, states):
        runner_leaves[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(keys, states)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, runner_leaves[0]

    # the runner starts where phase 4's dc run ended, at stationarity: from
    # phase 4's initial positions 64 transitions leave log_tau's second half
    # far from its marginal (see PERF.md). The dc machine from the same
    # positions gives the leaves-per-transition yardstick.
    start12 = fx4
    states12 = nuts.init(start12, flagship.logdensity_fn)
    dc_kw = dict(target=dc.make_hierarchical_target_dc(D), num_steps=RUNNER_TRANSITIONS,
                 max_num_doublings=MAX_DOUBLINGS, seed=SEED, num_track=NUM_TRACK,
                 budget=2**MAX_DOUBLINGS * RUNNER_TRANSITIONS)
    dc_leaves12 = float(dc.fused_nuts_run_dc(start12, imm4, step4, **dc_kw)[2]) / (
        C * RUNNER_TRANSITIONS)
    # the keys of bench.py:230-232: per step, per chain
    keys12 = prng.split(prng.split(prng.key(SEED, dev), RUNNER_TRANSITIONS), C)
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    (final12, hist12, grads12), run12_s, iters12 = timed_run(
        runner(RUNNER_TRANSITIONS, unroll=RUNNER_UNROLL, restart_every=1), keys12, states12)
    launches12 = dict(dc.LAUNCHES)
    ess12 = blackjax_tpu_torch.ess(hist12)
    min_ess12 = float(ess12.min())
    grads12 = int(grads12)
    leaves12 = grads12 / (C * RUNNER_TRANSITIONS)

    _require(launches12["threefry2x32"] > 0, "the runner path launched no threefry kernel")
    _require(hist12.shape == (C, RUNNER_TRANSITIONS, NUM_TRACK), "phase 12 history shape")
    _require(bool((hist12 != 0).any(-1).all()), "a chain of the runner left a transition open")
    for name, t in [("positions", final12.position), ("history", hist12), ("ess", ess12)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite runner {name}")
    mean_lt12, var_lt12 = _log_tau_moments(hist12)
    _require(abs(mean_lt12) < 0.3 and abs(var_lt12 - 1.0) < 0.3,
             f"runner log_tau moments {mean_lt12}, {var_lt12} far off its N(0, 1) marginal")
    _require(abs(leaves12 / dc_leaves12 - 1.0) <= LEAVES_REL,
             f"runner {leaves12:.3f} leaves a transition against the dc machine's "
             f"{dc_leaves12:.3f}")
    # ms per loop iteration without the block unrolling, 8 transitions
    (_, _, grads_u1), u1_s, iters_u1 = timed_run(
        runner(RUNNER_CMP_TRANSITIONS, unroll=1), keys12[:RUNNER_CMP_TRANSITIONS], states12)
    print(f"phase 12: build_fused_many_steps d={D} C={C} S={RUNNER_TRANSITIONS} max_doublings="
          f"{MAX_DOUBLINGS} unroll={RUNNER_UNROLL} restart_every=1 oversubscription=1 from phase "
          f"4's final positions: {run12_s:.2f} s, {iters12} loop iterations "
          f"({run12_s / iters12 * 1e3:.3f} ms each; unroll=1 over {RUNNER_CMP_TRANSITIONS} "
          f"transitions: {iters_u1} iterations in {u1_s:.2f} s, {u1_s / iters_u1 * 1e3:.3f} ms "
          f"each), {grads12} grads ({grads12 / run12_s:.4g} grads/s, {leaves12:.3f} leaves per "
          f"transition; the dc machine from the same positions {dc_leaves12:.3f}), min-ESS over "
          f"{NUM_TRACK} tracked dims {min_ess12:.1f} ({min_ess12 / run12_s:.4g} ESS/s), log_tau "
          f"over the second half: mean {mean_lt12:.4f} var {var_lt12:.4f}; launches "
          f"{launches12} ({smi})")

    # bit identity: runner (m=1, unroll=1) == runner (m=4, unroll=4,
    # restart_every=2) == a loop over the kernel, with the same keys
    head12 = type(states12)(*(a[:RUNNER_CMP_CHAINS] for a in states12))
    keys_cmp = keys12[:RUNNER_CMP_TRANSITIONS, :RUNNER_CMP_CHAINS].contiguous()
    kernel12, state, scan_hist, scan_grads = nuts.build_kernel(), head12, [], 0
    for t in range(RUNNER_CMP_TRANSITIONS):
        state, info = kernel12(keys_cmp[t], state, flagship.logdensity_fn, step4, imm4,
                               MAX_DOUBLINGS)
        scan_hist.append(state.position[:, :NUM_TRACK])
        scan_grads += int(info.num_integration_steps.sum())
    scan_hist = torch.stack(scan_hist, 1)
    identity = []
    for label, kw in [("m=1 unroll=1", dict()),
                      ("m=4 unroll=4 restart_every=2",
                       dict(oversubscription=4, unroll=4, restart_every=2))]:
        (final, h, g), _, _ = timed_run(runner(RUNNER_CMP_TRANSITIONS, **kw), keys_cmp, head12)
        _require(int(g) == scan_grads, f"runner {label}: {int(g)} grads, the kernel's loop "
                 f"{scan_grads}")
        _require(torch.allclose(h, scan_hist, rtol=RUNNER_TOL, atol=RUNNER_TOL)
                 and torch.allclose(final.position, state.position, rtol=RUNNER_TOL,
                                    atol=RUNNER_TOL), f"runner {label} != the kernel's loop")
        identity.append(
            f"{label}: grads identical, history bit for bit {torch.equal(h, scan_hist)} (max "
            f"|diff| {float((h - scan_hist).abs().max()):.3g}), finals bit for bit "
            f"{torch.equal(final.position, state.position)}")
    print(f"phase 12 bit identity on {RUNNER_CMP_CHAINS} chains x {RUNNER_CMP_TRANSITIONS} "
          f"transitions against a loop over nuts.build_kernel with the same keys ({scan_grads} "
          f"grads; tolerance {RUNNER_TOL} where not bitwise): {'; '.join(identity)}")

    # ---- phase 13: the older NUTS machine's path ----
    marks.append((13, time.perf_counter()))
    fn_kw = dict(target=fn.make_mxu_safe_hierarchical_target(D), num_steps=LEGACY_TRANSITIONS,
                 max_num_doublings=MAX_DOUBLINGS, seed=SEED, num_track=NUM_TRACK,
                 budget=LEGACY_BUDGET, chunk=LEGACY_CHUNK)
    fn.fused_nuts_run(positions[:8], imm4, step4, **dict(fn_kw, num_steps=1))  # first launch
    for name in fn.LAUNCHES:
        fn.LAUNCHES[name] = 0
    (fx13, hist13, grads13, steps13), ms13 = _timed(
        torch, lambda: fn.fused_nuts_run(positions, imm4, step4, **fn_kw))
    launches13 = fn.LAUNCHES["fused_nuts"]
    forms13 = dict(fn.LAUNCHES)
    ess13 = blackjax_tpu_torch.ess(hist13)
    min_ess13 = float(ess13.min())
    leaves13, leaves4 = float(grads13) / (C * LEGACY_TRANSITIONS), grads4 / (C * S)

    _require(launches13 == 1 and forms13["fused_nuts:resident"] == 1,
             f"fused_nuts_run launched {forms13}, not once in the resident form")
    _require(bool((steps13 == LEGACY_TRANSITIONS).all()),
             f"chains short of {LEGACY_TRANSITIONS} transitions: {int(steps13.min())}")
    for name, t in [("positions", fx13), ("history", hist13), ("ess", ess13)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite phase 13 {name}")
    mean_lt13, var_lt13 = _log_tau_moments(hist13)
    _require(abs(mean_lt13) < 0.3 and abs(var_lt13 - 1.0) < 0.3,
             f"phase 13 log_tau moments {mean_lt13}, {var_lt13} far off its N(0, 1) marginal")
    _require(abs(leaves13 / leaves4 - 1.0) <= LEAVES_REL,
             f"fused_nuts_run {leaves13:.3f} leaves a transition, phase 4's dc run {leaves4:.3f}")
    secs13 = ms13 / 1e3
    bound13 = _legacy_bound(peaks, C, LEGACY_TRANSITIONS, float(grads13))
    # the registers form on the same inputs: the same bits at the path's shape
    registers_run13 = fn.fused_nuts_run(positions, imm4, step4, form="registers", **fn_kw)
    _require(all(torch.equal(a, b) for a, b in
                 zip((fx13, hist13, grads13, steps13), registers_run13)),
             "phase 13: the resident and the registers forms differ at 4096 x 256")
    occ13 = {form: fn.occupancy(D, form == "resident") for form in fn.FORMS}
    print(f"phase 13: fused_nuts_run (the older machine, csrc/fused_nuts.cu) d={D} C={C} "
          f"S={LEGACY_TRANSITIONS} max_doublings={MAX_DOUBLINGS} budget={LEGACY_BUDGET} from phase "
          f"4's positions on its step size and metric: all chains completed, one launch in the "
          f"resident form ({occ13['resident']['warps_per_sm']} warps an SM, "
          f"{occ13['resident']['registers']} registers, {occ13['resident']['local_bytes']} B local "
          f"a thread; the registers form {occ13['registers']['warps_per_sm']} warps an SM, "
          f"{occ13['registers']['registers']} registers, {occ13['registers']['local_bytes']} B), kernel "
          f"{ms13:.2f} ms (bound {bound13[0]:.4f} ms by {bound13[1]}, kernel / bound "
          f"{ms13 / bound13[0]:.1f}), {float(grads13):.0f} grads ({float(grads13) / secs13:.4g} grads/s, "
          f"{leaves13:.3f} leaves per transition; phase 4's dc run {leaves4:.3f}), min-ESS over "
          f"{NUM_TRACK} tracked dims {min_ess13:.1f} ({min_ess13 / secs13:.4g} ESS/s), log_tau "
          f"over the second half: mean {mean_lt13:.4f} var {var_lt13:.4f}; ptxas "
          f"{'; '.join(_ptxas_summary(fn_log))}; the registers form on the same inputs: all "
          f"four outputs bit for bit ({smi})")

    # the kernel against its plain version: the flagship, the trace, logistic regression
    cmp13 = dict(fn_kw, num_steps=LEGACY_CMP_TRANSITIONS,
                 budget=2**MAX_DOUBLINGS * LEGACY_CMP_TRANSITIONS, chunk=2**MAX_DOUBLINGS)
    head13 = positions[:LEGACY_CMP_CHAINS].contiguous()

    def legacy_call():
        return fn.fused_nuts_run(head13, imm4, step4, **cmp13)

    kern, _ = _timed(torch, legacy_call)
    # the two forms of the kernel, bit for bit
    registers13 = fn.fused_nuts_run(head13, imm4, step4, form="registers", **cmp13)
    _require(all(torch.equal(a, b) for a, b in zip(kern, registers13)),
             "phase 13: the resident and the registers forms differ")
    plain, fn_plain_ms = _timed(
        torch, lambda: fn.fused_nuts_run_plain(head13, imm4, step4, **cmp13))
    _require(torch.equal(kern[3], plain[3]) and float(kern[2]) == float(plain[2]),
             "phase 13: steps or gradient totals differ from the plain version")
    share13, err13 = _agreement(torch, kern[:2], plain[:2])
    _require(share13 >= AGREE_FLOOR, f"phase 13: only {share13} of chains agree")
    fn_ms = _timed_mean(torch, legacy_call, 5)
    fn_dev_ms = _device_ms(torch, legacy_call, "nuts_", repeats=5)  # either form's kernel
    cmp_grads = float(kern[2])
    fn_bound = _legacy_bound(peaks, LEGACY_CMP_CHAINS, LEGACY_CMP_TRANSITIONS, cmp_grads)
    device_time = "not measured" if fn_dev_ms is None else f"{fn_dev_ms:.4f} ms"
    trace_kw = dict(fn_kw, num_steps=LEGACY_TRACE_TRANSITIONS, budget=LEGACY_TRACE,
                    chunk=LEGACY_TRACE, trace=LEGACY_TRACE)
    head_t = positions[:LEGACY_TRACE_CHAINS].contiguous()
    before = fn.LAUNCHES["fused_nuts:registers"]
    kern_t = fn.fused_nuts_run(head_t, imm4, step4, **trace_kw)
    _require(fn.LAUNCHES["fused_nuts:registers"] == before + 1,
             "phase 13: the trace did not take the registers form")
    plain_t = fn.fused_nuts_run_plain(head_t, imm4, step4, **trace_kw)
    trace_share = {}
    for col in fn.TRACE_COLS:
        same = torch.isclose(kern_t[4][col], plain_t[4][col], rtol=AGREE_TOL, atol=AGREE_TOL,
                             equal_nan=True).all(0)
        trace_share[col] = float(same.float().mean())
    _require(min(trace_share.values()) >= AGREE_FLOOR, f"phase 13 trace columns {trace_share}")
    x13 = torch.from_numpy((0.05 * np.random.default_rng(13).standard_normal(
        (DC_CHAINS, LR_D))).astype(np.float32)).to(dev)
    lr_kw = dict(target=lr, num_steps=8, max_num_doublings=6, seed=SEED, num_track=NUM_TRACK,
                 budget=2**6 * 8, chunk=2**6)
    lr_ones = torch.ones(LR_D, device=dev)
    kern_l, lr_ms = _per_chain(torch, fn, True, x13, lr_ones, 0.01, lr_kw)
    plain_l, _ = _per_chain(torch, fn, False, x13, lr_ones, 0.01, lr_kw)
    share_l, _, err_l, lr_grads, lr_plain_grads, lr_other = _matrix_pair(
        torch, "phase 13 logistic regression", kern_l, plain_l, 8)
    print(f"phase 13 comparisons: flagship {LEGACY_CMP_CHAINS} x {LEGACY_CMP_TRANSITIONS}: the "
          f"resident and the registers forms bit for bit; steps "
          f"and gradient totals identical ({cmp_grads:.0f} grads), {share13:.4f} of chains agree "
          f"to {AGREE_TOL} (floor {AGREE_FLOOR}), max |diff| {err13:.3g}, kernel {fn_ms:.3f} ms "
          f"(device {device_time}), plain {fn_plain_ms:.1f} ms, bound {fn_bound[0]:.4f} ms by "
          f"{fn_bound[1]}; trace={LEGACY_TRACE} on {LEGACY_TRACE_CHAINS} x "
          f"{LEGACY_TRACE_TRANSITIONS}: smallest share of chains with a column identical to "
          f"{AGREE_TOL}: {min(trace_share.values()):.4f}; logistic regression {LR_N} x {LR_D}, "
          f"{DC_CHAINS} x 8: steps identical, grads kernel {lr_grads:.0f} plain "
          f"{lr_plain_grads:.0f} ({lr_other} chains with other counts, all among those that "
          f"part), {share_l:.4f} of chains agree to {MATRIX_TOL}, max |diff| {err_l:.3g}, kernel "
          f"{lr_ms:.3f} ms ({smi})")

    # ---- phase 14: MCLMC on the logistic regression ----
    marks.append((14, time.perf_counter()))
    for name in fm.LAUNCHES:
        fm.LAUNCHES[name] = 0
    generator = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tune_state = mclmc.init(torch.zeros(LR_D, device=dev), lr.logdensity_fn, generator)
    tune_end, tuned, tune_total14 = blackjax_tpu_torch.mclmc_find_L_and_step_size(
        mclmc.build_kernel(), MCLMC_TUNE_STEPS, tune_state, generator,
        logdensity_fn=lr.logdensity_fn)
    L14, step14, imm14 = float(tuned.L), float(tuned.step_size), tuned.inverse_mass_matrix
    tune14_s = time.perf_counter() - t0
    _require(np.isfinite([L14, step14]).all() and L14 > 0 and step14 > 0,
             f"logistic regression: tuned L {L14}, step size {step14}")
    _require(bool(torch.isfinite(imm14).all() and (imm14 > 0).all()),
             "logistic regression: tuned metric")
    rng14 = np.random.default_rng(14)
    x14 = tune_end.position + torch.from_numpy(
        (0.01 * rng14.standard_normal((C, LR_D))).astype(np.float32)).to(dev)
    m14 = torch.from_numpy(rng14.standard_normal((C, LR_D)).astype(np.float32)).to(dev)
    m14 = m14 / torch.linalg.vector_norm(m14, dim=1, keepdim=True)
    kw14 = dict(target=lr, num_steps=LR_MCLMC_STEPS, seed=SEED, track_dims=range(LR_D))

    def lr_mclmc():
        return fm.fused_mclmc(x14, m14, imm14, step14, L14, **kw14)

    (fx14, fm14, ld14, hist14), cold14 = _timed(torch, lr_mclmc)
    launches14 = dict(fm.LAUNCHES)
    _require(launches14["fused_mclmc"] == 1 and launches14["fused_mclmc:logreg_tiles"] == 1,
             f"phase 14: fused_mclmc launches {launches14}, not one in the tiles form")
    for name, t in [("positions", fx14), ("momenta", fm14), ("log densities", ld14),
                    ("history", hist14)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite {name} at phase 14")
    _require(hist14.shape == (C, LR_MCLMC_STEPS, LR_D), "phase 14 history shape")
    second14 = hist14[:, LR_MCLMC_STEPS // 2:]
    ess14 = blackjax_tpu_torch.ess(second14.double())
    _require(bool(torch.isfinite(ess14).all()), "non-finite ESS at phase 14")
    min_ess14 = float(ess14.min())
    pooled14 = second14.reshape(-1, LR_D).double()
    z14 = float(((pooled14.mean(0) - ref_mean) / ref_sd).abs().max())
    # timed warm: the main path's call above also paid for the allocation
    # of the 885 MB history between its events
    ms14 = _timed_mean(torch, lr_mclmc, 1)
    dev_ms14 = _device_ms(torch, lr_mclmc, "mclmc_kernel", repeats=2)
    bound14 = _bound(4 * C * LR_D * 4 + C * 4 + hist14.numel() * 4 + X9.nbytes + y9.nbytes,
                     C * LR_MCLMC_STEPS * (2 * lr_grad + MCLMC_STEP_OPS * LR_D), peaks,
                     C * LR_MCLMC_STEPS * 2 * LR_D * THREEFRY_OPS, d=LR_D)
    secs14 = ms14 / 1e3
    grads14 = C * (2 * LR_MCLMC_STEPS + 1)
    device_time = "not measured" if dev_ms14 is None else f"{dev_ms14:.2f} ms"
    print(f"phase 14: mclmc_find_L_and_step_size on the logistic regression {LR_N} x {LR_D}, "
          f"single chain, {tune_total14} tuning steps in {tune14_s:.2f} s: L {L14:.5f}, step "
          f"size {step14:.5f}, mean imm {float(imm14.mean()):.6f}; fused_mclmc C={C} "
          f"{LR_MCLMC_STEPS} steps in one launch, tiles form ({lf.tiles_plan(LR_D).chains} "
          f"chains a block, {lf.tiles_plan(LR_D).tile_rows}-row tiles): kernel {ms14:.2f} ms by "
          f"CUDA events on a warm call ({cold14:.2f} ms on the first, the history's allocation "
          f"included; device {device_time} by torch.profiler), bound {bound14[0]:.3f} ms by "
          f"{bound14[1]} (kernel / bound {ms14 / bound14[0]:.1f}), {grads14} grads "
          f"({grads14 / secs14:.4g} grads/s), min-ESS over the second half of all {LR_D} "
          f"coordinates {min_ess14:.1f} ({min_ess14 / secs14:.4g} ESS/s), largest |mean - the "
          f"JAX package's NUTS mean| {z14:.4f} posterior sd (reported, not gated); launches "
          f"{launches14} ({smi})")

    # ---- phase 15: the tracked eight-schools path ----
    marks.append((15, time.perf_counter()))
    launches15, es_form = eight_schools_path(torch, dev, es_target, peaks, smi)

    # ---- phase 16: the tracked adaptive-tempered SMC path ----
    marks.append((16, time.perf_counter()))
    launches16 = smc_path(torch, dev, smi)

    # ---- phase 17: the MCMC family beyond NUTS, the tracked static-HMC config ----
    marks.append((17, time.perf_counter()))
    threefry17, transitions17 = family_path(torch, dev, smi)

    # ---- phase 18: the tracked SG-MCMC configurations ----
    marks.append((18, time.perf_counter()))
    threefry18 = sgmcmc_path(torch, dev, smi)

    marks.append((None, time.perf_counter()))
    print("wall seconds per phase (host clock): " + ", ".join(
        f"{a}: {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])))

    lf_ops = C * ((HMC_STEPS + 1) * GRAD_OPS["hierarchical"] * D
                  + HMC_STEPS * LEAPFROG_STEP_OPS * D)
    kernels = [
        _entry("fused_nuts_dc", "fused_nuts_dc.cu", "blackjax_tpu/ops/fused_nuts_dc.py:964",
               launches["fused_nuts_dc"], err3, ms3, plain_ms3,
               _bound(2 * C * D * 4 + C * 16 * NUM_TRACK * 4 + 3 * C * 4,
                      grads3 * (DC_LEAF_OPS + GRAD_OPS["hierarchical"]) * D, peaks,
                      (grads3 + C * 16 * D) * THREEFRY_OPS, d=D)),
        _entry("fused_leapfrog", "fused_leapfrog.cu", "blackjax_tpu/ops/fused_leapfrog.py:206",
               leapfrog6, err5, *lf_times["hierarchical"],
               _bound(4 * C * D * 4 + C * 4, lf_ops, peaks, d=D)),
        _entry("fused_leapfrog (hmc transition)", "fused_leapfrog.cu",
               "blackjax_tpu/ops/fused_leapfrog.py:206", tr_launches + transitions17, err5t,
               *tr_times["hierarchical"][:2], tr_bound),
        _entry("fused_mclmc (resident form)", "fused_mclmc.cu",
               "blackjax_tpu/ops/fused_mclmc.py:301", launches8["fused_mclmc:resident"], err7,
               ms7, plain_ms7, _mclmc_bound(peaks, C, MCLMC_CMP_STEPS, D, NUM_TRACK)),
    ]
    # the MCLMC kernel on logistic regression has a main path since phase 14,
    # the dc machine's eight schools since phase 15
    pairs["mclmc_logreg"]["launches"] = launches14["fused_mclmc:logreg_tiles"]
    pairs["eight_schools"]["launches"] = launches15[f"fused_nuts_dc:{es_form}"]
    for key, name, source, replaces in [
        ("horseshoe", "fused_nuts_dc:finnish_horseshoe", "matrix_targets.cuh",
         "blackjax_tpu/ops/targets_dc.py:144"),
        ("logreg_dc", "fused_nuts_dc:logreg", "matrix_targets.cuh",
         "blackjax_tpu/ops/targets_dc.py:61"),
        ("eight_schools", f"fused_nuts_dc:eight_schools ({es_form} form)", "fused_nuts_dc.cuh",
         "blackjax_tpu/ops/targets_dc.py:365"),
        ("leapfrog_logreg", "fused_leapfrog:logistic_regression (tiles form)",
         "matrix_targets.cuh", "blackjax_tpu/ops/fused_leapfrog.py:324"),
        ("mclmc_logreg", "fused_mclmc:logistic_regression (tiles form)", "matrix_targets.cuh",
         "blackjax_tpu/ops/fused_leapfrog.py:324"),
    ]:
        f = pairs[key]
        kernels.append(_entry(name, source, replaces, f["launches"], f["err"], f["ms"],
                              f["plain_ms"], f["bound"]))
    for metric_kind, line in (("dense", 262), ("low_rank", 267)):
        f = met[metric_kind]
        kernels.append(_entry(f"fused_nuts_dc/{metric_kind}", f"fused_nuts_dc_{metric_kind}.cu",
                              f"blackjax_tpu/ops/fused_nuts_dc.py:{line}", f["launches"],
                              f["err"], f["ms"], f["plain_ms"], f["bound"]))
    kernels.append(_entry("fused_nuts", "fused_nuts.cu", "blackjax_tpu/ops/fused_nuts.py:711",
                          launches13, err13, fn_ms, fn_plain_ms, fn_bound))
    kernels.append(_entry("threefry2x32 (a key per element)", "fused_nuts_dc.cu",
                          "blackjax_tpu/mcmc/trajectory.py:764",
                          launches12["threefry2x32"] + launches16 + threefry17 + threefry18,
                          tf_err, tf_ms, tf_plain_ms, tf_bound))
    kernels.append(_entry("vpu_peak (unfused fma)", "vpu_peak.cu", "benchmarks/vpu_peak.py:58",
                          vpu["launches"], vpu["err"], vpu["ms"], vpu["plain_ms"], vpu["bound"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
