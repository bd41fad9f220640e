"""Smoke test of blackjax_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It drives the port's seventeen main paths once, five at the flagship's full
width (the 100-dim hierarchical posterior, 4,096 chains), one at the
Finnish horseshoe's (N=100, M=200, d=404, 512 chains), three at the
covertype-class logistic regression's (4,096 x 54; 1,024 chains under NUTS,
4,096 under MCLMC), one at the tracked eight-schools configuration's
(d=10, 512 chains x 800 transitions), one at the tracked tempered-SMC
configuration's (d=10, 16,384 particles), one at the same target's under
persistent sampling, pretuning and nested slice sampling (16,384 particles
or live points), one at the tracked static-HMC
configuration's (d=100, 128 chains) under the MCMC family beyond NUTS and
one at the tracked SG-MCMC configurations' (SGLD on the covertype-class
logistic regression, one chain and 4,096 chains), one at the tracked
cross-chain configurations' (ChEES and MEADS, d=100, 4,096 chains), one
at Pathfinder's warmup on config #5's target and start (4,096 chains and
paths), one at the variational families on that target (the Gaussian
families at 100 draws a step, SVGD on 4,096 particles, 4,096
Schrödinger-Föllmer bridges), and reads the card's
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
   ``cosf`` may differ from torch by an ulp); then the normal kernel
   (``prng.normal``'s transform of the threefry words, ``bjt_normal``) on
   1,048,576 words in float32 and float64: bit for bit its plain version on
   the card, float32 bit for bit the port on the CPU (float64 takes CUDA's
   ``log``: the count of draws apart is printed), with both times;
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
   4,096 chains from phase 4's final positions, 16 transitions (cut from the
   bench's 256: the runner reads its loop condition on the host once per
   block) at ``unroll=4``, 8 tracked coordinates, keys ``(16, 4096, 2)``
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
   them: ``hmc`` for 128 transitions (cut from 131,072: the generic step
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
   x d = 5 for 2 transitions on the card and on the CPU, on the same keys:
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
   run key ``split(key(26), 4)[0]``), each cut from 20,000 steps to 2,500
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
19. persistent-sampling SMC, pretuning and nested slice sampling on phase
   16's target (16,384 particles or live points, f32, key 18), threefry launch
   counts reset just before them (the two SMC samplers timed after a warm
   run on key 17): ``adaptive_persistent_sampling_smc`` (a
   history of 50 slots, MALA at 0.1, systematic resampling, target ESS 0.5, 5
   MCMC steps) to lambda = 1; ``pretuning`` over ``tempered_smc`` along
   linspace(0.05, 1, 20) with a per-particle MALA step size (sigma 0.05,
   alpha 1, the step size kept positive, the ESJD in the identity metric);
   ``nss`` deleting 2,048 a step with 20 inner steps and ``nsswig`` with 1
   (a sweep of the 10 coordinates), both until ``logZ_live - logZ < -3``
   (at most 400 steps), then ``ns.utils.sample`` (16,384 draws) and
   ``ns.utils.ess``. Each line gives log Z against the exact value, the
   largest mean error against 0.9 obs and the variances, gated at about
   three times the worst errors of the JAX package's own CPU runs of the
   same configuration (``tools/particle_reference.py``), the steps, seconds
   by host clock and by CUDA events, runs/sec, host ms a step, threefry
   launches and the busy share (the nested samplers' over a 2-step run).
   Then each sampler in f64 at 1,024 particles or live points (the nested
   samplers deleting 128) for 3 steps on the card and on the CPU on the same
   key: ancestors, dead and start indices, ``num_shrink`` and
   ``num_expansions`` identical, particles within 1e-9. Then the threefry
   export at the path's launch sizes (1,024 to 163,840 keys) by CUDA events,
   bit for bit its plain version, with each size's bound by bytes.
20. the tracked cross-chain ChEES configuration (``benchmarks/tracked.py:
   744-788``): ``chees_adaptation`` on ``ill_conditioned_gaussian(100)``, 4,096
   chains from ``normal(key(19), (4096, 100))``, step size 0.05, the optax twin
   ``adam(0.25)``, 1,000 steps and the defaults, f32, threefry launch counts
   reset just before the timed run on ``split(key(19), 4)[0]`` (after a warm
   run of 20 steps). Its line gives the seconds by host clock and by CUDA
   events, host ms a step, the leapfrog gradients (the sum of
   ``info.info.num_integration_steps``) and leapfrog-grads/sec, threefry
   launches a step, the final step size, integration-steps parameter,
   trajectory length and the last step's harmonic-mean acceptance, and the
   busy share over an 8-step run; the step size and the parameter must lie
   within three times the spread of the JAX package's values over the four
   keys (or 5 %, ``tools/chees_reference.py``), the final ensemble's
   variances within [0.85, 1.15] of the target's and its means within 0.1
   sd of 0, every tensor on the card and finite. Then
   ``mass_matrix_estimation="diagonal"`` with ``_length_floor=True`` at
   4,096 x 200 steps (cut from 1,000): the adapted inverse mass matrix within
   [0.8, 1.25] of the variances, and the returned length between ChEES's own
   floored at ``(pi/2) sqrt`` of the smallest and of the largest eigenvalue of
   the window's covariance whitened by that matrix (recomputed here from the
   run's positions, by ``eigvalsh``; the port's power iteration returns a
   Rayleigh quotient between the two). Then both settings in f64 at 256
   chains x 33 steps on the card and on the CPU on key 20 (the window opens
   at step 16, so the floor's in-loop eigen refresh runs at step 32): step
   counts identical, every step's controller state, every chain's positions
   and the returned parameters (the integration-steps parameter among them)
   within 1e-9; the floored run's step counts must differ from an unfloored
   run's on the CPU, so the floor bound on some step of the hold.
21. the tracked MEADS configuration (``benchmarks/tracked.py:859-893``):
   ``meads_adaptation`` on ``ill_conditioned_gaussian(100)``, 4,096 chains
   from ``normal(key(29), (4096, 100))``, its defaults (4 folds, step-size
   multiplier 0.5, damping slowdown 1.0), f32, 1,000 steps on the first key
   of ``split(key(29), 3)`` and 200 (cut) on the other two (after a warm
   run of 20 steps), the per-step info filtered to the per-fold parameters
   (the configuration's jit discards it), threefry and normal launch counts
   reset just before the run on key 0. Its lines give each run's seconds by
   host clock and by CUDA events, chain-steps/sec of key 0's run (4,096 x
   1,000 over its seconds, as the configuration reckons it), host ms a
   step, threefry and
   normal launches a step, the host syncs made inside the steps of an
   8-step run (torch's CUDA sync debug mode, by the stack of each; 0
   required) and the busy share over an 8-step run; each
   key's final step size, alpha and delta and the smallest and largest
   ratio of the final variances to the target's and of the momentum scale
   to its standard deviations must lie within three times the spread of the
   JAX package's values over the three keys, or 5 % of their mean
   (``tools/meads_reference.py``), every tensor on the card and finite.
   Then MEADS-LRD (rank 8, the window over the second half) at 4,096 x 200
   steps (cut from 1,000): every value finite and on the card, the payload
   the window's eigh estimate, its seconds and host syncs. Then the
   defaults and LRD in f64 at 256 chains x 40 steps (the configuration's
   CPU size) on the card and on the CPU on key 21: the final states, every
   step's per-fold parameters and the returned ones (LRD's as its operator
   ``U diag(lam) U^T``) within 1e-9 relative to ``max(|x|, 1)``.
22. Pathfinder on config #5's target and start
   (``benchmarks/tracked.py:744-788``; no published configuration runs
   Pathfinder): ``pathfinder_adaptation(hmc, ill_conditioned_gaussian(100)
   .logdensity_fn, num_chains=4096, num_integration_steps=20)`` with
   ``n_paths`` at its default (4,096 paths of 200 draws), from row 0 of
   ``normal(key(19), (4096, 100))``, f32, 400 steps on the first key of
   ``split(key(23), 3)`` and 100 (cut) on the other two, after a warm run of
   20 steps, the info cut to the acceptance rates and step sizes,
   threefry and normal launch counts and the L-BFGS and line-search loops'
   counts reset before each run. Its lines give the seconds of each run by
   host clock and CUDA events, split at the dual-averaging loop into the
   Pathfinder stage (L-BFGS, the ELBOs, PSIS, the mixture covariance, the
   starts) and the dual-averaging stage, each stage's threefry and normal
   launches, the L-BFGS and line-search iterations of the batch, host ms a
   step, leapfrog-grads/sec (4,096 x 20 x 400 over the stage) and
   chain-steps/sec, the host syncs in an 8-step run's dual-averaging steps
   (0 required; the metric's one Cholesky factor before them is not a
   step's) and the busy share of an 8-step run; each key's inverse mass
   matrix's diagonal over the target's variances (smallest, largest), its
   off-diagonal mass, the per-chain step sizes' median, smallest and
   largest, and the final positions' variances over the target's
   (smallest, largest) must lie within the JAX package's bands
   (``tools/pathfinder_reference.py``: its three keys at 1,024 chains, 400
   steps for key 0 and 100 for keys 1-2), every tensor on the card and
   finite; Pareto k-hat is reported. Then single-path
   ``pathfinder.approximate`` and ``sample`` of 4,096 draws, the chosen
   state's ``lbfgs_inverse_hessian_to_low_rank_metric`` as its operator
   within 1e-4 of ``lbfgs_inverse_hessian_formula_1`` (f32), and
   ``multipathfinder`` init on 4,096 paths and its PSIS resampling of 4,096
   draws. Then the f64 hold on key 24 at 16 chains x 40 steps: the run's
   Pathfinder stage on the card and on the CPU (every iterate, gradient and
   factor and every finite ELBO of every path, the draws, their
   log-densities, the PSIS weights), the inverse mass matrix and k-hat, the
   free run's first 3 steps, and every step 1-39 taken on the card from the
   CPU's state before it (the final states and step sizes among them), all
   within 1e-9 relative to ``max(|x|, 1)``; the free runs' final positions'
   distance is reported (the dual averaging's first steps pass the
   leapfrog's stability limit, where rounding grows tenfold a step).
23. the rest of ``vi/`` on config #5's target
   (``benchmarks/tracked.py:744-788``; no published configuration runs
   these families), f32: ``meanfield_vi`` with ``adam(0.05)`` and
   ``fullrank_vi`` with ``adam(0.02)`` (the optax twins),
   ``num_samples=100``, from zeros, 500 steps on the first key of
   ``split(key(24), 3)`` and 250 (cut) on the other two, step ``i`` on
   ``fold_in(key, i)``; ``svgd`` with ``sgd(0.02 x 4,096)`` under the median
   heuristic on the 4,096 particles of ``normal(key(19), (4096, 100))``, 500
   steps, its statistics at 200 and 500 (SVGD takes no key: one run);
   ``schrodinger_follmer`` with ``n_steps=100`` and ``n_inner_samples=200``
   over 4,096 bridges on each of the three keys. Each family first runs 2
   steps warm, then a short run in torch's CUDA sync debug mode (0 host
   syncs inside a step required) and 8 steps under the profiler (the busy
   share); threefry and normal launch counts are reset before each timed
   run. Its lines give each run's seconds by host clock and CUDA events,
   host ms a step, steps/sec, gradient evaluations/sec (the Gaussian
   families: 100 draws a step), particle-steps/sec (SVGD) or
   bridge-steps/sec, threefry and normal launches a step; each run's
   statistics must lie within the JAX package's bands
   (``tools/vi_reference.py``: three keys, or three 1,024-row blocks of the
   start for SVGD, at 1,024 particles and bridges, with the drift from
   256): the fitted standard deviations over the target's (smallest,
   largest), the means' largest ``|mu| / sd``, the final ELBO and
   full-rank's off-diagonal mass of ``L L^T``; the particles' and bridges'
   variances over the target's (smallest, largest) and their means'
   largest ``|mean| / sd``; every tensor on the card and finite. Then the
   f64 hold from key 25: 20 steps of each Gaussian family, SVGD at 256
   particles x 20 steps, and 64 bridges x 20 steps of 32 inner draws
   (``sample`` equal to its steps), every step's state on the card within
   1e-9 of the CPU's, relative to ``max(|x|, 1)``.

A line then gives the host-clock seconds of each phase. The line before
the last is the per-kernel JSON record: one entry per
kernel of the main paths (``ms`` and ``plain_ms`` are phase 3's, 5's and 7's
like-for-like times), one per new (kernel, target) pair (phase 9's and
10's times) and one per metric of the dc machine (phase 11's logistic
regression comparison), one for the older machine (phase 13's 512 x 16 times; eight schools'
launches are phase 15's)
and one for the threefry kernel with a key per element (phase 2's times on
1,048,576 keys; its launches are phases 12's and 16-23's), one for the
normal kernel (phase 2's float32 times; its launches are phases 12's and
16-23's), and one
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
import contextlib
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
# (32 since phase 20 took the time of the other 32, 16 since phase 23 took half of
# what remained: it reports ms a loop iteration)
RUNNER_TRANSITIONS, RUNNER_UNROLL = 16, 4
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
# phase 19: persistent-sampling SMC, pretuning and nested slice sampling on
# phase 16's target (d = 10, prior N(0, 9 I), likelihood N(obs, I), 16,384
# particles or live points from 3 N(0, I) of numpy seed 1), f32: the adaptive
# persistent sampler at phase 16's settings with the configuration's cap of 50
# tempering steps as its history; pretuning over tempered_smc along
# linspace(0.05, 1, 20) with a per-particle MALA step size; nss deleting 2,048
# a step with max(5, 2 d) = 20 inner steps (blackjax_tpu/ns/nss.py:242-244)
# until logZ_live - logZ < -3, at most 400 steps, then 16,384 posterior draws
PS_N_SCHEDULE = 50
PRETUNE_SCHEDULE = (0.05, 1.0, 20)  # linspace(0.05, 1, 20)
PRETUNE_SIGMA, PRETUNE_ALPHA = 0.05, 1.0
NS_DELETE, NS_INNER, NS_MAX_STEPS, NS_STOP, NS_SAMPLES = 2048, 20, 400, -3.0, 16384
# nsswig: 1 inner step (cut from 20 to fit the phase's time), a sweep of all
# 10 coordinates, so a step moves each particle by 10 univariate slices where
# nss's moves it by 20 hit-and-run slices; the same stop rule
SWIG_INNER = 1
NS_BUSY_STEPS = 4  # the nested samplers' busy share: a run of 4 steps under the profiler
# The JAX package's own runs of these configurations on a CPU, f32
# (tools/particle_reference.py; keys 18-22, the nested samplers 18-20): each
# sampler's worst |log Z - SMC_LOG_Z| and worst largest |mean - 0.9 obs|; the
# gates are about three times those (log Z, means), the variances in SMC_VAR_BAND
# (python tools/particle_reference.py; adaptive_persistent_sampling_smc 5 steps on
# every key, pretuning 20, nss and nsswig 100-101)
PARTICLE_REFERENCE = {
    "adaptive_persistent_sampling_smc": {"worst_log_z_err": 0.1158, "worst_mean_err": 0.0367},
    "pretuning": {"worst_log_z_err": 0.0345, "worst_mean_err": 0.0147,
                  "step_size_mean": 0.5924},
    "nss": {"worst_log_z_err": 0.0308, "worst_mean_err": 0.0230},
    "nsswig": {"worst_log_z_err": 0.0295, "worst_mean_err": 0.0231},
}
PARTICLE_GATES = {  # (log Z, means)
    "adaptive_persistent_sampling_smc": (0.35, 0.11), "pretuning": (0.1, 0.045),
    "nss": (0.1, 0.07), "nsswig": (0.09, 0.07),
}
# the f64 holds, the card against the CPU: 1,024 particles or live points (the
# nested samplers deleting 128 a step, the configuration's 1/8), 3 steps each
P19_CMP_N, P19_CMP_STEPS, NS_CMP_DELETE = 1024, 3, 128
TF_PATH_KEYS = (1024, 2048, 16384, 163840)  # phase 19's threefry launch sizes, timed
PRNG_KERNELS = ("threefry2x32", "normal")  # the kernels under prng's draws
# phase 20: the tracked cross-chain ChEES configuration (benchmarks/tracked.py:
# 744-788, config_cross_chain): ill_conditioned_gaussian(100), 4,096 chains
# from normal(key(19), (4096, 100)), step size 0.05, adam(0.25), 1,000 steps and
# the defaults, f32; timed on split(key(19), 4)[0] after a warm run of 20 steps
CHEES_CHAINS, CHEES_D, CHEES_STEPS, CHEES_WARM_STEPS = 4096, 100, 1000, 20
CHEES_STEP_SIZE, CHEES_LR, CHEES_SEED = 0.05, 0.25, 19
# the final step size and integration-steps parameter: (the JAX package's
# mean over the four keys of split(key(19), 4), half width three times their
# spread or 5 % of the mean), python tools/chees_reference.py (f32, CPU)
CHEES_REFERENCE = {
    "step_size": (0.29964111000299454, 0.014982055500149728),
    "integration_steps_params": (19.12667179107666, 0.9563335895538331),
}
CHEES_VAR_BAND, CHEES_MEAN_SD = (0.85, 1.15), 0.1  # the final ensemble against the target
# the diagonal metric with the length floor, cut from 1,000 steps to 200; its
# adapted inverse mass matrix against the target's variances
CHEES_DIAG_STEPS, CHEES_IMM_BAND = 200, (0.8, 1.25)
CHEES_BUSY_STEPS = 8  # the busy share: a run of 8 steps under the profiler
# the f64 hold, the card against the CPU: 256 chains x 33 steps at d = 100, key
# 20; the window opens at step 16, so the length floor's in-loop eigen refresh
# (every 32 steps once the metric is engaged) runs at step 32
CHEES_CMP_CHAINS, CHEES_CMP_STEPS, CHEES_CMP_TOL = 256, 33, 1e-9
# phase 21: the tracked MEADS configuration (benchmarks/tracked.py:859-893,
# config_meads): ill_conditioned_gaussian(100), 4,096 chains from
# normal(key(29), (4096, 100)), meads_adaptation's defaults (4 folds, step-size
# multiplier 0.5, damping slowdown 1.0), 1,000 steps, f32, on the three keys of
# split(key(29), 3), after a warm run of 20 steps
MEADS_CHAINS, MEADS_D, MEADS_STEPS, MEADS_WARM_STEPS, MEADS_SEED = 4096, 100, 1000, 20, 29
MEADS_KEYS = 3
# key 0 is timed at 1,000 steps; keys 1 and 2 run 200 steps (cut from 1,000:
# at about 9 host ms a step three full runs take 28 s, over the phase's 25 s),
# gated against the same bands (the JAX package's runs sit inside them from
# step 50)
MEADS_CHEAP_STEPS = 200
# the final step size, alpha and delta, and the smallest and largest ratio of
# the final positions' variances to the target's and of the momentum scale to
# its standard deviations: (the JAX package's mean over the three keys, half
# width three times their spread or 5 % of the mean), python
# tools/meads_reference.py (f32, CPU)
MEADS_REFERENCE = {
    "step_size": (0.498953640460968, 0.024947682023048402),
    "alpha": (0.631592313448588, 0.0315796156724294),
    "delta": (0.315796156724294, 0.0157898078362147),
    "var_ratio_min": (0.9357340024627793, 0.046786700123138965),
    "var_ratio_max": (1.0633546466200396, 0.053167732331001985),
    "scale_ratio_min": (0.9727721724706361, 0.04863860862353181),
    "scale_ratio_max": (1.0266930299883488, 0.05133465149941744),
}
MEADS_BUSY_STEPS = 8  # the busy share: a run of 8 steps under the profiler
# the LRD run at full width: 4,096 chains x 200 steps (cut from 1,000), rank 8,
# the window over the second half
MEADS_LRD_STEPS, MEADS_LRD_RANK = 200, 8
# the f64 hold, the card against the CPU: the configuration's CPU size (256
# chains x 40 steps at d = 100: ten reshuffles, every fold frozen), key 21, the
# defaults and LRD at k = 8 with the window over the second half
MEADS_CMP_CHAINS, MEADS_CMP_STEPS, MEADS_CMP_TOL = 256, 40, 1e-9
# phase 22: Pathfinder on config #5's target and start (benchmarks/tracked.py:
# 744-788; no published configuration runs Pathfinder): pathfinder_adaptation(
# hmc, ill_conditioned_gaussian(100).logdensity_fn, num_chains=4096,
# num_integration_steps=20), n_paths at its default (4,096 paths of 200 draws,
# 819,200 pooled draws), from row 0 of normal(key(19), (4096, 100)), 400 steps
# (the default num_steps), f32, on the three keys of split(key(23), 3), after a
# warm run of 20 steps; the per-step info cut to the acceptance rates and step
# sizes
PF_CHAINS, PF_D, PF_STEPS, PF_WARM_STEPS = 4096, 100, 400, 20
PF_START_SEED, PF_KEY_SEED, PF_KEYS, PF_INTEGRATION_STEPS = 19, 23, 3, 20
# keys 1 and 2 run 100 steps (cut from 400: at about 39 host ms a
# dual-averaging step three full keys took 71.5 s of the phase's first probe)
PF_CHEAP_STEPS = 100
# the smallest and largest ratio of the inverse mass matrix's diagonal to the
# target's variances, its off-diagonal mass ||M - diag M||_F / ||M||_F, the
# median, smallest and largest per-chain step size, and the smallest and
# largest ratio of the final positions' variances to the target's: (centre,
# half width), python tools/pathfinder_reference.py (the JAX package, f32, the
# three keys at 1,024 chains: three times their spread, 5 % of the mean or the
# drift from 256 chains, whichever is widest; the final variances' band scaled
# to 4,096 chains about 1, as their sampling noise shrinks), at 400 steps
PATHFINDER_REFERENCE = {
    "imm_ratio_min": (0.13286808561571942, 0.1072758724199639),
    "imm_ratio_max": (4.124553199887284, 1.522184830098071),
    "offdiag_mass": (0.21047099240725586, 0.1140958370148927),
    "step_size_median": (0.3737703611453374, 0.023461103439331055),
    "step_size_min": (0.34061841169993085, 0.0217779278755188),
    "step_size_max": (0.4148048162460327, 0.055290430784225464),
    "var_ratio_min": (0.9426397776504054, 0.02213198888252027),
    "var_ratio_max": (1.0533099887754558, 0.054119960353213314)
}
# the same at 100 steps (--steps 100), for keys 1 and 2
PATHFINDER_REFERENCE_CHEAP = {
    "imm_ratio_min": (0.13286808561571942, 0.1072758724199639),
    "imm_ratio_max": (4.124553199887284, 1.522184830098071),
    "offdiag_mass": (0.21047099240725586, 0.1140958370148927),
    "step_size_median": (0.33208036919434863, 0.020388633012771606),
    "step_size_min": (0.2789186139901479, 0.01904439926147461),
    "step_size_max": (0.395286629597346, 0.05311301350593567),
    "var_ratio_min": (0.9532372141046406, 0.060333312712965825),
    "var_ratio_max": (1.0599682253540208, 0.04508390856889943)
}
# the host syncs are counted on the warm run, in CUDA's sync debug mode; the
# busy share is of 8 of its dual-averaging steps, rerun under the profiler
PF_BUSY_STEPS = 8
PF_DRAWS = 4096  # single-path Pathfinder's and multipathfinder's draws
PF_LOW_RANK_TOL = 1e-4  # the low-rank payload's operator against formula 1, f32
# the f64 hold, the card against the CPU: 16 chains (and paths) x 40 steps at
# d = 100, key 24: the Pathfinder stage whole (every iterate and ELBO of every
# path), the free run's first 3 steps, then every step from the CPU's state
PF_CMP_CHAINS, PF_CMP_STEPS, PF_CMP_FREE, PF_CMP_TOL = 16, 40, 3, 1e-9
# phase 23: the rest of vi/ on config #5's target (benchmarks/tracked.py:744-788;
# no published configuration runs these families): ill_conditioned_gaussian(100),
# f32, after a warm run of each. meanfield_vi with adam(0.05) and fullrank_vi with
# adam(0.02) from zeros, num_samples=100 (the top-level default), 500 steps (the
# JAX package's ELBO has settled by then), step i on fold_in(key, i), on the
# three keys of split(key(24), 3); svgd with sgd(0.02 n) under the median
# heuristic on config #5's start normal(key(19), (4096, 100)), its statistics at
# 200 and 500 steps (SVGD takes no key: one run; its median heuristic sorts
# 8,386,560 explicit distances a step, about 6.5 ms on the card, so 500 steps,
# not 1,000); schrodinger_follmer with n_steps=100 and n_inner_samples=200
# (tests/vi/test_vi.py's settings) over 4,096 bridges on the same three keys
VI_D, VI_SEED, VI_KEYS, VI_NUM_SAMPLES = 100, 24, 3, 100
VI_GAUSSIAN = {"meanfield_vi": (0.05, 500), "fullrank_vi": (0.02, 500)}  # adam's rate, steps
# keys 1 and 2 run 250 steps (cut from 500), gated against the JAX package's
# 250-step bands (the "_cut" entries)
VI_GAUSSIAN_CUT_STEPS = 250
SVGD_PARTICLES, SVGD_RATE, SVGD_STEPS, SVGD_CUT_STEPS = 4096, 0.02, 500, 200  # rate over n
SF_BRIDGES, SF_STEPS, SF_INNER = 4096, 100, 200
# the sync count: a warm run of 5 steps (3 for the bridges' 100-step sample, cut),
# in CUDA's sync debug mode; the busy share: 8 steps rerun under the profiler
VI_SYNC_STEPS, VI_BUSY_STEPS = 5, 8
# each run's statistics: (centre, half width), python tools/vi_reference.py (the
# JAX package, f32, three keys; SVGD and the bridges at 1,024 particles, three
# 1,024-row blocks of the start for SVGD: three times their spread, 5 % of the
# mean, the drift from 256 particles or, about 0, 0.01, whichever is widest;
# SVGD's centred at 4,096 particles by the drift, linear in log n)
VI_REFERENCE = {
    "meanfield_vi": {
        "sd_ratio_min": (0.99999984513406, 0.049999992256703006),
        "sd_ratio_max": (1.000000093396954, 0.0500000046698477),
        "mean_abs_sd": (4.3095029048926644e-08, 0.01),
        "elbo": (-91.89382934570312, 4.594691467285156),
    },
    "meanfield_vi_cut": {
        "sd_ratio_min": (0.9999798528093226, 0.04999899264046613),
        "sd_ratio_max": (1.000011563966005, 0.050000578198300255),
        "mean_abs_sd": (2.4479379095321185e-05, 0.01),
        "elbo": (-91.8938471476237, 4.594692357381185),
    },
    "fullrank_vi": {
        "sd_ratio_min": (0.9999989807040084, 0.04999994903520042),
        "sd_ratio_max": (1.0000005654593136, 0.05000002827296568),
        "mean_abs_sd": (4.1983846268093165e-07, 0.01),
        "elbo": (-91.89382934570312, 4.594691467285156),
        "offdiag_mass": (1.205739113793399e-07, 0.01),
    },
    "fullrank_vi_cut": {
        "sd_ratio_min": (0.9999760857065718, 0.049998804285328595),
        "sd_ratio_max": (1.0047363814543295, 0.05023681907271648),
        "mean_abs_sd": (0.0010085800076943307, 0.01),
        "elbo": (-91.89406840006511, 4.594703420003255),
        "offdiag_mass": (2.34897999997295e-05, 0.01),
    },
    "svgd": {
        "var_ratio_min": (0.0, 0.01),
        "var_ratio_max": (0.4339431176094523, 0.0715164566706516),
        "mean_abs_sd": (0.0008054826060594315, 0.01),
    },
    "svgd_cut": {
        "var_ratio_min": (1.444723137743163e-34, 0.01),
        "var_ratio_max": (0.29516160915131057, 0.0490462650873528),
        "mean_abs_sd": (0.004305114569851381, 0.010330023436910848),
    },
    "schrodinger_follmer": {
        "var_ratio_min": (0.1496620421263444, 0.03707595632045632),
        "var_ratio_max": (1.7880963913023116, 0.2188185345294078),
        "mean_abs_sd": (0.09018508409423943, 0.13063121336204464),
    },
}
# the f64 hold, the card against the CPU from the same key (key(25)): 20 steps
# of each Gaussian family; SVGD at 256 particles (the start's first
# rows) x 20 steps; 64 bridges x 20 steps of 32 (cut from 200: the CPU's float64
# normals take about a microsecond each) inner draws
VI_CMP_STEPS, VI_CMP_TOL, VI_CMP_SEED = 20, 1e-9, 25
SVGD_CMP_PARTICLES, SF_CMP_BRIDGES, SF_CMP_INNER = 256, 64, 32
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
# so each is cut from the configuration's 131,072 to a second or a few of
# work: hmc to 128 (3 s); GIST's searches and rollouts run to the slowest
# chain (0.2 and 0.9 s a transition), so 8 and 4; coordinate_slice sweeps 100
# univariate slices a transition, each a few host-paced loops (9 s), so 1.
# dhmc keeps its 128: its band is the JAX package's 0.9846 at 128.
FAM_TRANSITIONS = {
    "hmc": 128, "mhmc": 32, "dhmc": 128, "ghmc": 128, "barker": 128,
    "normal_random_walk": 256, "irmh": 256, "adjusted_mclmc": 32,
    "adjusted_mclmc_dynamic": 32, "elliptical_slice": 32, "slice_sampling": 8,
    "coordinate_slice": 1, "orbital_hmc": 16, "mgrad_gaussian": 128,
    "gist_step_size": 8, "gist_trajectory_length": 4,
}
FAM_IRMH_SCALE, FAM_PERIOD = 1.05, 8  # irmh's proposal N(0, 1.1025 diag(var)); orbital_hmc's
# orbital_hmc runs in f64: its weights exp(logdensity - K) at d = 100 underflow
# f32 (to 0 / 0 once a whole orbit does), in the reference as in the port
FAM_F64 = ("orbital_hmc",)
FAM_MGRAD_DELTA, FAM_MCLMC_STEP, FAM_MCLMC_STEPS = 1.0, 1.0, 5
FAM_BUSY_TRANSITIONS = 8  # the transitions of the busy-share run, but for the slowest:
FAM_BUSY_SHORT = {"gist_trajectory_length": 2}
# coordinate_slice's one transition takes 8-17 s, so its busy share is read
# from the timed transition itself, under the profiler, not from a second run
FAM_BUSY_ON_TIMED = ("coordinate_slice",)
# Bands of the mean acceptance (elliptical slice: mean subiter; the slice
# samplers: mean num_shrink), from the JAX package's own run of each sampler on
# the CPU at the same settings, keys and transitions
# (tools/mcmc_family_reference.py): its mean, +- FAM_BAND_WIDTH (relative for
# the counts)
FAM_REFERENCE = {
    "hmc": 0.982488, "mhmc": 0.984549, "dhmc": 0.984613, "ghmc": 0.995063,
    "barker": 0.839059, "normal_random_walk": 0.559713, "irmh": 0.599140,
    "adjusted_mclmc": 0.999612, "adjusted_mclmc_dynamic": 0.999620,
    "elliptical_slice": 6.656250, "slice_sampling": 2.897461,
    "coordinate_slice": 285.523438, "mgrad_gaussian": 0.345868, "gist_step_size": 0.724351,
    "gist_trajectory_length": 0.148431,
}
FAM_REFERENCE["fused_hmc"] = FAM_REFERENCE["hmc"]  # the same HMC, its own draws
FAM_BAND_WIDTH, FAM_COUNT_BAND = 0.03, 0.15
FAM_COUNTED = ("elliptical_slice", "slice_sampling", "coordinate_slice")
FAM_CMP_CHAINS, FAM_CMP_D, FAM_CMP_TRANSITIONS, FAM_CMP_TOL = 16, 5, 20, 1e-12
# The f64 hold's transitions for the two slowest samplers, which take two
# thirds of the hold's host time at 20: 5, so that their carried keys and
# counts still pass from one transition to the next four times
FAM_CMP_SHORT = {"coordinate_slice": 5, "gist_trajectory_length": 5}
# phase 18: the tracked SG-MCMC configurations (benchmarks/tracked.py:486-563,
# config_sgld, and :790-856, config_sgld_chains) at their chip sizes: SGLD on
# logistic_regression(num_points=4096, dim=54) of jax.random.key(0) (rebuilt on the
# card from the same key words), step size 1e-5, f32; the steps cut
SG_N, SG_D, SG_STEP_SIZE = 4096, 54, 1e-5
# Steps cut from the configurations' 20,000 to 2,500 for the script's time
# limit: the path is host-bound, 3.5-4.7 host ms a step
# on the slowest host seen (NVIDIA H100 80GB HBM3, 700.00 W: 165 s for both at
# 20,000); the rates are per step, so the cut leaves them as they are
SG_STEPS, SG_BATCH = 2500, 512  # config_sgld: one chain (tracked.py:496)
SG_CHAINS, SG_CHAINS_STEPS, SG_CHAINS_BATCH = 4096, 2500, 256  # config_sgld_chains (:797-798)
# The JAX package's own run of both on the CPU at the same keys and steps, each
# configuration's first variant (tools/sgmcmc_reference.py --steps 2500, f32): config_sgld's
# final position and each coordinate's sd over the second half of its path;
# config_sgld_chains' mean of the final positions over the chains and their sd
SG_REFERENCE = {
    "final": np.array([
        -1.348754, -1.210663, 0.193174, -0.1148259, -0.3326218, -0.7986589, -0.5603418,
        0.2369299, -0.7970953, 1.272055, -0.1804155, 0.5750017, -0.9241427, -0.414382,
        -0.2594881, 0.2779017, -0.5871443, -0.05280408, -0.4450062, -1.041753, -0.6548429,
        -0.1672624, 0.717369, 0.507221, -0.6398844, -0.3041559, 0.4842886, 1.068429,
        -0.3364348, -0.03858395, -0.3238212, -1.19746, -0.1765748, 0.5145469, -0.7288695,
        -0.4502739, -1.33546, -0.9252672, -0.2017347, -0.9446333, -1.270321, -0.9170223,
        -0.1140079, -0.3796523, 0.2653918, -0.4763966, 0.8959071, 0.2963807, -0.1152162,
        0.5730949, 0.3986357, -0.6002307, 0.3138802, -0.7532742,
    ]),
    "second_half_sd": np.array([
        0.09163939, 0.09192088, 0.04118009, 0.02596398, 0.05253625, 0.05093194, 0.03483851,
        0.02819128, 0.07445553, 0.08453886, 0.0730449, 0.05453248, 0.05851975, 0.04440681,
        0.04174002, 0.05984278, 0.07447068, 0.03160733, 0.03495173, 0.05506947, 0.03843383,
        0.04638955, 0.05559858, 0.06980368, 0.05153384, 0.04362027, 0.02748093, 0.09284537,
        0.04673624, 0.03268397, 0.02732387, 0.06759942, 0.03797298, 0.02451508, 0.05258001,
        0.04850705, 0.08247773, 0.06899917, 0.07813957, 0.05245828, 0.1024149, 0.05423744,
        0.03348743, 0.04268625, 0.04483991, 0.03430581, 0.04524148, 0.03360541, 0.02587919,
        0.05964445, 0.04512003, 0.05578918, 0.03901876, 0.04022311,
    ]),
    "mean": np.array([
        -1.397192, -1.18241, 0.1574046, -0.1652026, -0.3946783, -0.7403936, -0.623666,
        0.1997968, -0.7153115, 1.277761, -0.1205506, 0.5334706, -0.7671768, -0.4318465,
        -0.1525162, 0.2342079, -0.6648453, -0.07808214, -0.4928384, -1.048598, -0.6104817,
        -0.1969902, 0.7003841, 0.4929084, -0.626716, -0.311064, 0.4653035, 1.066245,
        -0.2749989, 0.01615869, -0.3854758, -1.13024, -0.1793078, 0.597003, -0.7602406,
        -0.4358149, -1.42812, -0.9455445, -0.2673121, -0.991798, -1.211579, -0.9381046,
        -0.1784226, -0.3745916, 0.2927605, -0.597661, 1.011473, 0.3634001, -0.1277749,
        0.5018995, 0.4084376, -0.5530244, 0.3514769, -0.7579892,
    ]),
    "sd": np.array([
        0.06737898, 0.06498543, 0.05869558, 0.05704436, 0.05976256, 0.06129592, 0.05918556,
        0.0577869, 0.06101636, 0.06452508, 0.05624394, 0.05926043, 0.05973601, 0.05988242,
        0.05887704, 0.05887382, 0.05914433, 0.05710816, 0.0575347, 0.06424752, 0.06105425,
        0.05683161, 0.06010024, 0.06006492, 0.06151789, 0.0596681, 0.05937316, 0.06445526,
        0.05988169, 0.06281646, 0.05921819, 0.06450171, 0.05821054, 0.06112157, 0.06105561,
        0.06063011, 0.06688767, 0.0615692, 0.05652867, 0.06229772, 0.06390687, 0.0624359,
        0.05767173, 0.0577707, 0.05978322, 0.05961166, 0.06427278, 0.06005005, 0.05855239,
        0.0601669, 0.06016434, 0.05603443, 0.06036293, 0.06059438,
    ]),
}
# Bands: config_sgld's final position within 0.05 of the second half's sd of the
# reference's, every coordinate; config_sgld_chains' mean over the chains within
# 0.25 standard errors (sd / sqrt(4,096)) of the reference's. The same keys
# drive the same noise and minibatches, so the port's paths follow the
# reference's up to rounding (and, while the port's f32 normals took torch's
# erfinv, the dataset's last bits): then on a CPU the port came within 7.4e-6
# sd (20,000 steps) and 0.0023 standard errors (4,096 chains x 2,000 steps),
# on an NVIDIA H100 80GB HBM3 at 700.00 W under 5e-5 sd and within 0.0016
# standard errors (20,000 steps). Other minibatches (int64 indices, which draw
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


def _ms_words(ms, unit="ms"):
    """``ms`` in ``unit`` for a line, or "not measured" where the trace held
    no record (``_device_ms`` returned None)."""
    if ms is None:
        return "not measured (no device record)"
    return f"{ms * 1e3:.2f} us" if unit == "us" else f"{ms:.4f} ms"


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
# The bytes a threefry2x32 with a key per element must move: a key and a
# counter in (four 32-bit words), two words out. The export carries each
# word as int64 (PyTorch's integer type), so it moves twice that; the bound
# counts what the function needs.
THREEFRY_BYTES = 6 * 4
# MCLMC_STEP_OPS leaves out Box-Muller's logf, sqrtf and cosf. Recounted
# from the SASS of the registers form's refresh draws (dc_kernel_ms.py
# --machine mclmc --sass, PR 13: 661 integer, 368 FP32, 8 MUFU and 40
# conversion warp-instructions for a step's 8 blocks a lane at d = 100), a
# normal is 46 FP32 operations, 6 on the special-function pipe (MUFU and
# conversions) and 12.6 integer ones beside its block's THREEFRY_OPS.
BOX_MULLER_OPS = {"fp32": 46.0, "sfu": 6.0, "int32": 82.625 - THREEFRY_OPS}
# The normal kernel (prng.normal's transform of the threefry words), per
# float32 element, counted from its source: the uniform (4), -x*x (1), log1p's
# rational branch (two 6-term Horner chains, 12 fused multiply-adds, and 5
# more), its log branch (logf: 21, and 3 checks), the select, the erf_inv
# polynomial of one branch (9), the rest (5); the division and the square
# root, correctly rounded, 4 FP32 operations and a special-function one each;
# 8 integer operations (the words into the mantissa, logf's exponent split).
# It must move two 32-bit words in (the export carries them as int64) and one
# float32 out.
NORMAL_OPS = {"fp32": 70.0, "sfu": 2.0, "int32": 8.0}
NORMAL_BYTES = 3 * 4


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


def smc_target(torch, device, dtype, d=SMC_D):
    """The tracked SMC target's log prior, N(0, 9 I), and log likelihood,
    N(obs, I), obs = linspace(-1, 1, d): each maps ``(..., d)`` points to
    ``(...)``."""
    obs = torch.from_numpy(np.linspace(-1.0, 1.0, d)).to(device=device, dtype=dtype)

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


def ps_run(torch, x0, key, adaptive=True, schedule=None, n_schedule=PS_N_SCHEDULE,
           mcmc_steps=SMC_MCMC_STEPS, max_steps=PS_N_SCHEDULE):
    """Persistent-sampling SMC with MALA moves (step size SMC_STEP_SIZE,
    systematic resampling) on the tracked SMC target from particles ``x0``:
    ``adaptive_persistent_sampling_smc`` to lambda = 1 at SMC_TARGET_ESS, or
    ``persistent_sampling_smc`` along ``schedule``; the host loop splits
    ``key`` into the next key and the step's key, as ``smc_run``. Each
    step's ``(state, info)``."""
    import blackjax_tpu_torch as bj
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.mcmc import mala
    from blackjax_tpu_torch.smc import resampling

    logprior_fn, loglikelihood_fn = smc_target(torch, x0.device, x0.dtype, x0.shape[1])
    params = {"step_size": torch.full((1,), SMC_STEP_SIZE, dtype=x0.dtype, device=x0.device)}
    common = (logprior_fn, loglikelihood_fn, n_schedule, mala.build_kernel(), mala.init,
              params, resampling.systematic)
    if adaptive:
        algo = bj.adaptive_persistent_sampling_smc(
            *common, target_ess=SMC_TARGET_ESS, num_mcmc_steps=mcmc_steps)
    else:
        algo = bj.persistent_sampling_smc(*common, num_mcmc_steps=mcmc_steps)
    state, steps = algo.init(x0), []
    for i in range(max_steps if adaptive else len(schedule)):
        if adaptive and float(state.tempering_param) >= 1.0:
            break
        key, step_key = prng.split(key)
        state, info = (algo.step(step_key, state) if adaptive
                       else algo.step(step_key, state, schedule[i]))
        steps.append((state, info))
    return steps


def pretune_run(torch, x0, key, schedule, mcmc_steps=SMC_MCMC_STEPS):
    """``pretuning`` over ``tempered_smc`` on the tracked SMC target with
    MALA moves whose step size is a per-particle parameter (initially
    SMC_STEP_SIZE), along ``schedule`` (0-d tensors): the ESJD in the
    identity metric (MALA has no mass matrix for the default measure),
    ``sigma_parameters={"step_size": PRETUNE_SIGMA}``, ``alpha=PRETUNE_ALPHA``
    and the step size kept positive, as the reference's own end-to-end test
    (``tests/smc/test_persistent_pretuning.py:192-230``). Each step's
    ``(state, info)``."""
    import blackjax_tpu_torch as bj
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.mcmc import mala
    from blackjax_tpu_torch.smc import resampling
    from blackjax_tpu_torch.smc.pretuning import build_pretune, esjd

    n, d = x0.shape
    logprior_fn, loglikelihood_fn = smc_target(torch, x0.device, x0.dtype, d)
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    pretune = build_pretune(
        mala.init, mala.build_kernel(), alpha=PRETUNE_ALPHA,
        sigma_parameters={"step_size": torch.tensor(PRETUNE_SIGMA, dtype=x0.dtype,
                                                    device=x0.device)},
        n_particles=n, performance_of_chain_measure_factory=lambda state: esjd(eye),
        positive_parameters=["step_size"])
    algo = bj.pretuning(
        bj.tempered_smc, logprior_fn, loglikelihood_fn, mala.build_kernel(), mala.init,
        resampling.systematic, num_mcmc_steps=mcmc_steps,
        initial_parameter_value={"step_size": torch.full((n,), SMC_STEP_SIZE, dtype=x0.dtype,
                                                         device=x0.device)},
        pretune_fn=pretune)
    state, steps = algo.init(x0), []
    for lam in schedule:
        key, step_key = prng.split(key)
        state, info = algo.step(step_key, state, tempering_param=lam)
        steps.append((state, info))
    return steps


def ns_run(torch, x0, key, variant="nss", num_delete=NS_DELETE, num_inner_steps=NS_INNER,
           max_steps=NS_MAX_STEPS, stop=NS_STOP):
    """Nested slice sampling (the registry's ``nss`` or ``nsswig``) on the
    tracked SMC target from the live points ``x0`` until ``logZ_live - logZ
    < stop`` (read to the host once a step) or ``max_steps`` steps (``stop``
    None: all of them), the loop splitting ``key`` as ``smc_run``. Returns
    the final state and each step's ``(state, info)``."""
    import blackjax_tpu_torch as bj
    from blackjax_tpu_torch import prng

    logprior_fn, loglikelihood_fn = smc_target(torch, x0.device, x0.dtype, x0.shape[1])
    build = bj.nss if variant == "nss" else bj.nsswig
    algo = build(logprior_fn, loglikelihood_fn, num_inner_steps=num_inner_steps,
                 num_delete=num_delete)
    state, steps = algo.init(x0), []
    while len(steps) < max_steps:
        integ = state.integrator
        if stop is not None and float(integ.logZ_live - integ.logZ) < stop:
            break
        key, step_key = prng.split(key)
        state, info = algo.step(step_key, state)
        steps.append((state, info))
    return state, steps


def ns_summary(torch, state, steps, key, samples=NS_SAMPLES):
    """log Z (the dead points' evidence with the live points' remainder),
    the mean and variance of ``samples`` posterior draws of
    ``ns.utils.sample`` on ``key``, and the Kish ESS, on the host."""
    from blackjax_tpu_torch.ns import utils as ns_utils

    dead = ns_utils.finalise(state, [info for _, info in steps], update_info=False)
    draws = ns_utils.sample(key, dead, samples).position.double()
    integ = state.integrator
    return {"log_z": float(torch.logaddexp(integ.logZ, integ.logZ_live)),
            "mean": draws.mean(0).cpu().numpy(), "var": draws.var(0, correction=0).cpu().numpy(),
            "ess": float(ns_utils.ess(key, dead))}


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
    return {name: launches16[name] for name in PRNG_KERNELS}


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
    path17 = dict.fromkeys(PRNG_KERNELS, 0)  # the runs' launches, not the busy runs'
    for name, (algo, keyed_init) in algorithms.items():
        n = FAM_TRANSITIONS[name]
        start = x0.double() if name in FAM_F64 else x0
        state0 = algo.init(start, init_keys) if keyed_init else algo.init(start)
        before = {k: dc.LAUNCHES[k] for k in PRNG_KERNELS}

        def timed_run():
            stats, state, info = [], state0, None
            for i in range(n):
                state, info = algo.step(keys_of(i), state)
                stat, _ = family_statistic(name, info)
                if stat is not None:
                    stats.append(stat)
            return stats, state, info

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name in FAM_BUSY_ON_TIMED:
            out = {}
            busy = _device_busy(torch, lambda: out.setdefault("run", timed_run()))
            stats, state, info = out["run"]
        else:
            stats, state, info = timed_run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if name in FAM_BUSY_ON_TIMED and busy is not None:
            secs = busy[2] / 1e3  # the run's own, not the reading of the profiler's records
        for k in PRNG_KERNELS:
            path17[k] += dc.LAUNCHES[k] - before[k]
        launches = dc.LAUNCHES["threefry2x32"] - before["threefry2x32"]
        card, finite = _on_card(torch, tuple(state) + tuple(info))
        _require(card, f"phase 17 {name}: a state or info tensor is not on the card")
        _require(finite, f"phase 17 {name}: non-finite values")
        _require(launches > 0, f"phase 17 {name}: no threefry launch")
        mean_stat = float(torch.stack(stats).double().mean()) if stats else None
        if name in FAM_BUSY_ON_TIMED:
            busy_n = n
        else:
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
              f"{'f64' if name in FAM_F64 else 'f32'}, {n} transitions in {secs:.3f} s"
              f"{' (under the profiler)' if name in FAM_BUSY_ON_TIMED else ''}: "
              f"{FAM_CHAINS * n / secs:.1f} transitions/sec (chains x transitions), "
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
            for i in range(FAM_CMP_SHORT.get(name, FAM_CMP_TRANSITIONS)):
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
          f"{FAM_CMP_D} for {FAM_CMP_TRANSITIONS} transitions on the same keys ("
          f"{', '.join(f'{n} {k}' for n, k in FAM_CMP_SHORT.items())}), the card against "
          f"the port on the CPU: accept flags, drawn step counts, subiter and the slice counts "
          f"identical, largest position difference {worst:.3g} (tolerance {FAM_CMP_TOL}); "
          f"threefry launches on the path {path17['threefry2x32']}, normal launches "
          f"{path17['normal']}, "
          f"transition kernel launches {transition_launches} ({smi})")
    return path17, transition_launches


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


def sgld_single(torch, bj, prng, X, y, num_steps, batch):
    """``config_sgld``'s run on ``(X, y)``'s device (tracked.py:509-530,
    its first variant): the minibatch indices ``randint(split(key(13),
    num_steps)[i], (batch,), 0, 4096)``, the step keys ``split(key(14),
    num_steps)``, the start ``0.01 N(0, I)`` of ``split(key(15), 4)[0]``.
    Returns the final position and the indices ``(num_steps, batch)``."""
    dev, (data_size, d) = X.device, X.shape
    step = _sgmcmc_algorithm(bj, torch, "sgld", data_size).step
    batch_idx = prng.randint(prng.split(prng.key(13, dev), num_steps), (batch,), 0, data_size,
                             prng.default_int_dtype(X.dtype))
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
    batch_idx = prng.randint(idx_keys, (batch,), 0, data_size, prng.default_int_dtype(X.dtype))
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
    lines, path18 = [], dict.fromkeys(PRNG_KERNELS, 0)
    for label, steps, chains in (("config_sgld", SG_STEPS, 1),
                                 ("config_sgld_chains", SG_CHAINS_STEPS, SG_CHAINS)):
        before = {k: dc.LAUNCHES[k] for k in PRNG_KERNELS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if chains == 1:
            w, idx = sgld_single(torch, bj, prng, X, y, steps, SG_BATCH)
        else:
            w, idx, _ = sgmcmc_chains(torch, bj, prng, X, y, "sgld", chains, steps,
                                      SG_CHAINS_BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for k in PRNG_KERNELS:
            path18[k] += dc.LAUNCHES[k] - before[k]
        launches = dc.LAUNCHES["threefry2x32"] - before["threefry2x32"]
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
          + f" (tolerance {SG_CMP_TOL}); threefry launches on the two runs "
          f"{path18['threefry2x32']}, normal launches {path18['normal']} ({smi})")
    return path18


def _ps_summary(steps):
    """A persistent-sampling run's lambdas, log Z (the persistent estimate at
    its last iteration) and the moments of its last slot's particles."""
    state = steps[-1][0]
    x = state.particles.double()
    return {"lambdas": [float(st.tempering_param) for st, _ in steps],
            "log_z": float(state.log_Z), "mean": x.mean(0).cpu().numpy(),
            "var": x.var(0, correction=0).cpu().numpy(),
            "accept": [float(info.update_info.acceptance_rate.double().mean())
                       for _, info in steps]}


def _pretune_summary(torch, steps):
    """A pretuning run's log Z (the sum of the increments), its weighted
    moments and the step-size population's mean and range at the end."""
    smc_state = steps[-1][0].sampler_state
    s = smc_summary(torch, smc_state, [(st.sampler_state, info) for st, info in steps])
    sizes = steps[-1][0].parameter_override["step_size"].double()
    s.update(step_size=(float(sizes.mean()), float(sizes.min()), float(sizes.max())))
    return s


def _particle_gates(torch, name, s, tensors):
    """Phase 19's gates on one run's summary ``s``: every tensor on the card
    and finite, log Z and the means within PARTICLE_GATES of the exact
    values, the variances in SMC_VAR_BAND. Returns the mean and variance
    errors."""
    card, finite = _on_card(torch, tensors)
    _require(card, f"phase 19 {name}: a state or info tensor is not on the card")
    _require(finite, f"phase 19 {name}: non-finite values")
    log_z_tol, mean_tol = PARTICLE_GATES[name]
    _require(abs(s["log_z"] - SMC_LOG_Z) <= log_z_tol,
             f"phase 19 {name}: log Z {s['log_z']} against {SMC_LOG_Z} (tolerance {log_z_tol})")
    mean_err = float(np.abs(s["mean"] - 0.9 * SMC_OBS).max())
    _require(mean_err <= mean_tol, f"phase 19 {name}: a mean {mean_err} from 0.9 obs")
    _require(bool(((s["var"] >= SMC_VAR_BAND[0]) & (s["var"] <= SMC_VAR_BAND[1])).all()),
             f"phase 19 {name}: variances {s['var']} outside {SMC_VAR_BAND}")
    return mean_err, float(np.abs(s["var"] - 0.9).max())


@contextlib.contextmanager
def recorded_choices():
    """While open, every index draw of ``prng.choice`` is also appended to
    the list it yields: in an NS step that is the start indices its inner
    update draws (the step's only ``choice``), read where the kernel draws
    them."""
    from blackjax_tpu_torch import prng

    drawn, own = [], prng.choice

    def choice(*args, **kwargs):
        out = own(*args, **kwargs)
        drawn.append(out)
        return out

    prng.choice = choice
    try:
        yield drawn
    finally:
        prng.choice = own


def particle_holds(torch, dev):
    """Phase 19's f64 holds: each sampler at P19_CMP_N particles or live
    points for P19_CMP_STEPS steps on the card and on the CPU, key 18 (see
    the head of this file). Returns a line's words for each."""
    from blackjax_tpu_torch import prng

    xc = smc_init(torch, P19_CMP_N, "cpu", torch.float64)
    words = []

    def diff(a, b):
        return float((a.cpu().double() - b.double()).abs().max())

    card = ps_run(torch, xc.to(dev), prng.key(18, dev), max_steps=P19_CMP_STEPS)
    cpu = ps_run(torch, xc, prng.key(18), max_steps=P19_CMP_STEPS)
    _require(len(card) == len(cpu) == P19_CMP_STEPS,
             f"phase 19 f64 persistent sampling: {len(card)} steps on the card, {len(cpu)} on the CPU")
    errs = [0.0, 0.0]
    for (a, a_info), (b, b_info) in zip(card, cpu):
        _require(torch.equal(a_info.ancestors.cpu(), b_info.ancestors),
                 "phase 19 f64 persistent sampling: ancestors differ between the card and the CPU")
        errs[0] = max(errs[0], diff(a.tempering_schedule, b.tempering_schedule),
                      diff(a.persistent_log_Z, b.persistent_log_Z))
        errs[1] = max(errs[1], diff(a.persistent_particles, b.persistent_particles))
    _require(errs[0] <= 1e-10 and errs[1] <= SMC_CMP_TOL,
             f"phase 19 f64 persistent sampling: lambda and log Z {errs[0]}, particles {errs[1]}")
    words.append(f"adaptive_persistent_sampling_smc: ancestors identical at every step, lambda "
                 f"and log Z within {errs[0]:.3g} (tolerance 1e-10), particles {errs[1]:.3g}")

    # pretuning's random walk draws float32 normals, also in an f64 run (as
    # the reference does): the card's draw is held to the CPU's bit for bit,
    # and the f64 hold gives each run its own draw
    from blackjax_tpu_torch.smc import pretuning

    probe = torch.linspace(0.01, 1.0, P19_CMP_N)
    noise_card = pretuning.generate_gaussian_noise(prng.key(5, dev), probe.to(dev),
                                                   sigma=PRETUNE_SIGMA).cpu()
    noise_cpu = pretuning.generate_gaussian_noise(prng.key(5), probe, sigma=PRETUNE_SIGMA)
    noise_differ = int((noise_card != noise_cpu).sum())
    _require(noise_differ == 0,
             f"phase 19 pretuning: {noise_differ} of the card's float32 noise draws differ "
             f"from the CPU's")

    schedule = np.linspace(*PRETUNE_SCHEDULE)[:P19_CMP_STEPS]
    card = pretune_run(torch, xc.to(dev), prng.key(18, dev),
                       [torch.tensor(v, dtype=torch.float64, device=dev) for v in schedule])
    cpu = pretune_run(torch, xc, prng.key(18),
                      [torch.tensor(v, dtype=torch.float64) for v in schedule])
    sizes = parts = 0.0
    for (a, a_info), (b, b_info) in zip(card, cpu):
        _require(torch.equal(a_info.ancestors.cpu(), b_info.ancestors),
                 "phase 19 f64 pretuning: ancestors differ between the card and the CPU")
        sizes = max(sizes, diff(a.parameter_override["step_size"],
                                b.parameter_override["step_size"]))
        parts = max(parts, diff(a.sampler_state.particles, b.sampler_state.particles))
    _require(sizes <= SMC_CMP_TOL and parts <= SMC_CMP_TOL,
             f"phase 19 f64 pretuning: step sizes {sizes}, particles {parts}")
    words.append(f"pretuning (the card's float32 noise the CPU's bit for bit on "
                 f"{P19_CMP_N} draws): ancestors identical, step sizes within {sizes:.3g}, "
                 f"particles {parts:.3g}")

    from blackjax_tpu_torch.ns import base

    for variant, inner in (("nss", NS_INNER), ("nsswig", SWIG_INNER)):
        runs = []
        for device in (dev, "cpu"):
            x, key = xc.to(device), prng.key(18, device)
            prev = ns_run(torch, x, key, variant, NS_CMP_DELETE, inner, 0, None)[0]
            with recorded_choices() as starts:
                _, steps = ns_run(torch, x, key, variant, NS_CMP_DELETE, inner, P19_CMP_STEPS,
                                  None)
            _require(len(starts) == len(steps),
                     f"phase 19 f64 {variant}: {len(starts)} start draws in {len(steps)} steps")
            indices = []
            for (state, _), start in zip(steps, starts):
                indices.append((base.delete_fn(prev, NS_CMP_DELETE)[0], start))
                prev = state
            runs.append((steps, indices))
        (card, card_idx), (cpu, cpu_idx) = runs
        x_err = z_err = 0.0
        for (a, a_info), (b, b_info), ia, ib in zip(card, cpu, card_idx, cpu_idx):
            for one, other, what in ((ia[0], ib[0], "dead"), (ia[1], ib[1], "start")):
                _require(torch.equal(one.cpu(), other),
                         f"phase 19 f64 {variant}: {what} indices differ between the card and the CPU")
            for field in ("num_shrink", "num_expansions"):
                _require(torch.equal(getattr(a_info.update_info, field).cpu(),
                                     getattr(b_info.update_info, field)),
                         f"phase 19 f64 {variant}: {field} differ between the card and the CPU")
            x_err = max(x_err, diff(a.particles.position, b.particles.position),
                        diff(a_info.particles.position, b_info.particles.position))
            z_err = max(z_err, *(diff(getattr(a.integrator, f), getattr(b.integrator, f))
                                 for f in ("logX", "logZ", "logZ_live")))
        _require(x_err <= SMC_CMP_TOL and z_err <= 1e-10,
                 f"phase 19 f64 {variant}: positions {x_err}, integrator {z_err}")
        words.append(f"{variant} (deleting {NS_CMP_DELETE}, {inner} inner steps): dead and start "
                     f"indices, num_shrink and num_expansions identical, positions within "
                     f"{x_err:.3g}, the integrator within {z_err:.3g} (tolerance 1e-10)")
    return words


def particle_path(torch, dev, peaks, smi):
    """Phase 19: persistent-sampling SMC, pretuning and nested slice sampling
    on the tracked SMC target at 16,384 particles or live points, with their
    gates, the f64 holds and the threefry export's times at the path's
    launch sizes (see the head of this file). Returns the threefry launches
    counted on the path."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.ops import counter_rng
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    x0 = smc_init(torch, SMC_PARTICLES, dev, torch.float32)
    schedule = [torch.tensor(v, dtype=torch.float32, device=dev)
                for v in np.linspace(*PRETUNE_SCHEDULE)]
    samplers = {
        "adaptive_persistent_sampling_smc": lambda: ps_run(torch, x0, prng.key(18, dev)),
        "pretuning": lambda: pretune_run(torch, x0, prng.key(18, dev), schedule),
        "nss": lambda: ns_run(torch, x0, prng.key(18, dev)),
        "nsswig": lambda: ns_run(torch, x0, prng.key(18, dev), "nsswig",
                                 num_inner_steps=SWIG_INNER),
    }
    busy_runs = {
        "nss": lambda: ns_run(torch, x0, prng.key(18, dev), max_steps=NS_BUSY_STEPS, stop=None),
        "nsswig": lambda: ns_run(torch, x0, prng.key(18, dev), "nsswig",
                                 num_inner_steps=SWIG_INNER, max_steps=NS_BUSY_STEPS, stop=None),
    }
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    # a warm run of each short sampler first (key 17), as phase 16 does: a
    # first run loads kernels and grows the allocator's pool
    ps_run(torch, x0, prng.key(17, dev))
    pretune_run(torch, x0, prng.key(17, dev), schedule)
    results = {}
    for name, run in samplers.items():
        before = dc.LAUNCHES["threefry2x32"]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = run()
        end.record()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results[name] = (out, secs, start.elapsed_time(end), dc.LAUNCHES["threefry2x32"] - before)
    launches19 = dict(dc.LAUNCHES)  # counted before the busy runs' and the holds' launches
    _require(all(r[3] > 0 for r in results.values()),
             f"phase 19: a sampler launched no threefry kernel: "
             f"{ {name: r[3] for name, r in results.items()} }")

    parts = {"runs": sum(r[1] for r in results.values()), "summaries and gates": 0.0,
             "busy-share runs": 0.0}
    for name, (out, secs, event_ms, launches) in results.items():
        t_part = time.perf_counter()
        if name == "adaptive_persistent_sampling_smc":
            steps = out
            s = _ps_summary(steps)
            _require(s["lambdas"][-1] == 1.0 and len(steps) <= PS_N_SCHEDULE,
                     f"phase 19 {name}: lambda ends at {s['lambdas'][-1]} after {len(steps)} steps")
            tensors = tuple(steps[-1][0][:4]) + tuple(steps[-1][1])
            what = (f"n_schedule {PS_N_SCHEDULE}, MALA at {SMC_STEP_SIZE}, target ESS "
                    f"{SMC_TARGET_ESS}, {SMC_MCMC_STEPS} MCMC steps: lambda "
                    f"{', '.join(f'{lam:.6f}' for lam in s['lambdas'])}; mean acceptance a step "
                    f"{', '.join(f'{a:.4f}' for a in s['accept'])}")
            unit, busy_fn = "tempering steps", lambda: ps_run(torch, x0, prng.key(18, dev))
        elif name == "pretuning":
            steps = out
            s = _pretune_summary(torch, steps)
            tensors = (steps[-1][0].sampler_state, steps[-1][0].parameter_override, steps[-1][1])
            what = (f"over tempered_smc along linspace{PRETUNE_SCHEDULE}, MALA step sizes per "
                    f"particle from {SMC_STEP_SIZE}, sigma {PRETUNE_SIGMA}, alpha {PRETUNE_ALPHA}: "
                    f"the step sizes end at mean {s['step_size'][0]:.4f} (range "
                    f"{s['step_size'][1]:.4f}-{s['step_size'][2]:.4f}; the JAX package's "
                    f"{PARTICLE_REFERENCE['pretuning']['step_size_mean']:.4f} on key 18)")
            unit, busy_fn = "tempering steps", samplers["pretuning"]
        else:
            state, steps = out
            s = ns_summary(torch, state, steps, prng.key(19, dev))
            integ = state.integrator
            _require(float(integ.logZ_live - integ.logZ) < NS_STOP and len(steps) < NS_MAX_STEPS,
                     f"phase 19 {name}: not converged after {len(steps)} steps")
            inner = NS_INNER if name == "nss" else f"{SWIG_INNER} (cut from {NS_INNER})"
            what = (f"deleting {NS_DELETE} a step, {inner} inner steps, until logZ_live - logZ < "
                    f"{NS_STOP}")
            what += (f"; {NS_SAMPLES} posterior draws, ESS {s['ess']:.1f}, logZ {float(integ.logZ):.5f}, "
                     f"logZ_live {float(integ.logZ_live):.5f}")
            # a particle born of the prior keeps a NaN birth contour (the
            # reference's mark): the births are held apart, never infinite
            info = steps[-1][1]
            births = (state.particles.loglikelihood_birth, info.particles.loglikelihood_birth)
            _require(all(b.is_cuda and not bool(torch.isinf(b).any()) for b in births),
                     f"phase 19 {name}: an infinite birth contour or one off the card")
            tensors = (state.particles._replace(loglikelihood_birth=None), state.integrator,
                       state.inner_kernel_params,
                       info.particles._replace(loglikelihood_birth=None), info.update_info)
            unit, busy_fn = "NS steps", busy_runs[name]
        mean_err, var_err = _particle_gates(torch, name, s, tensors)
        t_busy = time.perf_counter()
        parts["summaries and gates"] += t_busy - t_part
        busy = _device_busy(torch, busy_fn)
        parts["busy-share runs"] += time.perf_counter() - t_busy
        busy_words = "not measured (no device record)" if busy is None else (
            f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
            f"{busy[0] / busy[2]:.4f}")
        if name in busy_runs:
            busy_words += f" (a {NS_BUSY_STEPS}-step run)"
        ref = PARTICLE_REFERENCE[name]
        n = len(steps)
        print(f"phase 19 {name}: {SMC_PARTICLES} x {SMC_D}, f32, key 18, {what}; {n} {unit}; "
              f"log Z {s['log_z']:.5f} (exact {SMC_LOG_Z:.5f}, error {s['log_z'] - SMC_LOG_Z:+.5f}, "
              f"gate {PARTICLE_GATES[name][0]}; the JAX package's worst {ref['worst_log_z_err']:.4f}); "
              f"largest |mean - 0.9 obs| {mean_err:.5f} (gate {PARTICLE_GATES[name][1]}; the JAX "
              f"package's worst {ref['worst_mean_err']:.4f}), largest |var - 0.9| {var_err:.5f}; "
              f"{secs:.4f} s by host clock ({1.0 / secs:.4f} runs/sec), {event_ms:.3f} ms by CUDA "
              f"events, {secs / n * 1e3:.3f} host ms a step; threefry launches {launches} "
              f"({launches / n:.1f} a step); device {busy_words} ({smi})")
    t_part = time.perf_counter()
    print("phase 19 f64 holds, the card against the port on the CPU, "
          f"{P19_CMP_N} particles or live points, {P19_CMP_STEPS} steps, key 18: "
          + "; ".join(particle_holds(torch, dev)) + f" ({smi})")
    parts["f64 holds"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # the threefry export at the path's launch sizes (a key per element)
    rng = np.random.default_rng(19)
    times = []
    for n in TF_PATH_KEYS:
        words = [torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64))
                 .to(dev) for _ in range(4)]
        _require(all(torch.equal(a.cpu(), b) for a, b in zip(
            prng.threefry2x32(*words), counter_rng.threefry2x32(*(w.cpu() for w in words)))),
            f"phase 19: the threefry export differs from its plain version at {n} keys")
        call_ms = _timed_mean(torch, lambda: prng.threefry2x32(*words), 50)
        # a second trace where the first lost kernel records
        dev_ms = (_device_ms(torch, lambda: prng.threefry2x32(*words), "threefry_kernel", 50)
                  or _device_ms(torch, lambda: prng.threefry2x32(*words), "threefry_kernel", 50))
        bound = _bound(n * THREEFRY_BYTES, 0.0, peaks, n * THREEFRY_OPS, d=1)
        over = "" if dev_ms is None else f", {dev_ms / bound[0]:.1f} times"
        times.append(f"{n} keys: kernel {_ms_words(dev_ms, 'us')} (bound {bound[0] * 1e3:.4f} us "
                     f"by {bound[1]}{over}), a call {call_ms * 1e3:.2f} us")
    print(f"phase 19 threefry2x32 (a key per element) at the path's launch sizes, bit for bit its "
          f"plain version; the kernel's device time by torch.profiler over 50 launches, a call's "
          f"time by CUDA events over 50 back-to-back calls that keep their outputs (paced by the "
          f"wrapper's host work and the allocator between launches, not by the kernel): {'; '.join(times)}; launches on the path "
          f"{launches19['threefry2x32']}, normal launches {launches19['normal']} ({smi})")
    parts["threefry timings"] = time.perf_counter() - t_part
    print("phase 19 host seconds by part: "
          + ", ".join(f"{name} {secs:.1f}" for name, secs in parts.items()))
    return {name: launches19[name] for name in PRNG_KERNELS}


def chees_run(torch, positions, key, num_steps, **options):
    """The tracked cross-chain configuration's warmup from ``positions`` on
    ``key`` (key words): ``chees_adaptation(ill_conditioned_gaussian(d)
    .logdensity_fn, num_chains, **options).run(key, positions, 0.05,
    adam(0.25), num_steps)``."""
    from blackjax_tpu_torch import chees_adaptation
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.optimizers import optax_twins

    target = ill_conditioned_gaussian(positions.shape[1])
    warmup = chees_adaptation(target.logdensity_fn, positions.shape[0], **options)
    return warmup.run(key, positions, CHEES_STEP_SIZE, optax_twins.adam(CHEES_LR), num_steps)


def _harmonic_acceptance(info, step=-1):
    """The harmonic mean of a step's acceptance rates over the chains that
    did not diverge, as the controller reads them."""
    keep = ~info.info.is_divergent[step]
    rates = info.info.acceptance_rate[step].double()[keep]
    return float(rates.numel() / (1.0 / rates).sum())


def chees_holds(torch, dev):
    """Phase 20's f64 hold: both settings at CHEES_CMP_CHAINS x
    CHEES_CMP_STEPS on the card and on the CPU, key 20. Returns a line's
    words for each."""
    from blackjax_tpu_torch import prng

    x = torch.from_numpy(np.random.default_rng(20).standard_normal(
        (CHEES_CMP_CHAINS, CHEES_D)))
    words = []
    diagonal = {"mass_matrix_estimation": "diagonal"}
    for label, options in (("default", {}),
                           ("diagonal with the floor", {**diagonal, "_length_floor": True})):
        (card_s, card_p), card_i = chees_run(torch, x.to(dev), prng.key(20, dev),
                                             CHEES_CMP_STEPS, **options)
        (cpu_s, cpu_p), cpu_i = chees_run(torch, x, prng.key(20), CHEES_CMP_STEPS, **options)
        _require(torch.equal(card_i.info.num_integration_steps.cpu(),
                             cpu_i.info.num_integration_steps),
                 f"phase 20 f64 {label}: step counts differ between the card and the CPU")
        ctl = max(float(((getattr(card_i.adaptation_state, f).cpu()
                          - getattr(cpu_i.adaptation_state, f)).abs()
                         / getattr(cpu_i.adaptation_state, f).abs()).max())
                  for f in ("step_size", "trajectory_length", "log_step_size_moving_average",
                            "log_trajectory_length_moving_average"))
        pos = max(float((card_i.state.position.cpu() - cpu_i.state.position).abs().max()),
                  float((card_s.position.cpu() - cpu_s.position).abs().max()))
        par = max(float((card_p[k].cpu() - cpu_p[k]).abs().max())
                  for k in ("step_size", "inverse_mass_matrix"))
        par = max(par, float((card_p["integration_steps_params"][0].cpu()
                              - cpu_p["integration_steps_params"][0]).abs()))
        _require(ctl <= CHEES_CMP_TOL and pos <= CHEES_CMP_TOL and par <= CHEES_CMP_TOL,
                 f"phase 20 f64 {label}: controller {ctl}, positions {pos}, parameters {par}")
        floor_words = ""
        if options.get("_length_floor"):
            # the same run without the floor: the hold covers the floor only
            # if it changed some step's drawn counts
            (_, free_p), free_i = chees_run(torch, x, prng.key(20), CHEES_CMP_STEPS, **diagonal)
            bound = (cpu_i.info.num_integration_steps
                     != free_i.info.num_integration_steps).any(dim=1)
            _require(bool(bound.any()), "phase 20 f64: the floor bound on no step of the hold")
            floor_words = (f"; the floor changed the drawn counts of steps "
                           f"{torch.nonzero(bound).flatten().tolist()} (against an unfloored "
                           f"run), the returned parameter {float(cpu_p['integration_steps_params'][0]):.6f} "
                           f"(unfloored {float(free_p['integration_steps_params'][0]):.6f})")
        words.append(f"{label}: step counts identical, the controller within {ctl:.3g} "
                     f"(relative), every chain's positions at every step within {pos:.3g}, the "
                     f"parameters (integration_steps_params among them) within {par:.3g}"
                     + floor_words)
    return words


def chees_path(torch, dev, smi):
    """Phase 20: the tracked cross-chain ChEES configuration at full size on
    the card, its gates, the diagonal run with the floor and the f64 hold
    (see the head of this file). Returns the threefry and normal launches of
    the timed run."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    target = ill_conditioned_gaussian(CHEES_D)
    variances = torch.tensor(target.std, dtype=torch.float64) ** 2
    positions = prng.normal(prng.key(CHEES_SEED, dev), (CHEES_CHAINS, CHEES_D), torch.float32)
    keys = prng.split(prng.key(CHEES_SEED, dev), 4)
    parts = {}
    t_part = time.perf_counter()
    chees_run(torch, positions, keys[1], CHEES_WARM_STEPS)  # warm: kernels, the allocator
    parts["warm run"] = time.perf_counter() - t_part
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    (states, params), info = chees_run(torch, positions, keys[0], CHEES_STEPS)
    end.record()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches20 = {name: dc.LAUNCHES[name] for name in PRNG_KERNELS}
    parts["timed run"] = secs
    _require(launches20["threefry2x32"] > 0 and launches20["normal"] > 0,
             f"phase 20: the ChEES run launched no threefry or normal kernel: {launches20}")
    t_part = time.perf_counter()
    card, finite = _on_card(torch, (states, info, params["step_size"],
                                    params["inverse_mass_matrix"],
                                    *params["integration_steps_params"]))
    _require(card, "phase 20: a state or info tensor is not on the card")
    _require(finite, "phase 20: non-finite values")
    grads = int(info.info.num_integration_steps.sum())
    step_size = float(params["step_size"])
    steps_param = float(params["integration_steps_params"][0])
    for name, value in (("step_size", step_size), ("integration_steps_params", steps_param)):
        mean, half = CHEES_REFERENCE[name]
        _require(abs(value - mean) <= half,
                 f"phase 20: the final {name} {value} outside {mean} +- {half}")
    x = states.position.double()
    ratio = (x.var(0) / variances.to(dev)).cpu().numpy()
    mean_sd = float((x.mean(0).abs() / variances.to(dev).sqrt()).max())
    _require(bool(((ratio >= CHEES_VAR_BAND[0]) & (ratio <= CHEES_VAR_BAND[1])).all()),
             f"phase 20: variance / target's {ratio.min()}-{ratio.max()} outside {CHEES_VAR_BAND}")
    _require(mean_sd <= CHEES_MEAN_SD, f"phase 20: a mean {mean_sd} sd from 0")
    accept = _harmonic_acceptance(info)
    del states, info
    torch.cuda.empty_cache()
    parts["gates"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    busy = _device_busy(torch, lambda: chees_run(
        torch, positions, keys[0], CHEES_BUSY_STEPS,
        adaptation_info_fn=get_filter_adapt_info_fn()))
    parts["busy-share run"] = time.perf_counter() - t_part
    busy_words = "not measured (no device record)" if busy is None else (
        f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
        f"{busy[0] / busy[2]:.4f}")
    ref = CHEES_REFERENCE
    print(f"phase 20 chees_adaptation (benchmarks/tracked.py:744-788): ill_conditioned_gaussian"
          f"({CHEES_D}), {CHEES_CHAINS} chains from normal(key({CHEES_SEED})), step size "
          f"{CHEES_STEP_SIZE}, adam({CHEES_LR}), {CHEES_STEPS} steps, the defaults, f32, on "
          f"split(key({CHEES_SEED}), 4)[0] after a warm run of {CHEES_WARM_STEPS} steps: "
          f"{secs:.3f} s by host clock, {start.elapsed_time(end):.1f} ms by CUDA events, "
          f"{secs / CHEES_STEPS * 1e3:.3f} host ms a step; {grads} leapfrog grads "
          f"({grads / (CHEES_CHAINS * CHEES_STEPS):.3f} a chain a step), {grads / secs:.4g} "
          f"leapfrog-grads/sec; threefry launches {launches20['threefry2x32']} "
          f"({launches20['threefry2x32'] / CHEES_STEPS:.1f} a step), normal launches "
          f"{launches20['normal']}; final step size {step_size:.5f} (the JAX package's {ref['step_size'][0]:.5f} "
          f"+- {ref['step_size'][1]:.5f}), integration_steps_params {steps_param:.4f} "
          f"({ref['integration_steps_params'][0]:.4f} +- "
          f"{ref['integration_steps_params'][1]:.4f}), trajectory length "
          f"{step_size * steps_param:.4f}, the last step's harmonic-mean acceptance "
          f"{accept:.4f}; the final ensemble's variance / the target's "
          f"{ratio.min():.4f}-{ratio.max():.4f}, largest |mean| {mean_sd:.4f} sd; device "
          f"{busy_words} (a {CHEES_BUSY_STEPS}-step run) ({smi})")

    t_part = time.perf_counter()
    floor_options = {"mass_matrix_estimation": "diagonal", "_length_floor": True,
                     "adaptation_info_fn": get_filter_adapt_info_fn(
                         state_keys={"position"},
                         adapt_state_keys={"log_trajectory_length_moving_average"})}
    t0 = time.perf_counter()
    (states_d, params_d), info_d = chees_run(torch, positions, keys[0], CHEES_DIAG_STEPS,
                                             **floor_options)
    torch.cuda.synchronize()
    secs_d = time.perf_counter() - t0
    imm = params_d["inverse_mass_matrix"].double()
    imm_ratio = (imm / variances.to(dev)).cpu().numpy()
    card, finite = _on_card(torch, (states_d, params_d["step_size"], imm,
                                    *params_d["integration_steps_params"]))
    _require(card and finite, "phase 20 diagonal: a tensor off the card or not finite")
    _require(bool(((imm_ratio >= CHEES_IMM_BAND[0]) & (imm_ratio <= CHEES_IMM_BAND[1])).all()),
             f"phase 20 diagonal: imm / variances {imm_ratio.min()}-{imm_ratio.max()} outside "
             f"{CHEES_IMM_BAND}")
    length_d = float(params_d["integration_steps_params"][0] * params_d["step_size"])
    unfloored = float(torch.exp(info_d.adaptation_state.log_trajectory_length_moving_average[-1]))
    # the floor from the run's own draws: the covariance of the window's
    # positions (the dense accumulator's samples), whitened by the returned
    # metric; the port's power iteration gives a Rayleigh quotient between its
    # smallest and largest eigenvalue, so the returned length lies between
    # ChEES's own floored at each (the cap, max_leapfrog_steps steps, is far)
    window = info_d.state.position[int(CHEES_DIAG_STEPS * 0.5):].reshape(-1, CHEES_D).double()
    centred = window - window.mean(0)
    inv_sqrt = imm.rsqrt()
    whitened = (centred.T @ centred) / (window.shape[0] - 1) * inv_sqrt[:, None] * inv_sqrt
    lambdas = torch.linalg.eigvalsh(whitened)
    floors = [math.pi / 2 * float(lam) ** 0.5 for lam in (lambdas[0], lambdas[-1])]
    low, high = (max(unfloored, f) for f in floors)
    _require(not bool((imm == 1.0).all()) and low * (1 - 1e-5) <= length_d <= high * (1 + 1e-5),
             f"phase 20 diagonal: the returned length {length_d} outside [{low}, {high}] (ChEES's "
             f"own {unfloored}, lambda {float(lambdas[0])}-{float(lambdas[-1])})")
    parts["diagonal run"] = time.perf_counter() - t_part
    print(f"phase 20 chees_adaptation(mass_matrix_estimation='diagonal', _length_floor=True), "
          f"{CHEES_CHAINS} x {CHEES_DIAG_STEPS} steps (cut from {CHEES_STEPS}): {secs_d:.3f} s; "
          f"the adapted inverse mass matrix / the target's variances {imm_ratio.min():.4f}-"
          f"{imm_ratio.max():.4f} (gate {CHEES_IMM_BAND}); the whitened window covariance's "
          f"eigenvalues {float(lambdas[0]):.4f}-{float(lambdas[-1]):.4f} (eigvalsh), so the floor "
          f"{floors[0]:.4f}-{floors[1]:.4f}; the returned length {length_d:.4f} in [{low:.4f}, "
          f"{high:.4f}] (the floor {'binds' if length_d > unfloored * (1 + 1e-6) else 'does not bind'}: "
          f"ChEES's own {unfloored:.4f}), step size {float(params_d['step_size']):.5f} ({smi})")
    del states_d, info_d
    torch.cuda.empty_cache()

    t_part = time.perf_counter()
    print(f"phase 20 f64 hold, the card against the port on the CPU, {CHEES_CMP_CHAINS} chains x "
          f"{CHEES_CMP_STEPS} steps at d = {CHEES_D}, key 20: " + "; ".join(chees_holds(torch, dev))
          + f" (tolerance {CHEES_CMP_TOL}) ({smi})")
    parts["f64 hold"] = time.perf_counter() - t_part
    print("phase 20 host seconds by part: "
          + ", ".join(f"{name} {secs:.1f}" for name, secs in parts.items()))
    return launches20


def meads_run(torch, positions, key, num_steps, **options):
    """The tracked MEADS configuration's warmup from ``positions`` on ``key``
    (key words): ``meads_adaptation(ill_conditioned_gaussian(d).logdensity_fn,
    num_chains, **options).run(key, positions, num_steps)``."""
    from blackjax_tpu_torch import meads_adaptation
    from blackjax_tpu_torch.models import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(positions.shape[1])
    warmup = meads_adaptation(target.logdensity_fn, positions.shape[0], **options)
    return warmup.run(key, positions, num_steps)


def meads_summary(torch, params, positions, std):
    """A run's gated statistics, as ``tools/meads_reference.py`` reckons
    them: the final parameters, and the smallest and largest ratio of the
    final positions' variances (``ddof = 1``) to the target's and of the
    momentum scale to the target's standard deviations ``std``."""
    std = std.to(positions.device)
    var_ratio = positions.double().var(0) / std**2
    scale_ratio = params["momentum_inverse_scale"].double() / std
    return {"step_size": float(params["step_size"]), "alpha": float(params["alpha"]),
            "delta": float(params["delta"]),
            "var_ratio_min": float(var_ratio.min()), "var_ratio_max": float(var_ratio.max()),
            "scale_ratio_min": float(scale_ratio.min()),
            "scale_ratio_max": float(scale_ratio.max())}


def _host_syncs(torch, fn):
    """``fn()`` under torch's CUDA sync debug mode: its result and, for each
    call that made the host wait for the device (a read back, a blocking
    copy, ``eigh``'s status check), the Python stack that made it, as
    ``(file name, function)`` pairs."""
    import traceback
    import warnings

    stacks = []

    def record(message, *args, **kwargs):
        if "synchroniz" in str(message):
            stack = [(frame.filename.rsplit("/", 1)[-1], frame.name)
                     for frame in traceback.extract_stack()[:-1]]
            while stack and stack[-1][0] == "warnings.py":  # the warning's own frames
                stack.pop()
            stacks.append(stack)

    torch.cuda.synchronize()
    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(previous)
    return out, stacks


def _in_step(stacks):
    """The syncs made inside a MEADS step (``meads_adaptation.one_step``)."""
    return sum(("meads_adaptation.py", "one_step") in stack for stack in stacks)


def _relative(a, b):
    """The largest difference of two tensors relative to ``max(|b|, 1)``."""
    a, b = a.cpu().double(), b.cpu().double()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def meads_holds(torch, dev):
    """Phase 21's f64 hold: the defaults and LRD at the configuration's CPU
    size on the card and on the CPU, key 21. Returns a line's words for
    each."""
    from blackjax_tpu_torch import prng

    x = torch.from_numpy(np.random.default_rng(21).standard_normal((MEADS_CMP_CHAINS, MEADS_D)))
    words = []
    for label, options in (("the defaults", {}),
                           (f"LRD at k = {MEADS_LRD_RANK}",
                            {"low_rank_rank": MEADS_LRD_RANK, "low_rank_window_fraction": 0.5})):
        (card_s, card_p), card_i = meads_run(torch, x.to(dev), prng.key(21, dev),
                                             MEADS_CMP_STEPS, **options)
        (cpu_s, cpu_p), cpu_i = meads_run(torch, x, prng.key(21), MEADS_CMP_STEPS, **options)
        states = max(_relative(getattr(card_s, f), getattr(cpu_s, f)) for f in card_s._fields)
        steps = max(_relative(getattr(card_i.adaptation_state, f),
                              getattr(cpu_i.adaptation_state, f))
                    for f in ("step_size", "alpha", "delta", "position_sigma"))
        params = max(_relative(card_p[k], cpu_p[k]) for k in ("step_size", "alpha", "delta"))
        scale, cpu_scale = card_p["momentum_inverse_scale"], cpu_p["momentum_inverse_scale"]
        if options:  # the payload as its operator: eigh's columns carry arbitrary signs
            params = max(params, _relative(scale.sigma, cpu_scale.sigma),
                         _relative(scale.lam, cpu_scale.lam),
                         _relative((scale.U * scale.lam) @ scale.U.T,
                                   (cpu_scale.U * cpu_scale.lam) @ cpu_scale.U.T))
        else:
            params = max(params, _relative(scale, cpu_scale))
        _require(max(states, steps, params) <= MEADS_CMP_TOL,
                 f"phase 21 f64 {label}: final states {states}, per-step parameters {steps}, "
                 f"returned parameters {params}")
        words.append(f"{label}: the final states within {states:.3g}, every step's per-fold "
                     f"step_size, alpha, delta and scales within {steps:.3g}, the returned "
                     f"parameters{' (the operator U diag(lam) U^T among them)' if options else ''} "
                     f"within {params:.3g}")
    return words


def meads_path(torch, dev, smi):
    """Phase 21: the tracked MEADS configuration at full size on the card, its
    gates, the LRD run at full width and the f64 hold (see the head of this
    file). Returns the threefry and normal launches of the timed run on
    key 0."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    std = torch.tensor(ill_conditioned_gaussian(MEADS_D).std, dtype=torch.float64)
    positions = prng.normal(prng.key(MEADS_SEED, dev), (MEADS_CHAINS, MEADS_D), torch.float32)
    keys = prng.split(prng.key(MEADS_SEED, dev), MEADS_KEYS)
    # the configuration's jit discards the per-step info: keep the per-fold
    # parameters only
    per_fold = {"adaptation_info_fn": get_filter_adapt_info_fn(
        adapt_state_keys={"step_size", "alpha", "delta"})}
    parts = {}
    t_part = time.perf_counter()
    meads_run(torch, positions, keys[1], MEADS_WARM_STEPS, **per_fold)  # kernels, the allocator
    parts["warm run"] = time.perf_counter() - t_part

    secs, events_ms, summaries, launches21 = [], [], [], None
    for i in range(MEADS_KEYS):
        if i == 0:
            for name in dc.LAUNCHES:
                dc.LAUNCHES[name] = 0
        steps = MEADS_STEPS if i == 0 else MEADS_CHEAP_STEPS
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        (states, params), info = meads_run(torch, positions, keys[i], steps, **per_fold)
        end.record()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        events_ms.append(start.elapsed_time(end))
        if i == 0:
            launches21 = {name: dc.LAUNCHES[name] for name in PRNG_KERNELS}
        card, finite = _on_card(torch, (states, info, params))
        _require(card, f"phase 21 key {i}: a state, info or parameter tensor is not on the card")
        _require(finite, f"phase 21 key {i}: non-finite values")
        summary = meads_summary(torch, params, states.position, std)
        for name, value in summary.items():
            mean, half = MEADS_REFERENCE[name]
            _require(abs(value - mean) <= half,
                     f"phase 21 key {i}: {name} {value} outside {mean} +- {half}")
        summaries.append(summary)
        del states, info
    parts["key 0's timed run"], parts["keys 1-2"] = secs[0], sum(secs[1:])
    _require(launches21["threefry2x32"] > 0 and launches21["normal"] > 0,
             f"phase 21: the MEADS run launched no threefry or normal kernel: {launches21}")

    t_part = time.perf_counter()
    _, stacks = _host_syncs(torch, lambda: meads_run(torch, positions, keys[0],
                                                     MEADS_BUSY_STEPS, **per_fold))
    syncs, run_syncs = _in_step(stacks), len(stacks)
    _require(syncs == 0, f"phase 21: {syncs} host syncs in {MEADS_BUSY_STEPS} MEADS steps")
    busy = _device_busy(torch, lambda: meads_run(torch, positions, keys[0], MEADS_BUSY_STEPS,
                                                 **per_fold))
    parts["sync and busy-share runs"] = time.perf_counter() - t_part
    busy_words = "not measured (no device record)" if busy is None else (
        f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
        f"{busy[0] / busy[2]:.4f}")
    print(f"phase 21 meads_adaptation (benchmarks/tracked.py:859-893): ill_conditioned_gaussian"
          f"({MEADS_D}), {MEADS_CHAINS} chains from normal(key({MEADS_SEED})), the defaults "
          f"(4 folds, multiplier 0.5, damping slowdown 1.0), f32, the per-step info cut to the "
          f"per-fold parameters, after a warm run of {MEADS_WARM_STEPS} steps: "
          f"split(key({MEADS_SEED}), {MEADS_KEYS})[0] at {MEADS_STEPS} steps {secs[0]:.3f} s by "
          f"host clock, {events_ms[0]:.1f} ms by CUDA events: "
          f"{MEADS_CHAINS * MEADS_STEPS / secs[0]:.6g} chain-steps/sec, "
          f"{secs[0] / MEADS_STEPS * 1e3:.3f} host ms a step; keys 1 and 2 at "
          f"{MEADS_CHEAP_STEPS} steps (cut) {secs[1]:.3f} and {secs[2]:.3f} s "
          f"({secs[1] / MEADS_CHEAP_STEPS * 1e3:.3f} and {secs[2] / MEADS_CHEAP_STEPS * 1e3:.3f} "
          f"host ms a step); threefry launches "
          f"{launches21['threefry2x32']} ({launches21['threefry2x32'] / MEADS_STEPS:.2f} a step), "
          f"normal launches {launches21['normal']} ({launches21['normal'] / MEADS_STEPS:.2f} a "
          f"step) (key 0); host syncs {syncs} in {MEADS_BUSY_STEPS} steps ({run_syncs} in their "
          f"whole run, at {sorted({s[-1] for s in stacks})}); device "
          f"{busy_words} (a {MEADS_BUSY_STEPS}-step run) ({smi})")
    for i, summary in enumerate(summaries):
        steps = MEADS_STEPS if i == 0 else MEADS_CHEAP_STEPS
        print(f"phase 21 key {i} ({steps} steps): " + ", ".join(
            f"{name} {value:.5f} (the JAX package's {MEADS_REFERENCE[name][0]:.5f} +- "
            f"{MEADS_REFERENCE[name][1]:.5f})" for name, value in summary.items()))

    t_part = time.perf_counter()
    lrd = {"low_rank_rank": MEADS_LRD_RANK, "low_rank_window_fraction": 0.5, **per_fold}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ((states_l, params_l), _), stacks = _host_syncs(
        torch, lambda: meads_run(torch, positions, keys[0], MEADS_LRD_STEPS, **lrd))
    lrd_syncs = _in_step(stacks)
    torch.cuda.synchronize()
    secs_l = time.perf_counter() - t0
    payload = params_l["momentum_inverse_scale"]
    card, finite = _on_card(torch, (states_l, params_l))
    _require(card and finite, "phase 21 LRD: a tensor off the card or not finite")
    _require(payload.U.shape == (MEADS_D, MEADS_LRD_RANK) and not bool((payload.lam == 1.0).all()),
             "phase 21 LRD: the returned payload is not the window's eigh estimate")
    parts["LRD run"] = time.perf_counter() - t_part
    lam = payload.lam.double().cpu()
    print(f"phase 21 meads_adaptation(low_rank_rank={MEADS_LRD_RANK}, "
          f"low_rank_window_fraction=0.5), {MEADS_CHAINS} x {MEADS_LRD_STEPS} steps (cut from "
          f"{MEADS_STEPS}), f32: {secs_l:.3f} s by host clock ({secs_l / MEADS_LRD_STEPS * 1e3:.3f} "
          f"ms a step, the sync counter on), {lrd_syncs} host syncs in its steps "
          f"({lrd_syncs / MEADS_LRD_STEPS:.2f} a step; the window's {MEADS_LRD_STEPS // 2} steps "
          f"run eigh), {len(stacks)} in the run; every value "
          f"finite and on the card; lam {float(lam.min()):.4f}-{float(lam.max()):.4f}, step size "
          f"{float(params_l['step_size']):.5f}, alpha {float(params_l['alpha']):.5f} ({smi})")
    del states_l, params_l
    torch.cuda.empty_cache()

    t_part = time.perf_counter()
    print(f"phase 21 f64 hold, the card against the port on the CPU, {MEADS_CMP_CHAINS} chains x "
          f"{MEADS_CMP_STEPS} steps at d = {MEADS_D}, key 21: " + "; ".join(meads_holds(torch, dev))
          + f" (tolerance {MEADS_CMP_TOL}, relative to max(|x|, 1)) ({smi})")
    parts["f64 hold"] = time.perf_counter() - t_part
    print("phase 21 host seconds by part: "
          + ", ".join(f"{name} {secs:.1f}" for name, secs in parts.items()))
    return launches21


def pathfinder_run(torch, position, key, num_steps, num_chains=PF_CHAINS, **options):
    """Phase 22's warmup from the ``(d,)`` ``position`` on ``key`` (key
    words): ``pathfinder_adaptation(hmc, ill_conditioned_gaussian(d)
    .logdensity_fn, num_chains, num_integration_steps=20, **options).run(key,
    position, num_steps)``."""
    from blackjax_tpu_torch import pathfinder_adaptation
    from blackjax_tpu_torch.mcmc import hmc
    from blackjax_tpu_torch.models import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(position.shape[-1])
    warmup = pathfinder_adaptation(hmc, target.logdensity_fn, num_chains=num_chains,
                                   num_integration_steps=PF_INTEGRATION_STEPS, **options)
    return warmup.run(key, position, num_steps)


def pathfinder_summary(torch, params, positions, variances):
    """A run's gated statistics, as ``tools/pathfinder_reference.py``
    reckons them, in float64: the inverse mass matrix's diagonal over the
    target's ``variances`` and its off-diagonal mass, the per-chain step
    sizes' median (numpy's, the mean of the two middle ones), smallest and
    largest, and the final positions' variances (``ddof = 1``) over the
    target's; and Pareto k-hat."""
    imm = params["inverse_mass_matrix"].double()
    variances = variances.to(imm.device)
    diag = torch.diagonal(imm)
    ratio = diag / variances
    off = imm - torch.diag(diag)
    steps = params["step_size"].double()
    var_ratio = positions.double().var(0) / variances
    return {"imm_ratio_min": float(ratio.min()), "imm_ratio_max": float(ratio.max()),
            "offdiag_mass": float(torch.linalg.norm(off) / torch.linalg.norm(imm)),
            "step_size_median": float(torch.quantile(steps, 0.5)),
            "step_size_min": float(steps.min()), "step_size_max": float(steps.max()),
            "var_ratio_min": float(var_ratio.min()), "var_ratio_max": float(var_ratio.max()),
            "pareto_k": float(params["_pathfinder_psis_pareto_k"])}


@contextlib.contextmanager
def _pathfinder_stages(torch, dc):
    """Splits a ``pathfinder_adaptation`` run at its dual-averaging loop
    (``_step_size_loop``): the loop's arguments, the host clock (after a
    device sync) and the launch counts at its start and end."""
    from blackjax_tpu_torch.adaptation import pathfinder_adaptation as pa

    marks = {}
    loop = pa._step_size_loop

    def split(*args):
        marks["args"] = args
        torch.cuda.synchronize()
        marks["start"], marks["launches"] = time.perf_counter(), dict(dc.LAUNCHES)
        out = loop(*args)
        torch.cuda.synchronize()
        marks["end"] = time.perf_counter()
        return out

    pa._step_size_loop = split
    try:
        yield marks
    finally:
        pa._step_size_loop = loop


def _in_pathfinder_step(stacks):
    """The syncs made inside the dual-averaging loop (``_step_size_loop``):
    ``(factor, other)``, those of the metric's Cholesky factor
    (``metrics._sqrt_factors``), which the loop builds once before its
    steps, and all others, which a step would make."""
    inside = [stack for stack in stacks
              if ("pathfinder_adaptation.py", "_step_size_loop") in stack]
    factor = sum(("metrics.py", "_sqrt_factors") in stack for stack in inside)
    return factor, len(inside) - factor


def pathfinder_holds(torch, dev):
    """Phase 22's f64 hold on key 24: the Pathfinder stage of
    ``pathfinder_adaptation`` (every iterate and ELBO of every path, the
    draws, the PSIS weights, the inverse mass matrix), the free run's first
    steps, and every dual-averaging step taken on the card from the CPU's
    state before it. Returns the line's words."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.adaptation import pathfinder_adaptation as pa
    from blackjax_tpu_torch.adaptation.base import return_all_adapt_info
    from blackjax_tpu_torch.mcmc import hmc
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.util import tree_map
    from blackjax_tpu_torch.vi import multipathfinder

    logdensity_fn = ill_conditioned_gaussian(PF_D).logdensity_fn
    x0 = prng.normal(prng.key(PF_START_SEED), (PF_CMP_CHAINS, PF_D), torch.float64)[0]
    runs, stages = {}, {}
    multi, batch = multipathfinder.multi_approximate, multipathfinder._approximate
    for where in ("cpu", dev):
        # the run's own Pathfinder stage, its every iterate kept
        captured = {}

        def keep(*args, **kwargs):
            kwargs["keep_path"] = True
            best, captured["path"] = batch(*args, **kwargs)
            return best, None

        def recorded(*args, **kwargs):
            captured["state"], info = multi(*args, **kwargs)
            return captured["state"], info

        multipathfinder._approximate, multipathfinder.multi_approximate = keep, recorded
        try:
            runs[where] = pathfinder_run(torch, x0.to(where), prng.key(24, where), PF_CMP_STEPS,
                                         num_chains=PF_CMP_CHAINS)
        finally:
            multipathfinder._approximate, multipathfinder.multi_approximate = batch, multi
        stages[where] = (captured["path"], captured["state"],
                         multipathfinder.psis_weights(captured["state"])[0])
    (card_path, card_mpf, card_w), (cpu_path, cpu_mpf, cpu_w) = stages[dev], stages["cpu"]
    finite = torch.isfinite(cpu_path.elbo)
    _require(bool(torch.equal(finite, torch.isfinite(card_path.elbo).cpu())),
             "phase 22 f64: the card's eligible iterates are not the CPU's")
    stage = max([_relative(card_path.elbo[finite.to(dev)], cpu_path.elbo[finite])]
                + [_relative(getattr(card_path, f), getattr(cpu_path, f))
                   for f in ("position", "grad_position", "alpha", "beta", "gamma")]
                + [_relative(getattr(card_mpf, f), getattr(cpu_mpf, f))
                   for f in ("samples", "logp", "logq")] + [_relative(card_w, cpu_w)])
    (card_s, card_p), card_i = runs[dev]
    (cpu_s, cpu_p), cpu_i = runs["cpu"]
    imm = max(_relative(card_p[k], cpu_p[k])
              for k in ("inverse_mass_matrix", "_pathfinder_psis_pareto_k"))
    free = max(_relative(getattr(card_i.state, f)[:, :PF_CMP_FREE],
                         getattr(cpu_i.state, f)[:, :PF_CMP_FREE]) for f in card_i.state._fields)
    free = max(free, _relative(card_i.adaptation_state.step_size[:, :PF_CMP_FREE],
                               cpu_i.adaptation_state.step_size[:, :PF_CMP_FREE]))
    diverged = _relative(card_s.position, cpu_s.position)
    # every step on the card from the CPU's state before it
    chains_key = prng.split(prng.key(24, dev), 3)[2]
    step_keys = prng.split(prng.split(chains_key, PF_CMP_CHAINS), PF_CMP_STEPS)
    update = pa.base(0.80)[2]
    kernel = hmc.build_kernel()
    steps = 0.0
    for t in range(1, PF_CMP_STEPS):
        before = tree_map(lambda a: a[:, t - 1].to(dev), (cpu_i.state, cpu_i.adaptation_state))
        state, adaptation, _ = pa._step_size_loop(
            kernel, logdensity_fn, update, return_all_adapt_info,
            {"num_integration_steps": PF_INTEGRATION_STEPS}, step_keys[:, t:t + 1], *before, 1)
        steps = max([steps] + [_relative(a, b[:, t]) for a, b in zip(state, cpu_i.state)]
                    + [_relative(a, b[:, t]) for a, b in zip(adaptation.ss_state,
                                                             cpu_i.adaptation_state.ss_state)])
    final = max(_relative(state.position, cpu_s.position),
                _relative(torch.exp(adaptation.ss_state.log_step_size_avg),
                          cpu_p["step_size"]))
    _require(max(stage, imm, free, steps, final) <= PF_CMP_TOL,
             f"phase 22 f64: the Pathfinder stage {stage}, imm and k-hat {imm}, the free run's "
             f"first steps {free}, the steps {steps}, the final states and step sizes {final}")
    return (f"the Pathfinder stage (every iterate, gradient, alpha, beta, gamma and finite ELBO "
            f"of all {PF_CMP_CHAINS} paths, {int(finite.sum())} of {finite.numel()} iterates "
            f"eligible on both; the 200 draws a path, their log-densities and PSIS weights) "
            f"within {stage:.3g}; the inverse mass matrix and k-hat within {imm:.3g}; the free "
            f"run's first {PF_CMP_FREE} steps (states and step sizes) within {free:.3g}; every "
            f"step {1}-{PF_CMP_STEPS - 1} on the card from the CPU's state before it within "
            f"{steps:.3g}, the final states and per-chain step sizes within {final:.3g} "
            f"(relative to max(|x|, 1), tolerance {PF_CMP_TOL}); the free runs' final positions "
            f"part by {diverged:.3g} (the dual averaging's first steps pass the leapfrog's "
            f"stability limit, where rounding grows about tenfold a step)")


def pathfinder_path(torch, dev, smi):
    """Phase 22: Pathfinder on config #5's target and start on the card
    (see the head of this file). Returns the threefry and normal launches of
    the timed run on key 0."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.adaptation import pathfinder_adaptation as pa
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.mcmc.metrics import lbfgs_inverse_hessian_to_low_rank_metric
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc
    from blackjax_tpu_torch.optimizers import lbfgs, optax_twins
    from blackjax_tpu_torch.optimizers.lbfgs import lbfgs_inverse_hessian_formula_1
    from blackjax_tpu_torch.vi import pathfinder

    target = ill_conditioned_gaussian(PF_D)
    variances = torch.tensor(target.std, dtype=torch.float64) ** 2
    position = prng.normal(prng.key(PF_START_SEED, dev), (PF_CHAINS, PF_D), torch.float32)[0]
    keys = prng.split(prng.key(PF_KEY_SEED, dev), PF_KEYS)
    filtered = {"adaptation_info_fn": get_filter_adapt_info_fn(
        info_keys={"acceptance_rate"}, adapt_state_keys={"step_size"})}
    parts = {}
    t_part = time.perf_counter()
    # warms the kernels and the allocator, and counts the host syncs: the
    # dual-averaging steps make none, the metric's one factor before them one
    with _pathfinder_stages(torch, dc) as warm:
        _, stacks = _host_syncs(torch, lambda: pathfinder_run(
            torch, position, keys[1], PF_WARM_STEPS, **filtered))
    factor_syncs, step_syncs = _in_pathfinder_step(stacks)
    _require(factor_syncs <= 1 and step_syncs == 0,
             f"phase 22: {step_syncs} host syncs in {PF_WARM_STEPS} dual-averaging steps, "
             f"{factor_syncs} in the metric's factor")
    parts["warm run (the sync count on)"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    args = list(warm["args"])
    args[5] = args[5][:, :PF_BUSY_STEPS]  # the step keys, (chains, steps, 2)
    busy = _device_busy(torch, lambda: pa._step_size_loop(*args))
    parts["busy-share run"] = time.perf_counter() - t_part

    runs = []
    for i in range(PF_KEYS):
        steps = PF_STEPS if i == 0 else PF_CHEAP_STEPS
        for name in dc.LAUNCHES:
            dc.LAUNCHES[name] = 0
        lbfgs.HOST_LOOPS["lbfgs"] = optax_twins.HOST_LOOPS["zoom_linesearch"] = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        with _pathfinder_stages(torch, dc) as marks:
            (states, params), info = pathfinder_run(torch, position, keys[i], steps, **filtered)
        end.record()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        card, finite = _on_card(torch, (states, info, params["step_size"],
                                        params["inverse_mass_matrix"],
                                        params["_pathfinder_psis_pareto_k"]))
        _require(card, f"phase 22 key {i}: a state, info or parameter tensor is not on the card")
        _require(finite, f"phase 22 key {i}: non-finite values")
        summary = pathfinder_summary(torch, params, states.position, variances)
        bands = PATHFINDER_REFERENCE if steps == PF_STEPS else PATHFINDER_REFERENCE_CHEAP
        for name, (mean, half) in bands.items():
            _require(abs(summary[name] - mean) <= half,
                     f"phase 22 key {i}: {name} {summary[name]} outside {mean} +- {half}")
        runs.append({"steps": steps, "secs": secs, "events_ms": start.elapsed_time(end),
                     "pathfinder_s": marks["start"] - t0, "loop_s": marks["end"] - marks["start"],
                     "stage_launches": {k: marks["launches"][k] for k in PRNG_KERNELS},
                     "launches": {k: dc.LAUNCHES[k] for k in PRNG_KERNELS},
                     "lbfgs": lbfgs.HOST_LOOPS["lbfgs"],
                     "linesearch": optax_twins.HOST_LOOPS["zoom_linesearch"],
                     "acceptance": float(info.info.acceptance_rate[:, -1].double().mean()),
                     "summary": summary, "bands": bands})
        del states, info
    parts["key 0's timed run"] = runs[0]["secs"]
    parts["keys 1-2"] = sum(r["secs"] for r in runs[1:])
    r0 = runs[0]
    launches22 = r0["launches"]
    loop_launches = {k: launches22[k] - r0["stage_launches"][k] for k in PRNG_KERNELS}
    _require(r0["stage_launches"]["threefry2x32"] > 0 and r0["stage_launches"]["normal"] > 0
             and loop_launches["threefry2x32"] > 0 and loop_launches["normal"] > 0,
             f"phase 22: a stage launched no threefry or normal kernel: {launches22}")

    busy_words = "not measured (no device record)" if busy is None else (
        f"{busy[0]:.3f} ms of device records ({busy[1]}) in {busy[2]:.3f} ms: busy "
        f"{busy[0] / busy[2]:.4f}")
    grads = PF_CHAINS * PF_INTEGRATION_STEPS * PF_STEPS
    loop_s = r0["loop_s"]
    print(f"phase 22 pathfinder_adaptation(hmc, num_integration_steps={PF_INTEGRATION_STEPS}) "
          f"on config #5's target and start (benchmarks/tracked.py:744-788): "
          f"ill_conditioned_gaussian({PF_D}), {PF_CHAINS} chains and paths of 200 draws from row "
          f"0 of normal(key({PF_START_SEED})), f32, the info cut to the acceptance rates and "
          f"step sizes, after a warm run of {PF_WARM_STEPS} steps: split(key({PF_KEY_SEED}), "
          f"{PF_KEYS})[0] at {PF_STEPS} steps {r0['secs']:.3f} s by host clock, "
          f"{r0['events_ms']:.1f} ms by CUDA events: the Pathfinder stage (L-BFGS, ELBOs, PSIS, "
          f"the mixture covariance, the starts) {r0['pathfinder_s']:.3f} s, "
          f"{r0['lbfgs']} L-BFGS iterations and {r0['linesearch']} line-search iterations of "
          f"the batch, threefry launches {r0['stage_launches']['threefry2x32']}, normal "
          f"launches {r0['stage_launches']['normal']}; the dual-averaging stage "
          f"{loop_s:.3f} s, {loop_s / PF_STEPS * 1e3:.3f} host ms a step, "
          f"{grads / loop_s:.6g} leapfrog-grads/sec, {PF_CHAINS * PF_STEPS / loop_s:.6g} "
          f"chain-steps/sec ({PF_CHAINS * PF_STEPS / r0['secs']:.6g} over the whole call), "
          f"threefry launches {loop_launches['threefry2x32']} "
          f"({loop_launches['threefry2x32'] / PF_STEPS:.2f} a step), normal launches "
          f"{loop_launches['normal']} ({loop_launches['normal'] / PF_STEPS:.2f} a step); host "
          f"syncs {step_syncs} in the warm run's {PF_WARM_STEPS} dual-averaging steps and "
          f"{factor_syncs} in the metric's factor before them ({len(stacks)} in the whole warm "
          f"run, at {sorted({s[-1] for s in stacks})}); device {busy_words} ({PF_BUSY_STEPS} "
          f"dual-averaging steps of the warm run, rerun); the last step's mean acceptance "
          f"{r0['acceptance']:.4f} ({smi})")
    for i, r in enumerate(runs):
        print(f"phase 22 key {i} ({r['steps']} steps, {r['secs']:.3f} s: Pathfinder "
              f"{r['pathfinder_s']:.3f} s with {r['lbfgs']} L-BFGS and {r['linesearch']} "
              f"line-search iterations, dual averaging {r['loop_s']:.3f} s): " + ", ".join(
                  f"{name} {value:.5f}" + (
                      f" (the JAX package's {r['bands'][name][0]:.5f} +- "
                      f"{r['bands'][name][1]:.5f})" if name in r["bands"] else " (reported)")
                  for name, value in r["summary"].items()))

    t_part = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf_state, pf_info = blackjax_tpu_torch.pathfinder.approximate(keys[0], target.logdensity_fn,
                                                                  position)
    draws, logq = pathfinder.sample(keys[1], pf_state, PF_DRAWS)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    card, finite = _on_card(torch, (pf_state, draws, logq))
    _require(card and finite and draws.shape == (PF_DRAWS, PF_D),
             "phase 22 single path: a tensor off the card, not finite or misshapen")
    payload = lbfgs_inverse_hessian_to_low_rank_metric(pf_state.alpha, pf_state.beta,
                                                       pf_state.gamma)
    dense = lbfgs_inverse_hessian_formula_1(pf_state.alpha, pf_state.beta, pf_state.gamma)
    sigma = payload.sigma
    operator = sigma[:, None] * (torch.eye(PF_D, device=dev) + (payload.U * (payload.lam - 1.0))
                                 @ payload.U.T) * sigma[None, :]
    low_rank_err = float((operator - dense).abs().max() / dense.abs().max())
    _require(low_rank_err <= PF_LOW_RANK_TOL,
             f"phase 22: the low-rank payload's operator parts from formula 1 by {low_rank_err}")
    best = int(torch.argmax(pf_info.path.elbo))
    multi = blackjax_tpu_torch.multipathfinder(target.logdensity_fn)
    starts = position[None] + 2.0 * prng.normal(keys[2], (PF_CHAINS, PF_D), torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mpf_state, _ = multi.init(keys[2], starts)
    resampled = multi.sample(keys[0], mpf_state, PF_DRAWS)
    torch.cuda.synchronize()
    multi_s = time.perf_counter() - t0
    card, finite = _on_card(torch, (mpf_state, resampled))
    _require(card and finite and resampled.shape == (PF_DRAWS, PF_D),
             "phase 22 multipathfinder: a tensor off the card, not finite or misshapen")
    parts["single path and multipathfinder"] = time.perf_counter() - t_part
    print(f"phase 22 pathfinder.approximate + sample of {PF_DRAWS} draws on the card, f32: "
          f"{single_s:.3f} s, the best ELBO {float(pf_info.path.elbo[best]):.4f} at iterate "
          f"{best} of {pf_info.path.elbo.numel()}; lbfgs_inverse_hessian_to_low_rank_metric of "
          f"its state (rank {payload.lam.numel()}, lam {float(payload.lam.min()):.4f}-"
          f"{float(payload.lam.max()):.4f}) as its operator within {low_rank_err:.3g} of "
          f"formula 1 (relative to its largest entry; tolerance {PF_LOW_RANK_TOL}); "
          f"multipathfinder init on {PF_CHAINS} paths of 200 draws + sample of {PF_DRAWS} "
          f"(PSIS resampling of {PF_CHAINS * 200} pooled draws) {multi_s:.3f} s; every value "
          f"finite and on the card ({smi})")
    del mpf_state, resampled, draws
    torch.cuda.empty_cache()

    t_part = time.perf_counter()
    print(f"phase 22 f64 hold, the card against the port on the CPU, {PF_CMP_CHAINS} chains x "
          f"{PF_CMP_STEPS} steps at d = {PF_D}, key 24: " + pathfinder_holds(torch, dev)
          + f" ({smi})")
    parts["f64 hold"] = time.perf_counter() - t_part
    print("phase 22 host seconds by part: "
          + ", ".join(f"{name} {secs:.1f}" for name, secs in parts.items()))
    return launches22


def vi_gaussian_run(torch, target, name, key, num_steps, dtype, keep=False):
    """Phase 23's ``name`` (``meanfield_vi`` or ``fullrank_vi``) on
    ``target`` from zeros of ``dtype`` on ``key``'s device: ``num_steps``
    steps with the optax twin ``adam`` at phase 23's rate and
    ``num_samples=100``, step ``i`` on ``fold_in(key, i)`` (the keys folded
    in one call). Returns the final state, the last info and, with
    ``keep``, every step's ``(state, info)``."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.optimizers import optax_twins

    algo = getattr(blackjax_tpu_torch, name)(target.logdensity_fn,
                                             optax_twins.adam(VI_GAUSSIAN[name][0]),
                                             num_samples=VI_NUM_SAMPLES)
    state = algo.init(torch.zeros(target.dim, dtype=dtype, device=key.device))
    step_keys = prng.fold_in(key, torch.arange(num_steps, device=key.device))
    history = []
    for i in range(num_steps):
        state, info = algo.step(step_keys[i], state)
        if keep:
            history.append((state, info))
    return state, info, history


def vi_svgd_run(torch, target, particles, num_steps, state=None, keep=False):
    """Phase 23's SVGD from ``particles`` ``(n, d)`` (or on from ``state``):
    ``svgd`` with the optax twin ``sgd(0.02 n)`` under the median heuristic,
    the gradients by autograd of the target's log density. Returns the final
    state and, with ``keep``, every step's."""
    import blackjax_tpu_torch
    from blackjax_tpu_torch.optimizers import optax_twins
    from blackjax_tpu_torch.util import value_and_grad

    algo = blackjax_tpu_torch.svgd(lambda x: value_and_grad(target.logdensity_fn, x)[1],
                                   optax_twins.sgd(SVGD_RATE * particles.shape[0]))
    state = algo.init(particles) if state is None else state
    history = []
    for _ in range(num_steps):
        state = algo.step(state)
        if keep:
            history.append(state)
    return state, history


def vi_sf_run(torch, target, key, num_bridges, dtype, n_steps=SF_STEPS, n_inner=SF_INNER):
    """Phase 23's bridges: ``schrodinger_follmer(logdensity, n_steps,
    n_inner).sample`` of ``num_bridges`` bridges from zeros of ``dtype`` on
    ``key``'s device."""
    import blackjax_tpu_torch

    algo = blackjax_tpu_torch.schrodinger_follmer(target.logdensity_fn, n_steps, n_inner)
    state = algo.init(torch.zeros(target.dim, dtype=dtype, device=key.device))
    return algo.sample(key, state, num_bridges)


def vi_gaussian_summary(torch, name, state, info, std):
    """A Gaussian fit's gated statistics, as ``tools/vi_reference.py`` reckons
    them, in float64: the fitted standard deviations over the target's
    ``std`` (smallest, largest), the means' largest ``|mu| / sd``, the
    last step's ``info.elbo`` and, full-rank, the off-diagonal mass of ``L
    L^T``."""
    from blackjax_tpu_torch.vi.fullrank_vi import _unflatten_cholesky

    std = std.to(state.mu.device)
    if name == "meanfield_vi":
        cov = torch.exp(2.0 * state.rho.double())
        diag = cov
    else:
        L = _unflatten_cholesky(state.chol_params.double(), std.numel())
        cov = L @ L.T
        diag = torch.diagonal(cov)
    ratio = diag.sqrt() / std
    out = {"sd_ratio_min": float(ratio.min()), "sd_ratio_max": float(ratio.max()),
           "mean_abs_sd": float((state.mu.double() / std).abs().max()),
           "elbo": float(info.elbo)}
    if name == "fullrank_vi":
        out["offdiag_mass"] = float(torch.linalg.norm(cov - torch.diag(diag))
                                    / torch.linalg.norm(cov))
    return out


def vi_particle_summary(torch, x, std):
    """Particles' or bridges' ends' gated statistics, in float64: their
    variances (``ddof = 1``) over the target's (smallest, largest) and their
    means' largest ``|mean| / sd``."""
    x = x.double()
    std = std.to(x.device)
    ratio = x.var(0) / std**2
    return {"var_ratio_min": float(ratio.min()), "var_ratio_max": float(ratio.max()),
            "mean_abs_sd": float((x.mean(0) / std).abs().max())}


def _vi_gates(label, summary, bands):
    for name, (mean, half) in bands.items():
        _require(abs(summary[name] - mean) <= half,
                 f"phase 23 {label}: {name} {summary[name]} outside {mean} +- {half}")


# the frames of one step of each family, for the sync count
VI_STEP_FRAMES = {
    "meanfield_vi": ("meanfield_vi.py", "step"),
    "fullrank_vi": ("fullrank_vi.py", "step"),
    "svgd": ("svgd.py", "step_fn"),
    "schrodinger_follmer": ("schrodinger_follmer.py", "step"),
}


def vi_holds(torch, dev):
    """Phase 23's f64 hold: each family on the card and on the CPU from the
    same keys, every step within ``VI_CMP_TOL`` relative to ``max(|x|, 1)``.
    Returns the line's words."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.vi import schrodinger_follmer

    target = ill_conditioned_gaussian(VI_D)
    words = []
    for name in VI_GAUSSIAN:
        runs = {where: vi_gaussian_run(torch, target, name, prng.key(VI_CMP_SEED, where),
                                       VI_CMP_STEPS, torch.float64, keep=True)[2]
                for where in ("cpu", dev)}
        worst = max(_relative(a, b) for (card, cpu) in zip(runs[dev], runs["cpu"])
                    for a, b in zip(card[0][:2] + (card[1].elbo,), cpu[0][:2] + (cpu[1].elbo,)))
        _require(worst <= VI_CMP_TOL, f"phase 23 f64 {name}: a step parts by {worst}")
        words.append(f"{name} {VI_CMP_STEPS} steps within {worst:.3g}")
    # the start's first rows (a draw's counters are its flat indices)
    start = prng.normal(prng.key(19), (SVGD_CMP_PARTICLES, VI_D), torch.float64)
    runs = {where: vi_svgd_run(torch, target, start.to(where), VI_CMP_STEPS, keep=True)[1]
            for where in ("cpu", dev)}
    worst = max(max(_relative(card.particles, cpu.particles),
                    _relative(card.kernel_parameters["length_scale"],
                              cpu.kernel_parameters["length_scale"]))
                for card, cpu in zip(runs[dev], runs["cpu"]))
    _require(worst <= VI_CMP_TOL, f"phase 23 f64 svgd: a step parts by {worst}")
    words.append(f"svgd {SVGD_CMP_PARTICLES} particles x {VI_CMP_STEPS} steps (particles and "
                 f"length scales) within {worst:.3g}")
    # the bridges step by step, as ``sample`` steps them, and ``sample`` itself
    runs = {}
    for where in ("cpu", dev):
        key = prng.key(VI_CMP_SEED, where)
        step_keys = prng.fold_in(key, torch.arange(VI_CMP_STEPS, device=where))
        states = schrodinger_follmer.SchrodingerFollmerState(
            torch.zeros(SF_CMP_BRIDGES, VI_D, dtype=torch.float64, device=where),
            torch.zeros(SF_CMP_BRIDGES, dtype=torch.float64, device=where))
        history = []
        for i in range(VI_CMP_STEPS):
            states, info = schrodinger_follmer.step(
                prng.split(step_keys[i], SF_CMP_BRIDGES), states, target.logdensity_fn,
                1.0 / VI_CMP_STEPS, SF_CMP_INNER)
            history.append((states, info))
        sampled = vi_sf_run(torch, target, key, SF_CMP_BRIDGES, torch.float64,
                            n_steps=VI_CMP_STEPS, n_inner=SF_CMP_INNER)
        _require(bool(torch.equal(sampled.position, states.position)),
                 f"phase 23 f64 schrodinger_follmer: sample is not its steps on {where}")
        runs[where] = history
    worst = max(_relative(a, b) for (card, cpu) in zip(runs[dev], runs["cpu"])
                for a, b in zip(card[0] + card[1], cpu[0] + cpu[1]))
    _require(worst <= VI_CMP_TOL, f"phase 23 f64 schrodinger_follmer: a step parts by {worst}")
    words.append(f"schrodinger_follmer {SF_CMP_BRIDGES} bridges x {VI_CMP_STEPS} steps of "
                 f"{SF_CMP_INNER} inner draws (positions, times, drifts; sample is its steps) "
                 f"within {worst:.3g}")
    return "; ".join(words) + f" (relative to max(|x|, 1), tolerance {VI_CMP_TOL})"


def _timed_run(torch, fn):
    """``fn()`` timed by the host clock (after a device sync) and CUDA
    events: its result, seconds and milliseconds."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


def vi_path(torch, dev, smi):
    """Phase 23: the rest of ``vi/`` on config #5's target on the card, its
    gates and the f64 hold (see the head of this file). Returns the
    threefry and normal launches of the timed runs."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.models import ill_conditioned_gaussian
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    target = ill_conditioned_gaussian(VI_D)
    std = torch.tensor(target.std, dtype=torch.float64)
    keys = prng.split(prng.key(VI_SEED, dev), VI_KEYS)
    start = prng.normal(prng.key(19, dev), (SVGD_PARTICLES, VI_D), torch.float32)
    f32 = torch.float32
    runs = {
        "meanfield_vi": lambda key, steps: vi_gaussian_run(torch, target, "meanfield_vi", key,
                                                           steps, f32),
        "fullrank_vi": lambda key, steps: vi_gaussian_run(torch, target, "fullrank_vi", key,
                                                          steps, f32),
        "svgd": lambda key, steps: vi_svgd_run(torch, target, start, steps),
        "schrodinger_follmer": lambda key, steps: vi_sf_run(torch, target, key, SF_BRIDGES, f32,
                                                            n_steps=steps),
    }
    parts, lines = {}, {}
    # warm runs (kernels, the allocator, the target's constants), then the
    # host syncs of a short run in CUDA's sync debug mode and the busy share
    # of 8 steps rerun under the profiler
    syncs, busy = {}, {}
    for name, run in runs.items():
        steps = 3 if name == "schrodinger_follmer" else VI_SYNC_STEPS
        t_part = time.perf_counter()
        run(keys[1], 2)
        parts[f"{name} warm run"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        _, stacks = _host_syncs(torch, lambda: run(keys[1], steps))
        frame = VI_STEP_FRAMES[name]
        syncs[name] = (sum(frame in stack for stack in stacks), len(stacks), steps,
                       sorted({stack[-1] for stack in stacks}))
        _require(syncs[name][0] == 0,
                 f"phase 23 {name}: {syncs[name][0]} host syncs in {steps} steps")
        busy[name] = _device_busy(torch, lambda: run(keys[1], VI_BUSY_STEPS))
        parts[f"{name} sync and busy runs"] = time.perf_counter() - t_part

    launches23 = {k: 0 for k in PRNG_KERNELS}
    for name in runs:
        for i in range(VI_KEYS if name != "svgd" else 1):
            for k in dc.LAUNCHES:
                dc.LAUNCHES[k] = 0
            if name in VI_GAUSSIAN:
                steps = VI_GAUSSIAN[name][1] if i == 0 else VI_GAUSSIAN_CUT_STEPS
                (state, info, _), secs, ms = _timed_run(torch, lambda: runs[name](keys[i], steps))
                card, finite = _on_card(torch, (state, info))
                summary = vi_gaussian_summary(torch, name, state, info, std)
                checks = [(f"key {i}", summary, VI_REFERENCE[name if i == 0 else f"{name}_cut"])]
                rate = VI_NUM_SAMPLES * steps / secs
                rate_words = f"{rate:.6g} gradient evaluations/sec ({VI_NUM_SAMPLES} draws a step)"
            elif name == "svgd":
                steps = SVGD_STEPS
                (cut, _), cut_secs, cut_ms = _timed_run(
                    torch, lambda: runs[name](None, SVGD_CUT_STEPS))
                cut_summary = vi_particle_summary(torch, cut.particles, std)
                (state, _), rest_secs, rest_ms = _timed_run(torch, lambda: vi_svgd_run(
                    torch, target, start, steps - SVGD_CUT_STEPS, state=cut))
                secs, ms = cut_secs + rest_secs, cut_ms + rest_ms
                card, finite = _on_card(torch, (state.particles,
                                                state.kernel_parameters["length_scale"]))
                summary = vi_particle_summary(torch, state.particles, std)
                checks = [(f"at step {SVGD_CUT_STEPS}", cut_summary, VI_REFERENCE["svgd_cut"]),
                          (f"at step {steps}", summary, VI_REFERENCE["svgd"])]
                summary = {**{f"{k} at {SVGD_CUT_STEPS}": v for k, v in cut_summary.items()},
                           **summary}
                rate = SVGD_PARTICLES * steps / secs
                rate_words = (f"{rate:.6g} particle-steps/sec, length scale "
                              f"{float(state.kernel_parameters['length_scale']):.5f}")
            else:
                steps = SF_STEPS
                state, secs, ms = _timed_run(torch, lambda: runs[name](keys[i], steps))
                card, finite = _on_card(torch, state)
                summary = vi_particle_summary(torch, state.position, std)
                checks = [(f"key {i}", summary, VI_REFERENCE[name])]
                rate = SF_BRIDGES * steps / secs
                rate_words = (f"{rate:.6g} bridge-steps/sec ({SF_BRIDGES * SF_INNER * steps / secs:.6g}"
                              f" inner log-density evaluations/sec)")
            _require(card and finite, f"phase 23 {name} key {i}: a tensor off the card or not "
                                      f"finite")
            for label, values, bands in checks:
                _vi_gates(f"{name} {label}", values, bands)
            counts = {k: dc.LAUNCHES[k] for k in PRNG_KERNELS}
            for k in PRNG_KERNELS:
                launches23[k] += counts[k]
            parts[f"{name} key {i}"] = secs
            lines.setdefault(name, []).append(
                ("the run" if name == "svgd" else f"key {i}") + f": {steps} steps {secs:.3f} s by host clock ({ms:.1f} ms by CUDA "
                f"events), {secs / steps * 1e3:.3f} host ms a step, {steps / secs:.6g} steps/sec, "
                f"{rate_words}; threefry launches {counts['threefry2x32']} "
                f"({counts['threefry2x32'] / steps:.2f} a step), normal launches "
                f"{counts['normal']} ({counts['normal'] / steps:.2f} a step); " + ", ".join(
                    f"{k} {v:.6g}" for k, v in summary.items()))
            del state
    torch.cuda.empty_cache()
    bands = {name: ", ".join(f"{k} {v[0]:.6g} +- {v[1]:.3g}" for k, v in reference.items())
             for name, reference in VI_REFERENCE.items()}
    settings = {
        "meanfield_vi": f"adam({VI_GAUSSIAN['meanfield_vi'][0]}), num_samples={VI_NUM_SAMPLES}, "
                        f"from zeros, on split(key({VI_SEED}), {VI_KEYS})",
        "fullrank_vi": f"adam({VI_GAUSSIAN['fullrank_vi'][0]}), num_samples={VI_NUM_SAMPLES}, "
                       f"from zeros ({VI_D * (VI_D + 1) // 2} Cholesky parameters), on "
                       f"split(key({VI_SEED}), {VI_KEYS})",
        "svgd": f"sgd({SVGD_RATE} x {SVGD_PARTICLES}), the median heuristic over "
                f"{SVGD_PARTICLES * (SVGD_PARTICLES - 1) // 2} distances a step, "
                f"{SVGD_PARTICLES} particles from config #5's start normal(key(19))",
        "schrodinger_follmer": f"n_steps={SF_STEPS}, n_inner_samples={SF_INNER}, {SF_BRIDGES} "
                               f"bridges ({SF_BRIDGES * SF_INNER * VI_D * 4 / 1e6:.0f} MB of "
                               f"inner draws a step), on split(key({VI_SEED}), {VI_KEYS})",
    }
    for name in runs:
        b = busy[name]
        busy_words = "not measured (no device record)" if b is None else (
            f"{b[0]:.3f} ms of device records ({b[1]}) in {b[2]:.3f} ms: busy {b[0] / b[2]:.4f}")
        in_step, total, steps, where = syncs[name]
        cut = {"svgd": f"; at step {SVGD_CUT_STEPS}: {bands.get('svgd_cut')}",
               "meanfield_vi": f"; keys 1-2 at {VI_GAUSSIAN_CUT_STEPS} steps: "
                               f"{bands.get('meanfield_vi_cut')}",
               "fullrank_vi": f"; keys 1-2 at {VI_GAUSSIAN_CUT_STEPS} steps: "
                              f"{bands.get('fullrank_vi_cut')}"}.get(name, "")
        print(f"phase 23 {name} on ill_conditioned_gaussian({VI_D}) (benchmarks/tracked.py:"
              f"744-788), f32, {settings[name]}: " + "; ".join(lines[name])
              + f"; host syncs {in_step} in the steps of a {steps}-step warm run ({total} in the "
              f"run, at {where}); device {busy_words} ({VI_BUSY_STEPS} steps rerun); the JAX "
              f"package's bands (tools/vi_reference.py): {bands[name]}{cut} ({smi})")
    t_part = time.perf_counter()
    print(f"phase 23 f64 hold, the card against the port on the CPU at d = {VI_D}, "
          f"key({VI_CMP_SEED}): " + vi_holds(torch, dev) + f" ({smi})")
    parts["f64 hold"] = time.perf_counter() - t_part
    print("phase 23 host seconds by part: "
          + ", ".join(f"{name} {secs:.1f}" for name, secs in parts.items()))
    return launches23


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
    tf_dev_ms = _device_ms(torch, lambda: prng.threefry2x32(*keyed_dev), "threefry_kernel")
    tf_bound = _bound(TF_KEYS * THREEFRY_BYTES, 0.0, peaks, TF_KEYS * THREEFRY_OPS,
                      d=1)  # no FP32 work
    # jax.random.normal's transform of the threefry words (prng.normal's
    # kernel) against its plain version on the card, and against the port on
    # the CPU (float32 the same bits; float64 through CUDA's log)
    normal_words = prng._words(prng.key(SEED, dev), (TF_KEYS,))
    normal_cpu_words = [w.cpu() for w in normal_words]
    normal_words_line, normal_err = [], 0.0
    for dt in (torch.float32, torch.float64):
        kern_n = dc.normal_device(*normal_words, dt)
        plain_n = prng.normal_from_words(*normal_words, dt)
        normal_err = max(normal_err, float((kern_n - plain_n).abs().max()))
        _require(torch.equal(kern_n, plain_n), f"normal kernel != its plain version in {dt}")
        ib = torch.int32 if dt == torch.float32 else torch.int64
        ulps = (kern_n.cpu().view(ib).long()
                - prng.normal_from_words(*normal_cpu_words, dt).view(ib).long()).abs()
        differ = int((ulps > 0).sum())
        _require(dt == torch.float64 or differ == 0,
                 f"the normal kernel's float32 draws differ from the CPU's on {differ}")
        normal_words_line.append(f"{str(dt).split('.')[-1]}: bit for bit its plain version on "
                                 f"the card, {differ} of {TF_KEYS} apart from the port on the "
                                 f"CPU (at most {int(ulps.max())} ulps)")
    normal_ms = _timed_mean(torch, lambda: dc.normal_device(*normal_words, torch.float32), 20)
    normal_plain_ms = _timed_mean(
        torch, lambda: prng.normal_from_words(*normal_words, torch.float32), 5)
    normal_dev_ms = _device_ms(torch, lambda: dc.normal_device(*normal_words, torch.float32),
                               "normal_kernel")
    normal_bound = _bound(TF_KEYS * NORMAL_BYTES, TF_KEYS * NORMAL_OPS["fp32"], peaks,
                          TF_KEYS * NORMAL_OPS["int32"], TF_KEYS * NORMAL_OPS["sfu"], d=1)
    print(f"phase 2: the normal kernel (prng.normal's transform of {TF_KEYS} threefry words): "
          f"{'; '.join(normal_words_line)}; float32 kernel {_ms_words(normal_dev_ms)} by "
          f"torch.profiler (a call {normal_ms:.4f} ms by CUDA events over 20 back-to-back "
          f"calls), plain (torch ops on the card) {normal_plain_ms:.4f} ms, bound "
          f"{normal_bound[0]:.4f} ms by {normal_bound[1]} ({smi})")
    print(f"phase 2: threefry2x32 device function equals the plain version bit for bit "
          f"on {c0.numel()} counters: {same}; with a key per element on {TF_KEYS} keys "
          f"(prng's draws): bit for bit {keyed_same}, kernel {_ms_words(tf_dev_ms)} by "
          f"torch.profiler (a call {tf_ms:.4f} ms by CUDA events over 20 back-to-back calls "
          f"that keep their outputs: paced by the host and the allocator), plain (int64 torch "
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
    # phase 4's initial positions a few dozen transitions leave log_tau's second half
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
    path16 = smc_path(torch, dev, smi)

    # ---- phase 17: the MCMC family beyond NUTS, the tracked static-HMC config ----
    marks.append((17, time.perf_counter()))
    path17, transitions17 = family_path(torch, dev, smi)

    # ---- phase 18: the tracked SG-MCMC configurations ----
    marks.append((18, time.perf_counter()))
    path18 = sgmcmc_path(torch, dev, smi)

    # ---- phase 19: persistent sampling, pretuning and nested slice sampling ----
    marks.append((19, time.perf_counter()))
    path19 = particle_path(torch, dev, peaks, smi)

    # ---- phase 20: the tracked cross-chain ChEES configuration ----
    marks.append((20, time.perf_counter()))
    path20 = chees_path(torch, dev, smi)

    # ---- phase 21: the tracked MEADS configuration ----
    marks.append((21, time.perf_counter()))
    path21 = meads_path(torch, dev, smi)

    # ---- phase 22: Pathfinder on config #5's target and start ----
    marks.append((22, time.perf_counter()))
    path22 = pathfinder_path(torch, dev, smi)

    # ---- phase 23: the rest of vi/ on config #5's target ----
    marks.append((23, time.perf_counter()))
    path23 = vi_path(torch, dev, smi)

    marks.append((None, time.perf_counter()))
    print("wall seconds per phase (host clock): " + ", ".join(
        f"{a}: {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(marks, marks[1:])))

    # the threefry and normal kernels' launches on every path that draws
    path_launches = {k: sum(p[k] for p in (launches12, path16, path17, path18, path19, path20,
                                           path21, path22, path23))
                     for k in PRNG_KERNELS}
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
                          path_launches["threefry2x32"],
                          tf_err, tf_ms if tf_dev_ms is None else tf_dev_ms, tf_plain_ms,
                          tf_bound))
    kernels.append(_entry("normal (jax.random.normal's transform of the threefry words)",
                          "fused_nuts_dc.cu", "blackjax_tpu/util.py:64", path_launches["normal"],
                          normal_err, normal_ms if normal_dev_ms is None else normal_dev_ms,
                          normal_plain_ms, normal_bound))
    kernels.append(_entry("vpu_peak (unfused fma)", "vpu_peak.cu", "benchmarks/vpu_peak.py:58",
                          vpu["launches"], vpu["err"], vpu["ms"], vpu["plain_ms"], vpu["bound"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
