"""The dc machine's resident form of the analytic targets, on the CPU: the
wrapper's plan (form by width and metric, shared memory, the scratch in
device memory) and what the CPU path counts. No kernel is built or launched
here.

``shared_memory_plan`` and ``scratch_floats`` mirror ``block_bytes_for`` and
``scratch_floats_for`` in ``csrc/fused_nuts_dc.cuh``;
``tests/test_torch_cuda.py`` holds them against the kernel's exports on the
card, and the resident form against its plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackjax_tpu_torch.ops import fused_nuts_dc as dc  # noqa: E402

ANALYTIC = (dc._CUDA_HIERARCHICAL, dc._CUDA_GAUSSIAN)
SM_SHARED, RESERVED = 233_472, 1_024  # an SM's shared memory, a block's reserve


@pytest.mark.parametrize("d, max_depth, shared", [
    (100, 8, True), (100, 11, False),  # N = 4 at 20 warps an SM
    (8, 10, True), (50, 8, True),  # N = 1 and 2 at 24
    (200, 5, True), (200, 8, False),  # N = 8 at 16
])
@pytest.mark.parametrize("family", ANALYTIC)
def test_resident_form_keeps_slots_in_shared_memory_where_they_fit(family, d, max_depth,
                                                                    shared):
    """The diagonal metric's resident form: each warp's slots (2 x
    max_depth vectors) and the subtree's sample (x and g) in shared memory
    where the SM's resident warps, in blocks of kResidentBlockWarps, fit
    them beside each block's reserve; else in device memory beside the
    thirteen cold vectors."""
    n = dc._register_width(d)
    vec, per_block = 32 * n, dc._RESIDENT_BLOCK_WARPS
    floats = 2 * vec + 2 * max_depth * vec
    blocks = dc.resident_warps(n) // per_block
    assert (blocks * (4 * per_block * floats + RESERVED) <= SM_SHARED) == shared
    plan = dc.shared_memory_plan(n, family, "diag", max_depth)
    assert plan == dc.SharedMemoryPlan(None, 4 * per_block * floats if shared else 0, False,
                                       True)
    assert plan.form == 1
    assert dc.scratch_floats(plan, n, "diag", max_depth) == (
        13 * vec, 0 if shared else 2 * max_depth * vec)


@pytest.mark.parametrize("d", [1, 32, 33, 64, 100, 128, 129, 200, 256])
@pytest.mark.parametrize("family", ANALYTIC)
def test_diagonal_metric_takes_the_resident_form_up_to_d256(family, d):
    plan = dc.shared_memory_plan(dc._register_width(d), family, "diag", 8)
    assert plan.resident and plan.x_form is None and not plan.metric_shared


@pytest.mark.parametrize("metric", ["dense", "low_rank"])
@pytest.mark.parametrize("d", [4, 100, 200])
def test_rich_metrics_follow_the_measured_widths(metric, d):
    """The dense and low-rank metrics take the resident form only at the
    widths where it measured no slower (RESIDENT_WIDTHS); elsewhere four
    warps a block keep their slots, w and a staging vector in shared
    memory."""
    n = dc._register_width(d)
    plan = dc.shared_memory_plan(n, dc._CUDA_GAUSSIAN, metric, 8)
    assert plan.resident == (n in dc.RESIDENT_WIDTHS[metric])
    if not plan.resident:
        assert plan == dc.SharedMemoryPlan(None, 4 * 4 * (3 * 8 + 1) * n * 32)
        assert dc.scratch_floats(plan, n, metric, 8) == (0, 0)


@pytest.mark.parametrize("d, max_depth", [(257, 8), (404, 10), (512, 6)])
def test_wide_analytic_targets_keep_the_registers_form(d, max_depth):
    """From N = 13 (the diagonal metric only) each of four warps keeps its
    checkpoint slots in shared memory, as before the resident form, and ten
    cold vectors in device memory."""
    n = dc._register_width(d)
    plan = dc.shared_memory_plan(n, dc._CUDA_HIERARCHICAL, "diag", max_depth)
    assert plan == dc.SharedMemoryPlan(None, 4 * 4 * 2 * max_depth * n * 32)
    assert plan.form == 0
    assert dc.scratch_floats(plan, n, "diag", max_depth) == (10 * n * 32, 0)


def test_flagship_layout():
    """The flagship (d = 100, N = 4, max_depth 8): 20 warps an SM, one a
    block, each with 9,216 B of shared memory, and 6,656 B of cold state a
    chain (27 MB for 4,096 chains, which stays in L2)."""
    plan = dc.shared_memory_plan(4, dc._CUDA_HIERARCHICAL, "diag", 8)
    assert dc.resident_warps(4) == 20 and dc._RESIDENT_BLOCK_WARPS == 1
    assert plan.nbytes == 9_216 and 20 * (plan.nbytes + RESERVED) <= SM_SHARED
    cold, slots = dc.scratch_floats(plan, 4, "diag", 8)
    assert (4 * cold, slots) == (6_656, 0)
    assert 4 * cold * 4_096 < 50e6


@pytest.mark.parametrize("n, warps", [(1, 24), (2, 24), (4, 20), (8, 16)])
def test_resident_launch_bound_by_width(n, warps):
    """The warps an SM each width's instantiation is built for."""
    assert dc.resident_warps(n) == warps


@pytest.mark.parametrize("family, d, metric, max_depth, rows, cols, slots", [
    (dc._CUDA_HORSESHOE, 404, "diag", 10, 100, 200, 0),
    (dc._CUDA_EIGHT_SCHOOLS, 10, "diag", 8, 0, 0, 0),
    (dc._CUDA_LOGREG, 54, "dense", 8, 4096, 54, 3 * 8 * 64),
    (dc._CUDA_LOGREG, 12, "diag", 6, 24, 12, 2 * 6 * 32),
])
def test_other_forms_keep_their_scratch(family, d, metric, max_depth, rows, cols, slots):
    """The other forms' scratch in device memory is as before: ten cold
    vectors from N = 13, the tiles form's slots."""
    n = dc._register_width(d)
    plan = dc.shared_memory_plan(n, family, metric, max_depth, rows, cols)
    assert not plan.resident
    assert dc.scratch_floats(plan, n, metric, max_depth) == (
        10 * n * 32 if n >= 13 else 0, slots)


@pytest.mark.parametrize("x_form, resident, form", [
    ("shared", False, 1), ("l2", False, 0), ("tiles", False, 0), (None, True, 1),
    (None, False, 0),
])
def test_form_argument(x_form, resident, form):
    """The kernel's form argument: 1 for the horseshoe's X in shared memory
    and for the resident form."""
    assert dc.SharedMemoryPlan(x_form, 0, False, resident).form == form


def test_cpu_tensors_count_no_launch():
    """The CPU path runs the plain version and counts no form."""
    x = torch.from_numpy((0.5 * np.random.default_rng(0).standard_normal((4, 8)))
                         .astype(np.float32))
    before = dict(dc.LAUNCHES)
    out = dc.fused_nuts_run_dc(x, torch.ones(8), 0.2, target=dc.make_hierarchical_target_dc(8),
                               num_steps=2, num_track=2, seed=1)
    assert dc.LAUNCHES == before
    assert out[0].shape == (4, 8) and bool((out[3] == 2).all())
