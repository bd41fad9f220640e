"""The dc machine's tiles form (logistic regression: the chains of a block in
lockstep, sharing tiles of X streamed through shared memory), on the CPU: its
shared-memory plan, X's layout in tiles, the lockstep's idle share, and the
CPU run of logistic regression against the Pallas kernel in interpret mode.
No kernel is built or launched here; ``tests/test_torch_cuda.py`` holds the
kernel against its plain version and the plan against the kernel's own byte
count on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import fused_nuts_dc as ref  # noqa: E402
from blackjax_tpu.ops import targets_dc as ref_dc  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as dc  # noqa: E402
from test_torch_fused_nuts_dc import reference_at_opt0  # noqa: E402

LIMIT = 232_448  # a Hopper block's shared memory
K = 8  # chains a block of the tiles form (kChainsLR)


def _tiles_bytes(d, metric, rank=0):
    """The tiles form's block, counted from its parts: the ring of two tiles
    of R rows at a row stride of 4 mod 8 floats (or the backward pass's
    partial sums, if larger), the (cols rounded to 4) x K positions, the R x
    K sigmoids, a staging vector a warp for the dense and low-rank metrics;
    and whether the metric's matrices fit beside them."""
    n = dc._register_width(d)
    R = {1: 256, 2: 256, 4: 128, 8: 64}[n]
    stride = -(-d // 4) * 4
    stride += 4 if stride % 8 == 0 else 0
    back = min(16 // n, K) * K * 32 * n
    floats = max(2 * R * stride, back) + -(-d // 4) * 4 * K + R * K
    floats += 0 if metric == "diag" else K * 32 * n
    matrices = {"diag": 0, "dense": 2 * d * d, "low_rank": d * rank + 2 * rank}[metric]
    shared = matrices > 0 and 4 * (floats + matrices) <= LIMIT
    return 4 * (floats + (matrices if shared else 0)), shared


@pytest.mark.parametrize("max_depth", [6, 8, 10])
@pytest.mark.parametrize("metric, rank", [("diag", 0), ("dense", 0), ("low_rank", 10)])
@pytest.mark.parametrize("d, rows", [(12, 24), (54, 4096), (256, 300)])
def test_logistic_regression_takes_the_tiles_form(d, rows, metric, rank, max_depth):
    """Every logistic-regression launch takes the tiles form, and its block
    fits in a Hopper block's shared memory up to d = 256 and max_depth 10:
    the slots live in device memory, so the bytes do not grow with
    max_depth, and the metric's matrices go to shared memory where they
    fit (all but the dense 256 x 256 pair)."""
    plan = dc.shared_memory_plan(dc._register_width(d), dc._CUDA_LOGREG, metric, max_depth,
                                 rows, d, rank)
    nbytes, shared = _tiles_bytes(d, metric, rank)
    assert plan == dc.SharedMemoryPlan("tiles", nbytes, shared)
    assert plan.nbytes <= LIMIT
    assert plan.metric_shared == (metric != "diag" and not (metric == "dense" and d == 256))


def test_phase_11_block_holds_the_dense_metric():
    """4,096 x 54 with the dense metric: the ring of two 256-row tiles at a
    stride of 60 floats (122,880 B), the positions and sigmoids (1,792 and
    8,192 B), eight staging vectors (2,048 B) and M^{-1} and C^T (23,328 B)."""
    plan = dc.shared_memory_plan(2, dc._CUDA_LOGREG, "dense", 8, 4096, 54)
    assert plan == dc.SharedMemoryPlan("tiles", 122_880 + 1_792 + 8_192 + 2_048 + 23_328, True)


@pytest.mark.parametrize("family, d, metric, max_depth, rows, cols, x_form", [
    (dc._CUDA_HORSESHOE, 404, "diag", 10, 100, 200, "shared"),
    (dc._CUDA_HORSESHOE, 404, "diag", 10, 400, 200, "l2"),
    (dc._CUDA_HORSESHOE, 36, "dense", 6, 12, 16, "shared"),
    (dc._CUDA_HORSESHOE, 36, "low_rank", 6, 12, 16, "shared"),
    (dc._CUDA_EIGHT_SCHOOLS, 10, "dense", 8, 0, 0, None),
    (dc._CUDA_HIERARCHICAL, 100, "dense", 8, 0, 0, None),  # low-rank: the resident form
    (dc._CUDA_GAUSSIAN, 4, "dense", 5, 0, 0, None),
])
def test_other_targets_keep_their_form_and_bytes(family, d, metric, max_depth, rows, cols,
                                                 x_form):
    """Four warps a block, each with its checkpoint slots (m and msum; w and
    a staging vector besides for the dense and low-rank metrics) and its
    target's scratch, X beside them in the horseshoe's shared form: the
    layout of the parent tree."""
    n = dc._register_width(d)
    vec = 32 * n
    slots = 2 * max_depth * vec if metric == "diag" else (3 * max_depth + 1) * vec
    scratch = {dc._CUDA_HORSESHOE: 2 * vec + 16 * n,
               dc._CUDA_EIGHT_SCHOOLS: 3 * vec + 32}.get(family, 0)
    nbytes = 16 * (slots + scratch)
    if x_form == "shared":
        nbytes += 4 * rows * ((-(-cols // 4) * 4) | 4)
    plan = dc.shared_memory_plan(n, family, metric, max_depth, rows, cols, rank=4)
    assert plan == dc.SharedMemoryPlan(x_form, nbytes, False)


@pytest.mark.parametrize("rows, cols, tile_rows, stride", [
    (24, 12, 256, 12), (4096, 54, 256, 60), (300, 256, 64, 260), (1, 3, 256, 4),
])
def test_x_is_laid_out_in_whole_tiles(rows, cols, tile_rows, stride):
    """X as the tiles form copies it: every tile one contiguous run of
    16-byte words, rows padded with zeros to a whole tile and columns to the
    stride, so that no copy reads past the array and pad rows add nothing to
    the backward pass."""
    X = np.random.default_rng(rows).standard_normal((rows, cols)).astype(np.float32)
    assert dc._lr_tile_rows(dc._register_width(cols)) == tile_rows
    tiles = dc._lr_tiles(X, tile_rows)
    assert tiles.shape == (-(-rows // tile_rows) * tile_rows, stride)
    assert tiles.dtype == np.float32 and tiles.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(tiles[:rows, :cols], X)
    assert not tiles[rows:].any() and not tiles[:, cols:].any()
    assert (tile_rows * stride) % 4 == 0


def test_the_tiles_upload_leaves_the_fused_kernels_x_as_it_was():
    """The dc machine's logistic regression uploads X as tiles and no X^T;
    the per-warp form of the fused targets' logistic regression (the same
    target id; the older NUTS machine takes it) still gets both orientations
    of X from the shared upload."""
    import importlib

    from blackjax_tpu_torch.ops import targets_dc

    X = np.random.default_rng(0).standard_normal((23, 12)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    cpu = torch.device("cpu")
    target = targets_dc.make_logreg_target_dc(X, y)
    tiles, Xt, u, s = dc._lr_tiles_on(target, cpu, 256)
    assert Xt is None and s is None and tiles.shape == (256, 12)
    np.testing.assert_array_equal(tiles[:24].numpy(), target.matrix.X)
    np.testing.assert_array_equal(u.numpy(), target.matrix.u)
    fused = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
    lr = fused.make_logistic_regression_target(X, y)
    assert lr.cuda_target == dc._CUDA_LOGREG
    Xf, Xft, _, _ = dc._matrix_on(lr, cpu)
    assert Xf.shape == (23, 12) and torch.equal(Xft, Xf.t())


@pytest.mark.parametrize("steps, iters, budget, expected", [
    # one block of eight: chains live for 10, 10, ..., 2 iterations of 10
    ([4] * 8, [10, 10, 10, 10, 6, 6, 2, 2], 64, 1 - 56 / 80),
    # a chain short of num_steps was live for its whole budget
    ([4] * 7 + [3], [5] * 7 + [9], 20, 1 - (35 + 20) / 160),
    # per-chain budgets, and a partial last block whose absent warps idle
    ([4] * 9, [8] * 9, torch.full((9,), 30), 1 - 72 / 128),
    ([4] * 8, [7] * 8, 64, 0.0),
])
def test_lockstep_idle_share(steps, iters, budget, expected):
    share = dc.lockstep_idle_share(torch.tensor(steps, dtype=torch.int32),
                                   torch.tensor(iters, dtype=torch.int32), 4, budget)
    assert share == pytest.approx(expected, abs=1e-12)


def _logreg_data(n, d):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


# 13 chains (a block of eight and a partial one on the card), restarts gated
# to every second leaf, and a budget that cuts some chains short
PACKED = dict(num_steps=4, max_num_doublings=4, seed=11, chunk=8, pack=4, restart_every=2,
              budget=48)


@pytest.fixture(scope="module")
def packed_logreg():
    d = 12
    ref_target = ref_dc.make_logreg_target_dc(*_logreg_data(23, d))
    x0 = (0.5 * np.random.default_rng(3).standard_normal((13, d))).astype(np.float32)
    out_ref = reference_at_opt0(
        ref.fused_nuts_run_dc, jnp.asarray(x0), jnp.ones(d), step_size=0.3, target=ref_target,
        num_track=d, interpret=True, **PACKED)
    target = interop.target_dc(ref_target.name, d, ref_target.params)
    before = dict(dc.LAUNCHES)
    out_port = dc.fused_nuts_run_dc(torch.from_numpy(x0), torch.ones(d), 0.3, target=target,
                                    num_track=d, **PACKED)
    assert dc.LAUNCHES == before, "a CPU call must not count a kernel launch"
    return out_ref, out_port


def test_cpu_logistic_regression_steps_and_grads_match_the_reference(packed_logreg):
    """Steps (some cut short by the lane budget) and gradient totals are the
    Pallas kernel's."""
    out_ref, out_port = packed_logreg
    steps = out_port[3].numpy()
    np.testing.assert_array_equal(steps, np.asarray(out_ref[3]))
    assert steps.min() < PACKED["num_steps"] and steps.max() == PACKED["num_steps"]
    assert float(out_port[2]) == float(out_ref[2])


def test_cpu_logistic_regression_chains_match_the_reference(packed_logreg):
    """Chain by chain to 1e-5, as tests/test_torch_fused_nuts_dc.py holds
    the plain version (floor 0.9)."""
    out_ref, out_port = packed_logreg
    close = np.isclose(out_port[0].numpy(), np.asarray(out_ref[0]), rtol=1e-5, atol=1e-5).all(1)
    close &= np.isclose(out_port[1].numpy(), np.asarray(out_ref[1]),
                        rtol=1e-5, atol=1e-5).all(axis=(1, 2))
    assert close.mean() >= 0.9
