"""The CUDA kernel of the port against its plain PyTorch version, on the card.

Needs an NVIDIA GPU and nvcc: every test is marked ``gpu`` and skips
without a card (decided in the fixture, at run time). This file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Kernel and plain version draw the same counter-based numbers and round
alike except for the order of their sums, so they are held chain by chain
as the CPU test holds the plain version against the Pallas kernel.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix  # noqa: E402
from blackjax_tpu_torch.ops import counter_rng  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as dc  # noqa: E402
from blackjax_tpu_torch.ops import targets_dc  # noqa: E402
from blackjax_tpu_torch.ops.fused_hmc import fused_hmc  # noqa: E402

# `ops.fused_leapfrog` and `ops.fused_mclmc` are functions; the modules come
# from importlib
fl = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")

pytestmark = pytest.mark.gpu

AGREE_FLOOR = 0.9  # as tests/test_torch_fused_nuts_dc.py
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "d, C, S, target",
    [
        (8, 64, 8, dc.make_hierarchical_target_dc(8)),
        (4, 64, 8, dc.make_gaussian_target_dc(4, [1.0, 4.0, 0.25, 2.0])),
        (100, 256, 8, dc.make_hierarchical_target_dc(100)),
        (200, 64, 4, dc.make_hierarchical_target_dc(200)),
        # N = 13: the trajectory's ends and the proposal in device memory
        (404, 64, 4, dc.make_hierarchical_target_dc(404)),
    ],
)
def test_kernel_matches_plain_version(cuda, d, C, S, target):
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(d).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda)
    kw = dict(target=target, num_steps=S, max_num_doublings=6, seed=7,
              num_track=min(d, 8), budget=2**6 * S)
    before = dc.LAUNCHES["fused_nuts_dc"]
    kern = dc.fused_nuts_run_dc(x, imm, 0.2, **kw)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["fused_nuts_dc"] == before + 1
    plain = dc.fused_nuts_run_dc_plain(x, imm, 0.2, **kw)
    assert torch.equal(kern[3], plain[3])
    close = torch.isclose(kern[0], plain[0], rtol=TOL, atol=TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=TOL, atol=TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


def test_budget_exhaustion_leaves_zero_rows(cuda):
    d, C, S = 8, 32, 8
    x = torch.zeros(C, d, device=cuda)
    fx, hist, _, steps = dc.fused_nuts_run_dc(
        x, torch.ones(d, device=cuda), 0.2, target=dc.make_hierarchical_target_dc(d),
        num_steps=S, num_track=4, seed=3, budget=8, chunk=8,
    )
    steps = steps.cpu()
    assert int(steps.max()) < S
    h = hist.cpu()
    for c in range(C):
        assert (h[c, int(steps[c]):] == 0).all()


def test_threefry_device_function_bit_for_bit(cuda):
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (2, 10_000), dtype=np.uint64).astype(np.int64)
    c0, c1 = torch.from_numpy(words[0]), torch.from_numpy(words[1])
    on_card = dc.threefry2x32_device(5, counter_rng.KEY1, c0.to(cuda), c1.to(cuda))
    plain = counter_rng.threefry2x32(5, counter_rng.KEY1, c0, c1)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, plain))


def _logreg_data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


MATRIX_CASES = {
    "logreg_23x12": (lambda: targets_dc.make_logreg_target_dc(*_logreg_data(23, 12)), 0.3, 0.5),
    "logreg_4096x54": (lambda: targets_dc.make_logreg_target_dc(*_logreg_data(4096, 54)),
                       0.01, 0.05),
    "horseshoe_12x16": (lambda: targets_dc.make_finnish_horseshoe_target_dc(12, 16), 0.05, 0.1),
    # unadapted at full width: a larger step diverges at the first leaf
    "horseshoe_100x200": (lambda: targets_dc.make_finnish_horseshoe_target_dc(), 1e-3, 0.05),
    "eight_schools": (targets_dc.make_eight_schools_target_dc, 0.2, 0.5),
}


# The kernel sums each contraction row by row, the plain version's cuBLAS in
# tiles: the difference grows along the trajectory to ~1.5e-4 after 4
# transitions (logistic regression at 23 x 12 and the horseshoe at 12 x 16),
# as it does between the plain version on the card and on the CPU (measured:
# 0.81 and 0.86 of chains agree to 1e-5 there). Steps and gradient totals
# stay identical: no accept or U-turn decision flips.
MATRIX_TOL = 1e-3


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_matrix_target_kernel_matches_plain_version(cuda, case):
    make, step_size, scale = MATRIX_CASES[case]
    target = make()
    d, C, S = target.dim, 64, 4
    x = torch.from_numpy(
        (scale * np.random.default_rng(d).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda)
    kw = dict(target=target, num_steps=S, max_num_doublings=6, seed=7, num_track=d,
              budget=2**6 * S)
    before = dc.LAUNCHES["fused_nuts_dc"]
    kern = dc.fused_nuts_run_dc(x, imm, step_size, **kw)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["fused_nuts_dc"] == before + 1
    plain = dc.fused_nuts_run_dc_plain(x, imm, step_size, **kw)
    assert torch.equal(kern[3], plain[3]) and bool((kern[3] == S).all())
    assert float(kern[2]) == float(plain[2]) > C * S  # trees of more than one leaf
    assert torch.isfinite(kern[0]).all() and torch.isfinite(kern[1]).all()
    close = torch.isclose(kern[0], plain[0], rtol=MATRIX_TOL, atol=MATRIX_TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=MATRIX_TOL, atol=MATRIX_TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


# the horseshoe's two forms, each where the byte count picks it: X copied
# into shared memory (100 x 200; 37 x 48, whose rows leave a partial chunk of
# 32 and whose stride is 49), or read from L2 where it cannot fit (400 x 200)
HORSESHOE_FORMS = {"100x200": (100, 200, "shared"), "37x48": (37, 48, "shared"),
                   "400x200": (400, 200, "l2")}


@pytest.mark.parametrize("case", sorted(HORSESHOE_FORMS))
def test_horseshoe_forms_match_plain_version(cuda, case):
    """Each form against the plain version chain by chain: identical steps,
    the floor's share at MATRIX_TOL, and identical gradient counts on every
    chain that agrees; the launch counts under the form it took."""
    rows, cols, form = HORSESHOE_FORMS[case]
    target = targets_dc.make_finnish_horseshoe_target_dc(rows, cols)
    d, C, S = target.dim, 64, 4
    x = torch.from_numpy(
        (0.05 * np.random.default_rng(d).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    kw = dict(target=target, num_steps=S, max_num_doublings=6, seed=7, num_track=d,
              budget=2**6 * S)
    x32, metric, machine = dc._prepare(x, torch.ones(d, device=cuda), **kw)
    before = dict(dc.LAUNCHES)
    kx, ks, kg, kh, _ = dc._launch_cuda(x32, metric, 1e-3, **machine)
    torch.cuda.synchronize()
    other = "l2" if form == "shared" else "shared"
    assert dc.LAUNCHES[f"fused_nuts_dc:x_{form}"] == before[f"fused_nuts_dc:x_{form}"] + 1
    assert dc.LAUNCHES[f"fused_nuts_dc:x_{other}"] == before[f"fused_nuts_dc:x_{other}"]
    px, ps, pg, ph, _ = dc._machine_plain(x32, metric, 1e-3, **machine)
    assert torch.equal(ks, ps) and bool((ks == S).all())
    assert torch.isfinite(kx).all() and torch.isfinite(kh).all()
    assert float(kg.sum()) > C * S  # trees of more than one leaf
    close = torch.isclose(kx, px, rtol=MATRIX_TOL, atol=MATRIX_TOL).all(1)
    close &= torch.isclose(kh, ph, rtol=MATRIX_TOL, atol=MATRIX_TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR
    assert torch.equal(kg[close], pg[close])


@pytest.mark.parametrize("kind", ["diag", "dense", "low_rank"])
def test_block_bytes_match_the_plan(cuda, monkeypatch, kind):
    """The kernel asks for the shared memory that shared_memory_plan counts,
    and reads and writes the scratch in device memory that the wrapper
    allocates (scratch_floats: the cold vectors and checkpoint slots of the
    resident, the tiles and the N >= 13 forms); eight schools in both of
    its forms: the registers form the plan keeps, and the thread form
    where _EIGHT_SCHOOLS_THREAD is set (the diagonal metric)."""
    import ctypes

    lib = dc._library(kind)
    shapes = [(404, dc._CUDA_HORSESHOE, 10, 100, 200), (404, dc._CUDA_HORSESHOE, 10, 400, 200),
              (100, dc._CUDA_HORSESHOE, 6, 37, 48), (36, dc._CUDA_HORSESHOE, 6, 12, 16),
              (54, dc._CUDA_LOGREG, 8, 4096, 54), (10, dc._CUDA_EIGHT_SCHOOLS, 8, 0, 0),
              (10, dc._CUDA_EIGHT_SCHOOLS, 6, 0, 0), (10, dc._CUDA_EIGHT_SCHOOLS, 10, 0, 0),
              (100, dc._CUDA_HIERARCHICAL, 8, 0, 0), (8, dc._CUDA_HIERARCHICAL, 10, 0, 0),
              (200, dc._CUDA_GAUSSIAN, 6, 0, 0), (404, dc._CUDA_HIERARCHICAL, 8, 0, 0)]
    rank = 4 if kind == "low_rank" else 0
    for thread in (False, True) if kind == "diag" else (False,):
        monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", thread)
        for d, family, max_depth, rows, cols in shapes:
            if kind != "diag" and d > 256:
                continue
            n = dc._register_width(d)
            plan = dc.shared_memory_plan(n, family, kind, max_depth, rows, cols, rank)
            assert lib.bjt_dc_block_bytes(d, family, plan.form, max_depth, rows, cols, rank,
                                          int(plan.metric_shared)) == plan.nbytes
            floats = (ctypes.c_longlong * 2)()
            assert lib.bjt_dc_scratch_floats(d, family, plan.form, max_depth, floats) == 0
            assert tuple(floats) == dc.scratch_floats(plan, n, kind, max_depth)


@pytest.mark.parametrize("max_depth", [6, 8, 10])
@pytest.mark.parametrize("kind", ["diag", "dense", "low_rank"])
def test_tiles_block_bytes_match_the_plan(cuda, kind, max_depth):
    """Logistic regression's tiles form asks for the bytes the plan counts,
    with the metric's matrices in shared memory or not, at d = 12, 54, 256."""
    lib = dc._library(kind)
    rank = 10 if kind == "low_rank" else 0
    for d, rows in ((12, 24), (54, 4096), (256, 300)):
        plan = dc.shared_memory_plan(dc._register_width(d), dc._CUDA_LOGREG, kind, max_depth,
                                     rows, d, rank)
        assert plan.x_form == "tiles"
        assert lib.bjt_dc_block_bytes(d, dc._CUDA_LOGREG, 0, max_depth, rows, d, rank,
                                      int(plan.metric_shared)) == plan.nbytes


def _tiles_gate(kern, plain, S, full=True):
    """The matrix-target gate, chain by chain: identical steps (all S where
    ``full``), finite outputs, the floor's share at MATRIX_TOL, and identical
    gradient counts and iterations on every chain that agrees."""
    (kx, ks, kg, kh, ki), (px, ps, pg, ph, pi) = kern, plain
    assert torch.equal(ks, ps)
    if full:
        assert bool((ks == S).all())
    assert torch.isfinite(kx).all() and torch.isfinite(kh).all()
    close = torch.isclose(kx, px, rtol=MATRIX_TOL, atol=MATRIX_TOL).all(1)
    close &= torch.isclose(kh, ph, rtol=MATRIX_TOL, atol=MATRIX_TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR
    assert torch.equal(kg[close], pg[close]) and torch.equal(ki[close], pi[close])


def _tiles_run(cuda, case, kind, C, S, budgets=None, **kw):
    make, step_size, scale = MATRIX_CASES[case]
    target = make()
    d = target.dim
    x = torch.from_numpy(
        (scale * np.random.default_rng(d).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda) if kind == "diag" else _rich_metric(kind, d, cuda)
    kw = dict(dict(target=target, num_steps=S, max_num_doublings=6, seed=7, num_track=d,
                   budget=2**6 * S), **kw)
    x32, metric, machine = dc._prepare(x, imm, **kw)
    before = dict(dc.LAUNCHES)
    kern = dc._launch_cuda(x32, metric, step_size, budgets=budgets, **machine)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in dc.LAUNCHES.items() if v != before[k]}
    assert launched == {"fused_nuts_dc": 1, "fused_nuts_dc:x_tiles": 1}
    plain = dc._machine_plain(x32, metric, step_size, budgets=budgets, **machine)
    return kern, plain


@pytest.mark.parametrize("kind", ["diag", "dense", "low_rank"])
@pytest.mark.parametrize("case", ["logreg_23x12", "logreg_4096x54"])
def test_logreg_tiles_match_plain_version(cuda, case, kind):
    """The tiles form against the plain version at C = 13: a block of eight
    chains and a partial block whose three absent warps join every gradient;
    one launch, counted under its form."""
    kern, plain = _tiles_run(cuda, case, kind, 13, 4)
    _tiles_gate(kern, plain, 4)
    assert float(kern[2].sum()) > 13 * 4  # trees of more than one leaf


@pytest.mark.parametrize("kind", ["diag", "dense", "low_rank"])
@pytest.mark.parametrize("case", ["logreg_23x12", "logreg_4096x54"])
def test_logreg_tiles_budgets_and_parked_warps_match_plain_version(cuda, case, kind):
    """Budgets that differ chain by chain inside a block (as pack > 1 gives
    them), some too small to finish, and restarts gated to every fourth
    leaf, so that warps park, run out and idle while others take leaves."""
    budgets = torch.from_numpy(np.random.default_rng(4).integers(8, 160, 20))
    kern, plain = _tiles_run(cuda, case, kind, 20, 6, budgets=budgets, restart_every=4,
                             chunk=16, budget=160)
    _tiles_gate(kern, plain, 6, full=False)
    assert 0 < int((kern[1] < 6).sum()) < 20


def test_logreg_tiles_pack_matches_plain_version(cuda):
    """Four chains a lane under a lane budget that cuts some short, with
    gated restarts, through the public entry point: the kernel flags the
    plain version's chains."""
    target = MATRIX_CASES["logreg_23x12"][0]()
    d, C = target.dim, 512
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(1).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda)
    kw = dict(target=target, num_steps=8, max_num_doublings=4, seed=7, num_track=d, chunk=16,
              pack=4, restart_every=2, budget=256)
    before = dc.LAUNCHES["fused_nuts_dc:x_tiles"]
    kern = dc.fused_nuts_run_dc(x, imm, 0.3, **kw)
    assert dc.LAUNCHES["fused_nuts_dc:x_tiles"] > before
    plain = dc.fused_nuts_run_dc_plain(x, imm, 0.3, **kw)
    assert torch.equal(kern[3], plain[3])
    assert 0 < int((kern[3] < 8).sum()) < C
    close = torch.isclose(kern[0], plain[0], rtol=MATRIX_TOL, atol=MATRIX_TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=MATRIX_TOL, atol=MATRIX_TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


def test_dc_kernel_accepts_d404(cuda):
    d = 404
    x = torch.zeros(8, d, device=cuda)
    out = dc.fused_nuts_run_dc(
        x, torch.ones(d, device=cuda), 0.1, target=dc.make_hierarchical_target_dc(d),
        num_steps=2, num_track=d, max_num_doublings=4,
    )
    assert out[1].shape == (8, 2, d) and torch.isfinite(out[0]).all()


def test_wide_targets_are_refused(cuda):
    d = 513
    with pytest.raises(NotImplementedError, match="d <= 512"):
        dc.fused_nuts_run_dc(
            torch.zeros(4, d, device=cuda), torch.ones(d, device=cuda), 0.2,
            target=dc.make_hierarchical_target_dc(d), num_steps=2, num_track=2,
        )


def test_pack_and_restart_every_budget_matches_plain_version(cuda):
    """Four chains per lane under a lane budget that cuts some short: the
    kernel flags exactly the plain version's chains."""
    d, C = 8, 512
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(1).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda)
    kw = dict(target=dc.make_hierarchical_target_dc(d), num_steps=8, max_num_doublings=4,
              seed=7, num_track=d, chunk=16, pack=4, restart_every=2, budget=256)
    kern = dc.fused_nuts_run_dc(x, imm, 0.2, **kw)
    plain = dc.fused_nuts_run_dc_plain(x, imm, 0.2, **kw)
    assert torch.equal(kern[3], plain[3])
    assert 0 < int((kern[3] < 8).sum()) < C
    close = torch.isclose(kern[0], plain[0], rtol=TOL, atol=TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=TOL, atol=TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


def _rich_metric(kind, d, device, seed=3):
    """A correlated dense ``(d, d)`` metric, or a rank-``min(4, d - 1)``
    low-rank payload with informative ``lam``, f32 on ``device``."""
    rng = np.random.default_rng(seed)
    if kind == "dense":
        a = rng.standard_normal((d, d))
        m = 0.5 * a @ a.T / d + np.diag(rng.uniform(0.5, 1.5, d))
        return torch.from_numpy(m.astype(np.float32)).to(device)
    k = min(4, d - 1)
    U, _ = np.linalg.qr(rng.standard_normal((d, k)))
    lam = np.concatenate([rng.uniform(2.5, 6.0, k - k // 2), rng.uniform(0.1, 0.4, k // 2)])
    sigma = rng.uniform(0.6, 1.4, d)
    return LowRankInverseMassMatrix(
        *(torch.from_numpy(a.astype(np.float32)).to(device) for a in (sigma, U, lam)))


RICH_CASES = {
    "gaussian_4": (lambda: dc.make_gaussian_target_dc(4, [1.0, 4.0, 0.25, 2.0]), 0.3, 0.5, TOL),
    "hierarchical_100": (lambda: dc.make_hierarchical_target_dc(100), 0.15, 0.5, TOL),
    "gaussian_200": (lambda: dc.make_gaussian_target_dc(200, np.linspace(0.5, 2.0, 200)),
                     0.3, 0.5, TOL),
    "logreg_4096x54": (lambda: targets_dc.make_logreg_target_dc(*_logreg_data(4096, 54)),
                       0.01, 0.05, MATRIX_TOL),
    "horseshoe_12x16": (lambda: targets_dc.make_finnish_horseshoe_target_dc(12, 16), 0.03, 0.1,
                        MATRIX_TOL),
    "eight_schools": (targets_dc.make_eight_schools_target_dc, 0.2, 0.5, MATRIX_TOL),
}


@pytest.mark.parametrize("kind", ["dense", "low_rank"])
@pytest.mark.parametrize("case", sorted(RICH_CASES))
def test_dense_and_low_rank_kernels_match_plain_version(cuda, case, kind):
    make, step_size, scale, tol = RICH_CASES[case]
    target = make()
    d, C, S = target.dim, 64, 4
    x = torch.from_numpy(
        (scale * np.random.default_rng(d).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = _rich_metric(kind, d, cuda)
    kw = dict(target=target, num_steps=S, max_num_doublings=6, seed=7, num_track=d,
              budget=2**6 * S)
    before = dc.LAUNCHES["fused_nuts_dc"]
    kern = dc.fused_nuts_run_dc(x, imm, step_size, **kw)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["fused_nuts_dc"] == before + 1
    plain = dc.fused_nuts_run_dc_plain(x, imm, step_size, **kw)
    assert torch.equal(kern[3], plain[3]) and bool((kern[3] == S).all())
    assert float(kern[2]) == float(plain[2]) > C * S
    assert torch.isfinite(kern[0]).all() and torch.isfinite(kern[1]).all()
    close = torch.isclose(kern[0], plain[0], rtol=tol, atol=tol).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=tol, atol=tol).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


@pytest.mark.parametrize("kind", ["dense", "low_rank"])
def test_rich_metric_consistency_pins_on_the_card(cuda, kind):
    """``diag(v)`` dense and ``lam = 1`` low-rank give the diagonal kernel's
    samples (tests/ops/test_fused_nuts_dc_metrics.py:46-71)."""
    d = 4
    if kind == "dense":
        v = torch.tensor([1.0, 2.0, 0.5, 1.5], device=cuda)
        imm, diag = torch.diag(v), v
    else:
        sigma = torch.tensor([1.0, 1.5, 0.7, 1.2], device=cuda)
        U, _ = torch.linalg.qr(torch.from_numpy(
            np.random.default_rng(5).standard_normal((d, 2)).astype(np.float32)).to(cuda))
        imm, diag = LowRankInverseMassMatrix(sigma, U, torch.ones(2, device=cuda)), sigma**2
    x = torch.from_numpy(
        (0.2 * np.random.default_rng(0).standard_normal((64, d))).astype(np.float32)).to(cuda)
    kw = dict(target=dc.make_gaussian_target_dc(d, [1.0, 4.0, 0.25, 2.0]), num_steps=10,
              max_num_doublings=5, seed=3, num_track=d, budget=400, chunk=16)
    rich = dc.fused_nuts_run_dc(x, imm, 0.4, **kw)
    diagonal = dc.fused_nuts_run_dc(x, diag, 0.4, **kw)
    assert torch.equal(rich[3], diagonal[3]) and bool((rich[3] == 10).all())
    torch.testing.assert_close(rich[1], diagonal[1], rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "low_rank"])
def test_rich_metrics_above_d256_are_refused(cuda, kind):
    d = 257
    with pytest.raises(NotImplementedError, match="d <= 256"):
        dc.fused_nuts_run_dc(
            torch.zeros(4, d, device=cuda), _rich_metric(kind, d, cuda), 0.2,
            target=dc.make_hierarchical_target_dc(d), num_steps=2, num_track=2,
        )


def test_sample_init_follows_a_cuda_generator(cuda):
    from blackjax_tpu_torch.models import hierarchical_gaussian

    g = torch.Generator(device=cuda).manual_seed(0)
    x = hierarchical_gaussian(6).sample_init(g, 3)
    assert x.device.type == "cuda" and x.shape == (3, 6)


LEAPFROG_FLOOR = 0.99


@pytest.mark.parametrize("d", [12, 100, 200])
@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_leapfrog_kernel_matches_plain_version(cuda, case, d):
    rng = np.random.default_rng(d)
    if case == "hierarchical":
        target = fl.make_hierarchical_gaussian_target(d)
    else:
        target = fl.make_gaussian_target(d, rng.uniform(0.5, 4.0, d))
    C = 1024
    x = torch.from_numpy((0.5 * rng.standard_normal((C, d))).astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.standard_normal((C, d)).astype(np.float32)).to(cuda)
    imm = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32)).to(cuda)
    before = fl.LAUNCHES["fused_leapfrog"]
    kern = fl.fused_leapfrog(x, m, imm, 0.05, target=target, num_steps=10)
    torch.cuda.synchronize()
    assert fl.LAUNCHES["fused_leapfrog"] == before + 1
    plain = fl.fused_leapfrog_plain(x, m, imm, 0.05, target=target, num_steps=10)
    close = torch.ones(C, dtype=torch.bool, device=cuda)
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and torch.isfinite(a).all()
        ok = torch.isclose(a, b, rtol=TOL, atol=TOL)
        close &= ok.all(1) if ok.dim() == 2 else ok
    assert float(close.float().mean()) >= LEAPFROG_FLOOR


@pytest.mark.parametrize("C", [250, 256])
@pytest.mark.parametrize("n, d", [(23, 12), (300, 54), (4096, 54)])
def test_leapfrog_logistic_regression_matches_plain_version(cuda, n, d, C):
    """The tiles form, launched, against the plain version; at C = 250 the
    last block holds parked warps."""
    target = fl.make_logistic_regression_target(*_logreg_data(n, d))
    rng = np.random.default_rng(n)
    x = torch.from_numpy((0.1 * rng.standard_normal((C, d))).astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.standard_normal((C, d)).astype(np.float32)).to(cuda)
    imm = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32)).to(cuda)
    eps = 0.2 / np.sqrt(n)
    before = dict(fl.LAUNCHES)
    kern = fl.fused_leapfrog(x, m, imm, eps, target=target, num_steps=10)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fl.LAUNCHES.items()} == {
        "fused_leapfrog": 1, "fused_leapfrog:logreg_tiles": 1, "fused_leapfrog:hmc_transition": 0}
    plain = fl.fused_leapfrog_plain(x, m, imm, eps, target=target, num_steps=10)
    close = torch.ones(C, dtype=torch.bool, device=cuda)
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and torch.isfinite(a).all()
        ok = torch.isclose(a, b, rtol=TOL, atol=TOL)
        close &= ok.all(1) if ok.dim() == 2 else ok
    assert float(close.float().mean()) >= LEAPFROG_FLOOR


def test_leapfrog_wide_targets_are_refused(cuda):
    d = 300
    with pytest.raises(ValueError, match="d <= 256"):
        fl.fused_leapfrog(
            torch.zeros(4, d, device=cuda), torch.zeros(4, d, device=cuda),
            torch.ones(d, device=cuda), 0.1, target=fl.make_hierarchical_gaussian_target(d),
            num_steps=2,
        )


def test_fused_hmc_launches_once_per_transition(cuda):
    d, C = 100, 256
    algo = fused_hmc(fl.make_hierarchical_gaussian_target(d), 0.15, torch.ones(d, device=cuda), 10)
    state = algo.init(0.5 * torch.randn(C, d, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(0)
    before = dict(fl.LAUNCHES)
    for _ in range(5):
        state, info = algo.step(g, state)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fl.LAUNCHES.items()} == {
        "fused_leapfrog": 5, "fused_leapfrog:logreg_tiles": 0, "fused_leapfrog:hmc_transition": 5}
    assert torch.isfinite(state.positions).all() and info.acceptance_rate.shape == (C,)
    assert info.is_accepted.dtype == torch.bool


def _transition_inputs(cuda, case, d, C):
    """A target, positions and their log densities, draws and a metric for
    the transition kernel, from numpy seed d + C."""
    rng = np.random.default_rng(d + C)
    if case == "hierarchical":
        target = fl.make_hierarchical_gaussian_target(d)
    else:
        target = fl.make_gaussian_target(d, rng.uniform(0.5, 4.0, d))

    def on(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)

    x = on(0.5 * rng.standard_normal((C, d)))
    return (target, x, target.logdensity_fn(x), on(rng.standard_normal((C, d))),
            on(rng.random(C)), on(rng.uniform(0.5, 1.5, d)))


def _hold_to_float64(case, kern, x, ld, z, imm, step_size, kw):
    """The transition kernel's outputs on its own trajectory: the positions
    and energy1 are ``fused_leapfrog``'s from the same momenta, bit for bit,
    and on every chain with a finite proposal the accepted log density and
    p_accept are within eight float32 epsilons of the largest term they come
    from (a kinetic energy, a log density or, on the hierarchical target,
    ``0.5 theta^2 exp(-log_tau)``) of the same quantities in float64 from
    that trajectory's f32 end (p_accept relative to itself, with its own
    rounding). A wrong kinetic or log-density term shows
    here; the plain version cannot hold the kernel this tight, since its
    trajectory parts from the kernel's within rounding."""
    eps = torch.finfo(torch.float32).eps
    target, num_steps = kw["target"], kw["num_steps"]
    m0 = z / torch.sqrt(imm)
    xe, me, e1 = fl.fused_leapfrog(x, m0, imm, step_size, target=target, num_steps=num_steps)
    x1, ld1, p_accept, accept, energy = kern
    torch.testing.assert_close(energy, e1, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(x1, torch.where(accept[:, None], xe, x))
    assert torch.equal(ld1[~accept], ld[~accept])
    kinetic0 = 0.5 * (m0.double() ** 2 * imm.double()).sum(1)
    kinetic1 = 0.5 * (me.double() ** 2 * imm.double()).sum(1)
    ld_end = target.logdensity_tile(xe.double())
    p64 = torch.clamp(torch.exp(-ld.double() + kinetic0 - (-ld_end + kinetic1)), max=1.0)
    terms = torch.stack([kinetic0, kinetic1, ld.double().abs(), ld_end.abs()]).amax(0)
    if case == "hierarchical":
        x64 = xe.double()
        terms = torch.maximum(terms, 0.5 * (x64[:, 1:] ** 2).sum(1) * torch.exp(-x64[:, 0]))
    finite = torch.isfinite(terms) & torch.isfinite(p64)
    tol = 8 * eps * terms
    held = accept & finite
    assert ((ld1.double() - ld_end).abs() <= tol)[held].all()
    # p_accept also rounds to f32 itself, and underflows below f32's tiny
    tiny = torch.finfo(torch.float32).tiny
    assert ((p_accept.double() - p64).abs() <= (tol + eps) * p64 + tiny)[finite].all()


def _transition_pair(cuda, case, d, C, num_steps, step_size):
    """The transition kernel, launched once, and its plain version on the
    same inputs; returns both outputs and the share of chains that agree:
    the same accept flag, positions to 1e-5, and log densities and p_accept
    to 1e-5 of the energy they come from. Both are differences of two
    energies of order d (``-(energy1 - kinetic1)``, ``exp(energy0 -
    energy1)``): the plain version's gradient sums run in torch's order, so
    its trajectory parts from the kernel's within rounding, and on the
    hierarchical target at d = 256 the log density amplifies that to up to
    ~100 float32 epsilons of the energy on a few chains in a hundred. The
    kernel is also held to float64 on its own trajectory
    (:func:`_hold_to_float64`), on every chain."""
    target, x, ld, z, u, imm = _transition_inputs(cuda, case, d, C)
    kw = dict(target=target, num_steps=num_steps)
    before = dict(fl.LAUNCHES)
    kern = fl._hmc_transition_cuda(x, ld, z, u, imm, step_size, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fl.LAUNCHES.items()} == {
        "fused_leapfrog": 1, "fused_leapfrog:logreg_tiles": 0, "fused_leapfrog:hmc_transition": 1}
    plain = fl._hmc_transition_plain(x, ld, z, u, imm, step_size, **kw)
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
    _hold_to_float64(case, kern, x, ld, z, imm, step_size, kw)
    scale = torch.nan_to_num(plain[4].abs(), nan=1.0, posinf=1.0).clamp(min=1.0)
    same = (kern[3] == plain[3]) & torch.isclose(kern[0], plain[0], rtol=TOL, atol=TOL).all(1)
    same &= (kern[1] - plain[1]).abs() <= TOL * scale
    same &= (kern[2] - plain[2]).abs() <= TOL + TOL * scale * plain[2]
    return kern, plain, float(same.float().mean())


@pytest.mark.parametrize("num_steps", [1, 10])
@pytest.mark.parametrize("C", [1, 5, 4096])
@pytest.mark.parametrize("d", [1, 31, 32, 33, 100, 128, 256])
@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_hmc_transition_kernel_matches_plain_version(cuda, case, d, C, num_steps):
    kern, _, share = _transition_pair(cuda, case, d, C, num_steps, 0.1)
    assert share >= LEAPFROG_FLOOR
    for t in kern[:3]:
        assert torch.isfinite(t).all()


@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_hmc_transition_kernel_rejects_a_divergent_trajectory(cuda, case):
    """At a step size where every trajectory diverges: delta's NaN is -inf,
    p_accept 0, nothing accepted, the positions and log densities kept, as
    in the plain version."""
    (x, ld, p_accept, accept, energy), plain, share = _transition_pair(
        cuda, case, 100, 512, 10, 1e4)
    target, x0, ld0, *_ = _transition_inputs(cuda, case, 100, 512)
    assert not torch.isfinite(energy).any() and not torch.isfinite(plain[4]).any()
    assert (p_accept == 0).all() and not accept.any()
    assert torch.equal(x, x0) and torch.equal(ld, ld0)
    assert share == 1.0


def test_hmc_transition_refuses_d257(cuda):
    d = 257
    target = fl.make_hierarchical_gaussian_target(d)
    x = torch.zeros(4, d, device=cuda)
    with pytest.raises(ValueError, match="d <= 256"):
        fl._hmc_transition_cuda(x, torch.zeros(4, device=cuda), x, torch.zeros(4, device=cuda),
                                torch.ones(d, device=cuda), 0.1, target=target, num_steps=2)
    algo = fused_hmc(target, 0.1, torch.ones(d, device=cuda), 2)
    with pytest.raises(ValueError, match="d <= 256"):
        algo.step(torch.Generator(device=cuda).manual_seed(0), algo.init(x))


def test_fused_hmc_logistic_regression_keeps_the_tiles_leapfrog(cuda):
    """A transition on logistic regression is one launch of the tiles-form
    leapfrog and the PyTorch ops around it, the plain transition's ops."""
    n, d, C = 300, 54, 256
    target = fl.make_logistic_regression_target(*_logreg_data(n, d))
    algo = fused_hmc(target, 0.2 / np.sqrt(n), torch.ones(d, device=cuda), 10)
    state = algo.init(0.1 * torch.randn(C, d, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(3)
    z = torch.randn(C, d, generator=g, device=cuda)
    u = torch.rand(C, generator=g, device=cuda)
    before = dict(fl.LAUNCHES)
    new_state, info = algo.step_from_draws(state, z, u)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fl.LAUNCHES.items()} == {
        "fused_leapfrog": 1, "fused_leapfrog:logreg_tiles": 1, "fused_leapfrog:hmc_transition": 0}
    plain = fl._hmc_transition_plain(state.positions, state.logdensities, z, u,
                                     algo.inverse_mass_matrix, algo.step_size, target=target,
                                     num_steps=10)
    same = info.is_accepted == plain[3]
    for a, b in zip((new_state.positions, new_state.logdensities, info.acceptance_rate), plain):
        ok = torch.isclose(a, b, rtol=TOL, atol=TOL)
        same &= ok.all(1) if ok.dim() == 2 else ok
    assert float(same.float().mean()) >= LEAPFROG_FLOOR


MCLMC_TOL = 1e-5
MCLMC_FLOOR = 0.9


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("d", [12, 100, 200])
@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_mclmc_kernel_matches_plain_version(cuda, case, d, refresh):
    rng = np.random.default_rng(d)
    if case == "hierarchical":
        target = fl.make_hierarchical_gaussian_target(d)
    else:
        target = fl.make_gaussian_target(d, rng.uniform(0.5, 4.0, d))
    C, S = 1024, 32
    x = torch.from_numpy((0.5 * rng.standard_normal((C, d))).astype(np.float32)).to(cuda)
    m = torch.nn.functional.normalize(torch.randn(C, d, device=cuda), dim=1)
    imm = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32)).to(cuda)
    kw = dict(target=target, num_steps=S, seed=3, track_dims=(0, 1, d - 1), refresh=refresh)
    before = fm.LAUNCHES["fused_mclmc"]
    kern = fm.fused_mclmc(x, m, imm, 0.3, 2.0, **kw)
    torch.cuda.synchronize()
    assert fm.LAUNCHES["fused_mclmc"] == before + 1
    plain = fm.fused_mclmc_plain(x, m, imm, 0.3, 2.0, **kw)
    close = torch.ones(C, dtype=torch.bool, device=cuda)
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and torch.isfinite(a).all()
        ok = torch.isclose(a, b, rtol=MCLMC_TOL, atol=MCLMC_TOL)
        close &= ok.flatten(1).all(1) if ok.dim() > 1 else ok
    assert float(close.float().mean()) >= MCLMC_FLOOR
    norms = torch.linalg.vector_norm(kern[1], dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)


@pytest.mark.parametrize("C", [250, 256])
@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("n, d", [(23, 12), (4096, 54)])
def test_mclmc_logistic_regression_matches_plain_version(cuda, n, d, refresh, C):
    """The tiles form, launched, against the plain version; at C = 250 the
    last block holds parked warps."""
    target = fl.make_logistic_regression_target(*_logreg_data(n, d))
    rng = np.random.default_rng(n)
    S = 16
    x = torch.from_numpy((0.1 * rng.standard_normal((C, d))).astype(np.float32)).to(cuda)
    m = torch.nn.functional.normalize(torch.randn(C, d, device=cuda), dim=1)
    imm = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32)).to(cuda)
    kw = dict(target=target, num_steps=S, seed=3, track_dims=(0, d - 1), refresh=refresh)
    eps = 0.5 / np.sqrt(n)
    before = dict(fm.LAUNCHES)
    kern = fm.fused_mclmc(x, m, imm, eps, 1.0, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in fm.LAUNCHES.items()} == {
        "fused_mclmc": 1, "fused_mclmc:resident": 0, "fused_mclmc:registers": 0,
        "fused_mclmc:logreg_tiles": 1, "counter_normals": 0, "pool_layout": 0}
    plain = fm.fused_mclmc_plain(x, m, imm, eps, 1.0, **kw)
    close = torch.ones(C, dtype=torch.bool, device=cuda)
    for a, b in zip(kern, plain):
        assert a.shape == b.shape and torch.isfinite(a).all()
        ok = torch.isclose(a, b, rtol=MCLMC_TOL, atol=MCLMC_TOL)
        close &= ok.flatten(1).all(1) if ok.dim() > 1 else ok
    assert float(close.float().mean()) >= MCLMC_FLOOR


@pytest.mark.parametrize("d, tile_rows, nbytes", [
    (1, 256, 49_408), (12, 256, 49_920), (54, 256, 142_848), (100, 128, 116_992),
    (200, 64, 121_344), (256, 64, 153_600),
])
def test_tiles_plan_matches_the_kernels_layout(cuda, d, tile_rows, nbytes):
    """Chains a block, rows a tile and bytes of shared memory a block of the
    tiles form, as the kernels count them and the wrapper reads them to
    size the upload of X, against the count from the layout's parts at
    sixteen chains a block (``tests/test_torch_fused_tiles.py``): the ring
    of two tiles at a row stride of ``round_up(d, 4)`` that is 4 mod 8 (or
    the backward pass's partial sums, if larger), the positions and the
    backward pass's weights, in f32."""
    plan = fl.tiles_plan(d)
    assert plan == fl.TilesPlan(16, tile_rows, nbytes)
    assert plan.nbytes <= 232_448


def test_mclmc_counter_normals_on_the_card(cuda):
    w1, w2, z = fm.counter_normals_device(7, 5, 2 * 17 + 1, 512, 100, cuda)
    p1, p2, pz = fm.counter_normals_device(7, 5, 2 * 17 + 1, 512, 100, "cpu")
    assert torch.equal(w1.cpu(), p1) and torch.equal(w2.cpu(), p2)
    assert torch.allclose(z.cpu(), pz, rtol=1e-6, atol=1e-6)


def test_mclmc_wide_targets_are_refused(cuda):
    d = 300
    with pytest.raises(ValueError, match="d <= 256"):
        fm.fused_mclmc(
            torch.zeros(4, d, device=cuda), torch.ones(4, d, device=cuda) / d**0.5,
            torch.ones(d, device=cuda), 0.1, 1.0,
            target=fl.make_hierarchical_gaussian_target(d), num_steps=2,
        )


# ---- the MCLMC kernel's resident form (csrc/fused_mclmc.cu: mclmc_resident) ----

# the port's coefficient sets by stage count (unrolled in the resident form),
# and a set of 9 stages that is no palindrome (the stage loop at run time,
# no kick reused)
MCLMC_STAGES = {
    3: "velocity_verlet_coefficients", 5: "mclachlan_coefficients",
    7: "yoshida_coefficients", 11: "omelyan_coefficients",
}
MCLMC_UNEVEN = (0.1, 0.2, 0.3, 0.4, 0.0, 0.4, 0.3, 0.2, 0.15)


def _mclmc_forms(cuda, case, d, S, refresh, coefficients, C=70):
    """The resident and the registers form's outputs on the same inputs,
    and the forms each launch counted."""
    rng = np.random.default_rng(d + S)
    target = (fl.make_hierarchical_gaussian_target(d) if case == "hierarchical"
              else fl.make_gaussian_target(d, rng.uniform(0.5, 4.0, d)))
    x = torch.from_numpy((0.5 * rng.standard_normal((C, d))).astype(np.float32)).to(cuda)
    m = torch.from_numpy(rng.standard_normal((C, d)).astype(np.float32)).to(cuda)
    m = m / torch.linalg.vector_norm(m, dim=1, keepdim=True)
    imm = torch.from_numpy(rng.uniform(0.5, 2.0, d).astype(np.float32)).to(cuda)
    kw = dict(target=target, num_steps=S, seed=3, coefficients=coefficients,
              track_dims=sorted({0, min(1, d - 1), d - 1}), refresh=refresh)
    outs, forms = [], []
    for form in (None, "registers"):
        before = dict(fm.LAUNCHES)
        outs.append(fm.fused_mclmc(x, m, imm, 0.3, 2.0, form=form, **kw))
        torch.cuda.synchronize()
        forms.append({k: v - before[k] for k, v in fm.LAUNCHES.items() if v != before[k]})
    return outs, forms


def _same_bits(a, b):
    """torch.equal on the bits, so that NaNs (d = 1 divides by d - 1) count
    as equal where their bits are."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d", [1, 32, 33, 100, 200, 256])
@pytest.mark.parametrize("stages", [3, 5, 7, 11, 9])
@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_mclmc_resident_form_is_the_registers_form_bit_for_bit(cuda, case, refresh, stages, d):
    """The resident form draws every normal with its key and sums in the
    registers form's order: x, m, the log density and the history are the
    same bits at 1, 3, 5 and 64 steps (partial last pools at 1, 3 and 5),
    for the port's coefficient sets and a set of 9 stages."""
    from blackjax_tpu_torch.mcmc import integrators

    coefficients = (getattr(integrators, MCLMC_STAGES[stages]) if stages in MCLMC_STAGES
                    else MCLMC_UNEVEN)
    for S in (1, 3, 5, 64):
        (resident, registers), forms = _mclmc_forms(cuda, case, d, S, refresh, coefficients)
        assert forms == [{"fused_mclmc": 1, "fused_mclmc:resident": 1},
                         {"fused_mclmc": 1, "fused_mclmc:registers": 1}]
        assert all(_same_bits(a, b) for a, b in zip(resident, registers)), S


@pytest.mark.parametrize("d", [1, 31, 33, 100, 200, 256])
def test_mclmc_pool_layout_is_the_kernels_walk(cuda, d):
    """The kernel's own walk over a pool (its export) lays the draws out as
    ``pool_layout`` does, for pools of 1 to 4 steps."""
    for steps in (1, 2, 3, 4):
        assert torch.equal(fm.pool_layout_device(d, steps, cuda).cpu(),
                           fm.pool_layout(d, steps)), steps


def test_mclmc_resident_form_refuses_logistic_regression(cuda):
    target = fl.make_logistic_regression_target(*_logreg_data(23, 12))
    before = dict(fm.LAUNCHES)
    with pytest.raises(ValueError):
        fm.fused_mclmc(torch.zeros(8, 12, device=cuda), torch.ones(8, 12, device=cuda) / 12**0.5,
                       torch.ones(12, device=cuda), 0.1, 1.0, target=target, num_steps=2,
                       form="resident")
    assert fm.LAUNCHES == before


def test_mclmc_resident_occupancy_is_the_recorded_one(cuda):
    """Phase 8's instantiation (d = 100, McLachlan's) holds the warps an SM
    it is built for (``mclmc_resident_warps``: all 4,096 flagship chains in
    one wave on 132 SMs) within the registers that allows, without spills,
    and pools 4 steps of noise; the registers form held 28."""
    resident = fm.occupancy(100)
    assert resident["warps_per_sm"] == 32 and resident["pool_steps"] == 4
    assert resident["registers"] <= 65_536 // (32 * 32) and resident["local_bytes"] == 0
    assert fm.occupancy(100, "registers")["warps_per_sm"] == 28


# ---- the per-element-key threefry, the older NUTS machine, the runner ----


def test_threefry_per_element_keys_bit_for_bit(cuda):
    from blackjax_tpu_torch import prng

    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(0, 2**32, (4, 100_000), dtype=np.uint64)
                             .astype(np.int64))
    before = dc.LAUNCHES["threefry2x32"]
    on_card = prng.threefry2x32(*(w.to(cuda) for w in words))
    assert dc.LAUNCHES["threefry2x32"] == before + 1
    plain = counter_rng.threefry2x32(*words)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card, plain))
    keys = words[:2].T.contiguous()
    for dtype in (torch.float32, torch.float64):
        assert torch.equal(prng.uniform(keys.to(cuda), (3,), dtype).cpu(),
                           prng.uniform(keys, (3,), dtype))
    z_card, z_cpu = prng.normal(keys.to(cuda), (3,), torch.float64).cpu(), prng.normal(
        keys, (3,), torch.float64)
    assert torch.allclose(z_card, z_cpu, rtol=1e-12, atol=1e-12)


def _fused_nuts_case(case, device):
    fn = importlib.import_module("blackjax_tpu_torch.ops.fused_nuts")
    rng = np.random.default_rng(7)
    if case == "logreg":
        X, y = _logreg_data(300, 54)
        target, C, d, step, doublings = fl.make_logistic_regression_target(X, y), 64, 54, 0.02, 6
    elif case == "gaussian":
        target, C, d, step, doublings = fl.make_gaussian_target(4, [1.0, 4.0, 0.25, 2.0]), 64, 4, \
            0.4, 6
    else:
        d = 100 if case in ("hierarchical", "trace") else 8
        target, C, step, doublings = fn.make_mxu_safe_hierarchical_target(d), 256, 0.2, 8
    x = torch.from_numpy((0.5 * rng.standard_normal((C, d))).astype(np.float32)).to(device)
    kw = dict(target=target, num_steps=8, max_num_doublings=doublings, seed=7,
              num_track=min(d, 8), budget=2**doublings * 8, chunk=2**doublings)
    if case == "trace":
        x = x[:64]
        kw.update(num_steps=4, budget=64, chunk=64, trace=64)
    if case == "budget":
        kw.update(budget=32, chunk=8)
    return fn, x, torch.ones(d, device=device), step, kw


@pytest.mark.parametrize("case", ["hierarchical", "hierarchical8", "gaussian", "logreg", "trace",
                                  "budget"])
def test_fused_nuts_kernel_matches_plain_version(cuda, case):
    fn, x, imm, step, kw = _fused_nuts_case(case, cuda)
    before = fn.LAUNCHES["fused_nuts"]
    kern = fn.fused_nuts_run(x, imm, step, **kw)
    torch.cuda.synchronize()
    assert fn.LAUNCHES["fused_nuts"] == before + 1
    plain = fn.fused_nuts_run_plain(x, imm, step, **kw)
    assert torch.equal(kern[3], plain[3]) and float(kern[2]) == float(plain[2])
    tol = 1e-3 if case == "logreg" else TOL
    close = torch.isclose(kern[0], plain[0], rtol=tol, atol=tol).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=tol, atol=tol).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR
    if case == "budget":
        assert int(kern[3].min()) < kw["num_steps"]
    if case == "trace":
        for name in fn.TRACE_COLS:
            same = torch.isclose(kern[4][name], plain[4][name], rtol=TOL, atol=TOL,
                                 equal_nan=True).all(0)
            assert float(same.float().mean()) >= AGREE_FLOOR, name


def test_runner_bit_identity_across_oversubscription_and_unroll(cuda):
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.mcmc import nuts
    from blackjax_tpu_torch.models import hierarchical_gaussian

    d, C, S = 8, 64, 6
    target = hierarchical_gaussian(d)
    x = torch.from_numpy((0.5 * np.random.default_rng(8).standard_normal((C, d)))
                         .astype(np.float32)).to(cuda)
    states = nuts.init(x, target.logdensity_fn)
    imm = torch.ones(d, device=cuda)
    keys = prng.split(prng.split(prng.key(9, cuda), S), C)
    kernel, state, hist, grads = nuts.build_kernel(), states, [], 0
    for t in range(S):
        state, info = kernel(keys[t], state, target.logdensity_fn, 0.2, imm, 6)
        hist.append(state.position)
        grads += int(info.num_integration_steps.sum())
    hist = torch.stack(hist, 1)
    for kw in (dict(), dict(oversubscription=4, unroll=4, restart_every=2)):
        run = nuts.build_fused_many_steps(target.logdensity_fn, 0.2, imm, num_steps=S,
                                          max_num_doublings=6, **kw)
        final, h, g = run(keys, states)
        assert int(g) == grads, kw
        # the reference's f32 tolerance (tests/mcmc/test_nuts.py:327)
        assert torch.allclose(h, hist, rtol=1e-4, atol=1e-4), kw
        assert torch.allclose(final.position, state.position, rtol=1e-4, atol=1e-4), kw



# ---- the analytic targets' resident form (nuts_dc_resident) ----

RESIDENT_TARGETS = {
    "hierarchical": dc.make_hierarchical_target_dc,
    "gaussian": lambda d: dc.make_gaussian_target_dc(d, np.linspace(0.5, 2.0, d)),
}


def _resident_run(cuda, target, C, S, imm=None, budgets=None, **kw):
    """One launch of the kernel, which must take the resident form, and the
    plain version on the same inputs, with the per-chain outputs."""
    d = target.dim
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(d).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda) if imm is None else imm
    kw = dict(dict(target=target, num_steps=S, max_num_doublings=6, seed=7,
                   num_track=min(d, 8), budget=2**6 * S), **kw)
    x32, metric, machine = dc._prepare(x, imm, **kw)
    before = dict(dc.LAUNCHES)
    kern = dc._launch_cuda(x32, metric, 0.2, budgets=budgets, **machine)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in dc.LAUNCHES.items() if v != before[k]}
    assert launched == {"fused_nuts_dc": 1, "fused_nuts_dc:analytic_resident": 1}
    plain = dc._machine_plain(x32, metric, 0.2, budgets=budgets, **machine)
    return kern, plain


def _resident_gate(kern, plain, S, full=True):
    """The analytic targets' gate: identical steps (all S where ``full``),
    the floor's share of chains at TOL, identical gradient totals, and
    identical iterations on every chain that agrees."""
    (kx, ks, kg, kh, ki), (px, ps, pg, ph, pi) = kern, plain
    assert torch.equal(ks, ps)
    if full:
        assert bool((ks == S).all())
    assert torch.isfinite(kx).all() and torch.isfinite(kh).all()
    close = torch.isclose(kx, px, rtol=TOL, atol=TOL).all(1)
    close &= torch.isclose(kh, ph, rtol=TOL, atol=TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR
    assert float(kg.sum()) == float(pg.sum())
    assert torch.equal(ki[close], pi[close])


@pytest.mark.parametrize("d", [8, 100, 200])
@pytest.mark.parametrize("case", sorted(RESIDENT_TARGETS))
def test_resident_form_matches_plain_version(cuda, case, d):
    """The resident form at N = 1, 4 and 8 for both analytic targets, at
    test_kernel_matches_plain_version's depth (the plain version's sums run
    in torch's order, and on the funnel a chain that parts by an ulp parts
    for good)."""
    kern, plain = _resident_run(cuda, RESIDENT_TARGETS[case](d), 64, 4)
    _resident_gate(kern, plain, 4)
    assert float(kern[2].sum()) > 64 * 4  # trees of more than one leaf


@pytest.mark.parametrize("d", [8, 100, 200])
@pytest.mark.parametrize("case", sorted(RESIDENT_TARGETS))
def test_resident_form_is_the_registers_form_bit_for_bit(cuda, case, d, monkeypatch):
    """Both forms compute the same sums in the same order: every output of
    256 chains x 8 transitions is the same bits."""
    target = RESIDENT_TARGETS[case](d)
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(d).standard_normal((256, d))).astype(np.float32)
    ).to(cuda)
    kw = dict(target=target, num_steps=8, max_num_doublings=6, seed=7, num_track=min(d, 8),
              budget=2**6 * 8)
    x32, metric, machine = dc._prepare(x, torch.ones(d, device=cuda), **kw)
    resident = dc._launch_cuda(x32, metric, 0.2, **machine)
    monkeypatch.setattr(dc, "RESIDENT_WIDTHS", {kind: () for kind in dc.RESIDENT_WIDTHS})
    before = dc.LAUNCHES["fused_nuts_dc:analytic_registers"]
    registers = dc._launch_cuda(x32, metric, 0.2, **machine)
    assert dc.LAUNCHES["fused_nuts_dc:analytic_registers"] == before + 1
    assert all(torch.equal(a, b) for a, b in zip(resident, registers))


def test_resident_form_holds_4096_chains(cuda):
    """The flagship's 4,096 chains at d = 100 and max_depth 8, all resident
    at once (32 warps an SM on 132 SMs)."""
    kern, plain = _resident_run(cuda, dc.make_hierarchical_target_dc(100), 4096, 4,
                                max_num_doublings=8, budget=2**8 * 4)
    _resident_gate(kern, plain, 4)


@pytest.mark.parametrize("d", [8, 100])
def test_resident_form_budgets_and_gated_restarts_match_plain_version(cuda, d):
    """Budgets that differ chain by chain, some too small to finish, and
    restarts gated to every fourth leaf, so that chains park and run out."""
    budgets = torch.from_numpy(np.random.default_rng(4).integers(8, 160, 64))
    kern, plain = _resident_run(cuda, dc.make_hierarchical_target_dc(d), 64, 6,
                                budgets=budgets, restart_every=4, chunk=16, budget=160)
    _resident_gate(kern, plain, 6, full=False)
    assert 0 < int((kern[1] < 6).sum()) < 64


def test_resident_form_pack_matches_plain_version(cuda):
    """Four chains a lane under a lane budget that cuts some short, with
    gated restarts, through the public entry point at d = 100."""
    d, C = 100, 512
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(1).standard_normal((C, d))).astype(np.float32)
    ).to(cuda)
    imm = torch.ones(d, device=cuda)
    kw = dict(target=dc.make_hierarchical_target_dc(d), num_steps=8, max_num_doublings=4,
              seed=7, num_track=8, chunk=16, pack=4, restart_every=2, budget=256)
    before = dc.LAUNCHES["fused_nuts_dc:analytic_resident"]
    kern = dc.fused_nuts_run_dc(x, imm, 0.2, **kw)
    assert dc.LAUNCHES["fused_nuts_dc:analytic_resident"] > before
    plain = dc.fused_nuts_run_dc_plain(x, imm, 0.2, **kw)
    assert torch.equal(kern[3], plain[3])
    assert 0 < int((kern[3] < 8).sum()) < C
    assert float(kern[2]) == float(plain[2])
    close = torch.isclose(kern[0], plain[0], rtol=TOL, atol=TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=TOL, atol=TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


def test_resident_occupancy_is_the_recorded_one(cuda):
    """The flagship's instantiation (d = 100, the diagonal metric, max_depth
    8) holds 20 warps an SM in the resident form, the warps it is built for
    (resident_warps), with its slots in shared memory, and 16 in the
    registers form, as PERF.md §6 records."""
    resident = dc.occupancy(100)
    assert resident["warps_per_sm"] == dc.resident_warps(4) == 20
    assert resident["registers"] <= 65_536 // (32 * 20)
    assert dc.occupancy(100, form=0)["warps_per_sm"] == 16


# ---- the older machine's resident form (csrc/fused_nuts.cu: nuts_resident) ----

OLDER_WIDTHS = (8, 50, 100, 200)  # N = 1, 2, 4, 8


def _older_run(cuda, case, d, C, S, budget, max_depth=6, form=None, seed=7):
    """One launch of fused_nuts_run (its public outputs) and the forms it
    counted."""
    fn = importlib.import_module("blackjax_tpu_torch.ops.fused_nuts")
    target = (fn.make_mxu_safe_hierarchical_target(d) if case == "hierarchical"
              else fl.make_gaussian_target(d, np.linspace(0.5, 2.0, d)))
    x = torch.from_numpy((0.5 * np.random.default_rng(d).standard_normal((C, d)))
                         .astype(np.float32)).to(cuda)
    kw = dict(target=target, num_steps=S, max_num_doublings=max_depth, seed=seed,
              num_track=min(d, 8), budget=budget, chunk=8)
    before = dict(fn.LAUNCHES)
    out = fn.fused_nuts_run(x, torch.ones(d, device=cuda), 0.2, form=form, **kw)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in fn.LAUNCHES.items() if v != before[k]}
    return fn, x, kw, out, launched


@pytest.mark.parametrize("budget", [2**6 * 8, 40])
@pytest.mark.parametrize("d", OLDER_WIDTHS)
@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_older_resident_form_is_the_registers_form_bit_for_bit(cuda, case, d, budget):
    """Both forms of the older machine compute the same sums in the same
    order and draw the same numbers: every output of 256 chains x 8
    transitions is the same bits, also where the budget runs out."""
    fn, _, _, resident, launched = _older_run(cuda, case, d, 256, 8, budget)
    assert launched == {"fused_nuts": 1, "fused_nuts:resident": 1}
    *_, registers, launched = _older_run(cuda, case, d, 256, 8, budget, form="registers")
    assert launched == {"fused_nuts": 1, "fused_nuts:registers": 1}
    assert all(torch.equal(a, b) for a, b in zip(resident, registers))
    if budget == 40:
        assert int(resident[3].min()) < 8


@pytest.mark.parametrize("d, max_depth", [(100, 11), (200, 8)])
def test_older_resident_form_with_slots_in_device_memory(cuda, d, max_depth):
    """Where the slots do not fit in shared memory they live in device
    memory, with the same bits."""
    assert _older_scratch(d, 1, max_depth)[1] > 0
    *_, resident, _ = _older_run(cuda, "hierarchical", d, 128, 4, 2**max_depth * 4, max_depth)
    *_, registers, _ = _older_run(cuda, "hierarchical", d, 128, 4, 2**max_depth * 4, max_depth,
                                  form="registers")
    assert all(torch.equal(a, b) for a, b in zip(resident, registers))


@pytest.mark.parametrize("case, d", [("hierarchical", 8), ("hierarchical", 100),
                                     ("gaussian", 4), ("gaussian", 100), ("gaussian", 200)])
def test_older_resident_form_matches_plain_version(cuda, case, d):
    """The resident form against the plain version at the older machine's
    gates: identical steps and gradient totals, the floor's share of chains
    at TOL."""
    fn, x, kw, kern, launched = _older_run(cuda, case, d, 256, 8, 2**6 * 8)
    assert launched["fused_nuts:resident"] == 1
    plain = fn.fused_nuts_run_plain(x, torch.ones(d, device=cuda), 0.2, **kw)
    assert torch.equal(kern[3], plain[3]) and float(kern[2]) == float(plain[2])
    close = torch.isclose(kern[0], plain[0], rtol=TOL, atol=TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=TOL, atol=TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


def _older_scratch(d, resident, max_depth):
    """A chain's floats of scratch in device memory, as the older machine's
    launch allocates them (bjt_fused_nuts_scratch_floats): its cold vectors
    and its checkpoint slots."""
    import ctypes

    fn = importlib.import_module("blackjax_tpu_torch.ops.fused_nuts")
    out = (ctypes.c_longlong * 2)()
    assert fn._library().bjt_fused_nuts_scratch_floats(d, resident, max_depth, out) == 0
    return out[0], out[1]


@pytest.mark.parametrize("d, max_depth, shared", [
    (8, 30, True), (64, 16, True), (64, 17, False), (100, 8, True), (100, 9, True),
    (100, 10, False), (200, 5, True), (200, 6, False), (256, 8, False),
])
def test_older_scratch_moves_the_slots_beyond_shared_memory(cuda, d, max_depth, shared):
    """The resident form keeps thirteen cold vectors a chain in device
    memory, and its 2 x max_depth checkpoint slots too where the SM's
    resident warps do not fit them in shared memory; the registers form
    keeps no scratch there."""
    vec = 32 * next(n for n in (1, 2, 4, 8) if 32 * n >= d)
    assert _older_scratch(d, 1, max_depth) == (13 * vec, 0 if shared else 2 * max_depth * vec)
    assert _older_scratch(d, 0, max_depth) == (0, 0)


def test_older_resident_occupancy_is_the_recorded_one(cuda):
    """Phase 13's instantiation (d = 100, max_depth 8) holds the warps an SM
    it is built for (resident_warps) in the resident form, within the
    registers that allows and without spills, and 16 in the registers
    form."""
    fn = importlib.import_module("blackjax_tpu_torch.ops.fused_nuts")
    resident = fn.occupancy(100)
    assert resident["warps_per_sm"] == 20
    assert resident["registers"] <= 65_536 // (32 * 20)
    assert fn.occupancy(100, resident=False)["warps_per_sm"] == 16


# ---- eight schools' thread form (csrc/fused_nuts_dc.cuh: nuts_dc_thread) ----


def _eight_schools_inputs(cuda, C, seed=15):
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(seed).standard_normal((C, 10))).astype(np.float32)
    ).to(cuda)
    return x, torch.from_numpy(np.random.default_rng(seed).uniform(0.5, 2.0, 10)
                               .astype(np.float32)).to(cuda)


def _both_forms(run, monkeypatch):
    """``run()`` in the thread form (switched on), then in the registers
    form (the plan's own), each counted under its form."""
    before = dict(dc.LAUNCHES)
    with monkeypatch.context() as m:
        m.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
        thread = run()
    assert dc.LAUNCHES["fused_nuts_dc:thread"] > before["fused_nuts_dc:thread"]
    assert dc.LAUNCHES["fused_nuts_dc:registers"] == before["fused_nuts_dc:registers"]
    registers = run()
    assert dc.LAUNCHES["fused_nuts_dc:registers"] > before["fused_nuts_dc:registers"]
    return thread, registers


@pytest.mark.parametrize("restart_every", [1, 16])
@pytest.mark.parametrize("max_depth", [6, 8, 10])
@pytest.mark.parametrize("C", [1, 31, 32, 33, 512, 4096])
def test_thread_form_is_the_registers_form_bit_for_bit(cuda, monkeypatch, C, max_depth,
                                                       restart_every):
    """One chain a thread and one chain a warp give the same bits: every
    output per chain (positions, steps, gradients, history, iterations)
    under per-chain budgets that cut some chains short, and the public
    outputs under pack=4 and a lane budget, with tracked rows out of
    order."""
    target = targets_dc.make_eight_schools_target_dc()
    x, imm = _eight_schools_inputs(cuda, C)
    S = 8
    kw = dict(target=target, num_steps=S, max_num_doublings=max_depth, seed=7, num_track=4,
              track_rows=(9, 8, 0, 3), chunk=16, restart_every=restart_every)
    budgets = torch.from_numpy(np.random.default_rng(C).integers(8, 40 * S, C))
    x32, metric, machine = dc._prepare(x, imm, budget=40 * S, **kw)
    thread, registers = _both_forms(
        lambda: dc._launch_cuda(x32, metric, 0.2, budgets=budgets, **machine), monkeypatch)
    assert all(torch.equal(a, b) for a, b in zip(thread, registers))
    if C >= 32:
        assert 0 < int((thread[1] < S).sum()) < C
    packed = dict(kw, pack=4, budget=12 * S * 4)
    thread, registers = _both_forms(
        lambda: dc.fused_nuts_run_dc(x, imm, 0.2, **packed), monkeypatch)
    assert all(torch.equal(a, b) for a, b in zip(thread, registers))
    assert bool(torch.isfinite(thread[0]).all() and torch.isfinite(thread[1]).all())


@pytest.mark.parametrize("max_depth", [8, 10])
@pytest.mark.parametrize("restart_every", [1, 16])
def test_thread_form_matches_plain_version(cuda, monkeypatch, restart_every, max_depth):
    """Phase 9's shape (512 chains x 8 transitions), with pack=4, gated
    restarts and a lane budget, at phase 9's depth and the tracked
    configuration's, held against the plain version under the matrix
    targets' gate."""
    monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
    target = targets_dc.make_eight_schools_target_dc()
    x, imm = _eight_schools_inputs(cuda, 512, seed=9)
    kw = dict(target=target, num_steps=8, max_num_doublings=max_depth, seed=7, num_track=10,
              pack=4, restart_every=restart_every, chunk=16, budget=12 * 8 * 4)
    before = dc.LAUNCHES["fused_nuts_dc:thread"]
    kern = dc.fused_nuts_run_dc(x, imm, 0.2, **kw)
    torch.cuda.synchronize()
    assert dc.LAUNCHES["fused_nuts_dc:thread"] > before
    plain = dc.fused_nuts_run_dc_plain(x, imm, 0.2, **kw)
    assert torch.equal(kern[3], plain[3]) and 0 < int((kern[3] < 8).sum()) < 512
    assert float(kern[2]) == float(plain[2])
    close = torch.isclose(kern[0], plain[0], rtol=MATRIX_TOL, atol=MATRIX_TOL).all(1)
    close &= torch.isclose(kern[1], plain[1], rtol=MATRIX_TOL, atol=MATRIX_TOL).flatten(1).all(1)
    assert float(close.float().mean()) >= AGREE_FLOOR


def test_thread_form_occupancy_is_the_recorded_one(cuda):
    """At max_depth 10 a one-warp block takes 35,840 B of shared memory, so
    an SM holds six (233,472 B, 1 KB reserved a block); ptxas gives the
    kernel 168 registers and a 96 B stack frame (PERF.md §6); the registers
    form holds its four warps a block."""
    thread = dc.occupancy(10, target=dc._CUDA_EIGHT_SCHOOLS, max_depth=10, form=2)
    assert thread["warps_per_sm"] == 6
    assert thread["registers"] <= 255 and thread["local_bytes"] <= 96
    registers = dc.occupancy(10, target=dc._CUDA_EIGHT_SCHOOLS, max_depth=10, form=0)
    assert registers["warps_per_sm"] % 4 == 0 and registers["warps_per_sm"] > 0


def test_thread_form_refuses_other_targets(cuda, monkeypatch):
    """The kernel's entry refuses the thread form for a target it does not
    run, and the wrapper raises: nothing falls back."""
    target = dc.make_hierarchical_target_dc(10)
    x = torch.zeros(4, 10, device=cuda)
    x32, metric, machine = dc._prepare(x, torch.ones(10, device=cuda), target=target,
                                       num_steps=2, num_track=2)
    monkeypatch.setattr(dc, "shared_memory_plan",
                        lambda *a, **k: dc.SharedMemoryPlan(None, 35_840, thread=True))
    with pytest.raises(RuntimeError, match="launch failed"):
        dc._launch_cuda(x32, metric, 0.2, **machine)


# ---- the SMC layer on the card (chip_smoke.py's phase 16) ----


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("num_samples", [1000, 333])
@pytest.mark.parametrize("scheme", ["systematic", "stratified", "multinomial", "residual"])
def test_resampling_on_the_card_draws_the_cpu_ancestors(cuda, scheme, num_samples, dtype):
    """The same draws on the card and on the CPU. In float64 the ancestors
    are identical; in float32 the card's cumulative sums associate otherwise
    (a parallel scan), so a position within their rounding of a boundary
    may pick the neighbour: 0.99 of the ancestors must be identical."""
    from blackjax_tpu_torch import prng
    from blackjax_tpu_torch.smc import resampling

    rng = np.random.default_rng(num_samples)
    for weights in [rng.dirichlet(np.full(1000, 0.3)), np.full(1000, 1e-3),
                    np.eye(1000)[417]]:
        w = torch.from_numpy(weights).to(dtype)
        for seed in range(3):
            before = dc.LAUNCHES["threefry2x32"]
            card = getattr(resampling, scheme)(prng.key(seed, cuda), w.to(cuda), num_samples)
            assert dc.LAUNCHES["threefry2x32"] > before
            assert card.device.type == "cuda"
            cpu = getattr(resampling, scheme)(prng.key(seed), w, num_samples)
            if dtype == torch.float64:
                assert torch.equal(card.cpu(), cpu), (scheme, seed)
            else:
                assert float((card.cpu() == cpu).double().mean()) >= 0.99, (scheme, seed)


def test_smc_state_stays_on_the_card(cuda):
    import chip_smoke
    from blackjax_tpu_torch import prng

    x0 = chip_smoke.smc_init(torch, 512, cuda, torch.float32)
    state, steps = chip_smoke.smc_run(torch, x0, prng.key(3, cuda), max_steps=2)
    (first, info), _ = steps
    for t in [state.particles, state.weights, state.tempering_param, first.particles,
              info.ancestors, info.log_likelihood_increment, *info.update_info]:
        assert t.device.type == "cuda"
    assert info.update_info.acceptance_rate.shape == (512, chip_smoke.SMC_MCMC_STEPS)


@pytest.mark.parametrize("waste_free", [False, True])
def test_tracked_smc_f64_on_the_card_is_the_cpu_run(cuda, waste_free):
    """Phase 16's hold: the tracked configuration in float64 at 1,024
    particles on the card and on the CPU, on the same key: the same steps,
    lambda within 1e-10, ancestors identical, particles within 1e-9."""
    import chip_smoke
    from blackjax_tpu_torch import prng

    x0 = chip_smoke.smc_init(torch, chip_smoke.SMC_CMP_PARTICLES, "cpu", torch.float64)
    _, card_steps = chip_smoke.smc_run(torch, x0.to(cuda), prng.key(18, cuda), waste_free)
    _, cpu_steps = chip_smoke.smc_run(torch, x0, prng.key(18), waste_free)
    assert len(card_steps) == len(cpu_steps)
    for (card, card_info), (cpu, cpu_info) in zip(card_steps, cpu_steps):
        assert torch.equal(card_info.ancestors.cpu(), cpu_info.ancestors)
        assert abs(float(card.tempering_param) - float(cpu.tempering_param)) <= 1e-10
        assert float((card.particles.cpu() - cpu.particles).abs().max()) <= chip_smoke.SMC_CMP_TOL
    assert float(card_steps[-1][0].tempering_param) == 1.0


# ---- the MCMC family beyond NUTS on the card (chip_smoke.py's phase 17) ----

FAMILY = ["hmc", "mhmc", "dhmc", "ghmc", "barker", "normal_random_walk", "irmh",
          "adjusted_mclmc", "adjusted_mclmc_dynamic", "elliptical_slice", "slice_sampling",
          "coordinate_slice", "orbital_hmc", "mgrad_gaussian", "gist_step_size",
          "gist_trajectory_length"]


def _family_run(name, device, transitions=5, chains=16, d=10):
    """Phase 17's sampler ``name`` in float64 at ``chains`` x ``d`` on
    ``device``: its positions and the info fields held identical, per
    transition."""
    import chip_smoke
    from blackjax_tpu_torch import prng

    import blackjax_tpu_torch

    def asarray(v):
        return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(device)

    algo, keyed_init = chip_smoke.family_algorithms(
        blackjax_tpu_torch, asarray, lambda key, shape: prng.normal(key, shape, torch.float64),
        d)[name]
    x0 = asarray(0.5 * np.random.default_rng(7).standard_normal((chains, d)))
    state = algo.init(x0, prng.split(prng.key(9, device), chains)) if keyed_init else algo.init(x0)
    keys = prng.split(prng.key(8, device), transitions)
    trace = []
    for i in range(transitions):
        state, info = algo.step(prng.split(keys[i], chains), state)
        _, exact = chip_smoke.family_statistic(name, info)
        x = state.positions if hasattr(state, "positions") else state.position
        assert x.device.type == device.type
        trace.append((x.cpu(), [getattr(info, f).cpu() for f in exact]))
    return trace


@pytest.mark.parametrize("name", FAMILY)
def test_family_step_on_the_card_is_the_cpu_step(cuda, name):
    """Each new sampler's transitions on the card against the port on the
    CPU, f64, on the same keys: positions within 1e-12, accept flags, drawn
    step counts, ``subiter`` and the slice counts identical."""
    card, cpu = _family_run(name, cuda), _family_run(name, torch.device("cpu"))
    for (xa, fa), (xb, fb) in zip(card, cpu):
        assert all(torch.equal(a, b) for a, b in zip(fa, fb)), name
        assert float((xa - xb).abs().max()) <= 1e-12, name


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("bounds", [(1, 10), (-3, 100003), (0, 2**31)])
def test_randint_on_the_card_is_the_cpu_draw(cuda, dtype, bounds):
    from blackjax_tpu_torch import prng

    keys = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2**32, (1000, 2), dtype=np.uint64).astype(np.int64))
    card = prng.randint(keys.to(cuda), (3,), *bounds, dtype=dtype)
    assert card.device.type == "cuda"
    assert torch.equal(card.cpu(), prng.randint(keys, (3,), *bounds, dtype=dtype))


@pytest.mark.parametrize("n", [8, 17, 40])
def test_choice_on_the_card_is_the_cpu_draw(cuda, n):
    from blackjax_tpu_torch import prng

    keys = torch.from_numpy(np.random.default_rng(n).integers(
        0, 2**32, (1000, 2), dtype=np.uint64).astype(np.int64))
    for dtype in (torch.float32, torch.float64):
        p = torch.from_numpy(np.random.default_rng(n + 1).uniform(0, 1, (1000, n)) ** 3).to(dtype)
        card = prng.choice(keys.to(cuda), n, (), p=p.to(cuda))
        assert torch.equal(card.cpu(), prng.choice(keys, n, (), p=p))
    assert torch.equal(prng.choice(keys.to(cuda), n).cpu(), prng.choice(keys, n))


# ---- the VPU-peak kernel (chip_smoke.py's phase 1) ----


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 13, 16])
@pytest.mark.parametrize("mode", ["fma", "select"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("warps", [3, 32])  # 32: the 1,024-thread blocks of the rate sweep
def test_vpu_peak_is_its_plain_version_bit_for_bit(cuda, lanes, mode, fused, warps):
    from blackjax_tpu_torch.ops import vpu_peak as vp

    x = torch.randn((40, vp.COLS), generator=torch.Generator().manual_seed(lanes)).to(cuda)
    before = vp.LAUNCHES["vpu_peak"]
    got = vp.vpu_peak(x, 0.999, 48, mode, fused, lanes=lanes, warps=warps)
    assert vp.LAUNCHES["vpu_peak"] == before + 1
    assert torch.equal(got, vp.vpu_peak_plain(x, 0.999, 48, mode, fused))
    assert torch.equal(got.cpu(), vp.vpu_peak_plain(x.cpu(), 0.999, 48, mode, fused))


def test_vpu_peak_refuses_what_it_does_not_instantiate(cuda):
    from blackjax_tpu_torch.ops import vpu_peak as vp

    x = torch.zeros((8, vp.COLS), device=cuda)
    with pytest.raises(ValueError, match="lanes"):
        vp.vpu_peak(x, 0.999, 4, lanes=3)
    with pytest.raises(ValueError, match="warps"):
        vp.vpu_peak(x, 0.999, 4, warps=33)
    # about 0.5 ms for the shorter call: a slope well above launch jitter
    rate = vp.updates_per_second("fma", False, 4, 8, 65536, device=cuda)
    assert 0 < rate < 1e14


# ---- the SG-MCMC slice on the card (chip_smoke.py's phase 18) ----


@pytest.mark.parametrize("name", ["sgld", "sghmc", "sgnht", "csgld"])
def test_sgmcmc_on_the_card_is_the_cpu_run(cuda, name):
    """Phase 18's f64 hold at 8 chains x 6 steps: minibatch indices
    identical, positions within 1e-12, everything on the card."""
    import chip_smoke
    from blackjax_tpu_torch import prng

    import blackjax_tpu_torch

    X, y = chip_smoke.sgld_dataset(torch, prng, "cpu", torch.float64)
    runs = [chip_smoke.sgmcmc_chains(torch, blackjax_tpu_torch, prng, X.to(device), y.to(device),
                                     name, 8, 6, 32, trace=True)
            for device in (cuda, torch.device("cpu"))]
    (state, idx, path), (cpu_state, cpu_idx, cpu_path) = runs
    assert idx.is_cuda and all(p.is_cuda for p in path)
    assert torch.equal(idx.cpu(), cpu_idx)
    for a, b in zip(path, cpu_path):
        assert float((a.cpu() - b).abs().max()) <= 1e-12


def test_sgld_dataset_on_the_card_is_the_cpu_one(cuda):
    import chip_smoke
    from blackjax_tpu_torch import prng

    X, y = chip_smoke.sgld_dataset(torch, prng, cuda, torch.float32)
    cX, cy = chip_smoke.sgld_dataset(torch, prng, "cpu", torch.float32)
    assert X.is_cuda and y.is_cuda and X.shape == (4096, 54)
    assert int((y.cpu() != cy).sum()) == 0
    assert float((X.cpu() - cX).abs().max()) <= 1e-5

