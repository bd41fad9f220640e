"""The fused kernels' tiles form of logistic regression (the chains of a block
sharing each gradient, X streamed through shared memory in tiles), on the
CPU: X's layout in tiles, the shared-memory plan, and a plain PyTorch model
of the block gradient's order of work held against the reference's tile
functions. No kernel is built or launched here; ``tests/test_torch_cuda.py``
holds both kernels against their plain versions and the kernels' own layout
export (``bjt_fused_tiles_layout``, which the wrappers read) against the
counts below on the card.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import make_logistic_regression_target as jmake_logreg  # noqa: E402

fl = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")

LIMIT = 232_448  # a Hopper block's shared memory
TOL = 1e-5


def _data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


def _plan_from_parts(d, K, R_max):
    """The block's bytes, counted from its parts: N registers a lane and
    vector (1, 2, 4, 8), tiles of R = min(R_max, the cap for N, 32 K) rows at
    a row stride of round_up(d, 4) that is 4 mod 8, two of them in the ring
    (or the backward pass's partial sums, min(16 / N, K) chains x K x 32 N
    floats, if larger), the positions (round_up(d, 4) x K) and the backward
    pass's weights (R x K)."""
    n = {1: 1, 2: 2, 3: 4, 4: 4}.get(-(-d // 32), 8)
    R = min(R_max, {1: 256, 2: 256, 4: 128, 8: 64}[n], 32 * K)
    stride = -(-d // 4) * 4
    stride += 4 if stride % 8 == 0 else 0
    back = min(16 // n, K) * K * 32 * n
    d4 = -(-d // 4) * 4
    return fl.TilesPlan(K, R, 4 * (max(2 * R * stride, back) + d4 * K + R * K))


# rows a tile and bytes a block of each (d, K) of the chains' sweep
# (fused_logreg_tiles.py --chains), at most 256 rows a tile (kFusedTileRowsLR)
SWEEP = {
    (12, 8): (256, 33_152), (12, 16): (256, 49_920), (12, 32): (256, 99_840),
    (54, 8): (256, 132_864), (54, 16): (256, 142_848), (54, 32): (256, 162_816),
    (200, 8): (64, 112_896), (200, 16): (64, 121_344), (200, 32): (64, 138_240),
}


@pytest.mark.parametrize("K", [8, 16, 32])
@pytest.mark.parametrize("d", [12, 54, 200])
def test_plan_matches_a_count_from_its_parts(d, K):
    """The layout at each number of chains a block of the sweep, counted from
    its parts, against the bytes listed for it, and a block that fits in a
    Hopper block's shared memory. The GPU tests hold the kernels' own count
    at K = 16 against the same list."""
    plan = _plan_from_parts(d, K, 256)
    assert plan == fl.TilesPlan(K, *SWEEP[(d, K)])
    assert plan.nbytes <= LIMIT


def test_phase_9_block():
    """4,096 x 54 at sixteen chains a block: the ring of two 256-row tiles at
    a stride of 60 floats (122,880 B), the positions (3,584 B) and the
    backward pass's weights (16,384 B)."""
    assert _plan_from_parts(54, 16, 256) == fl.TilesPlan(16, 256, 122_880 + 3_584 + 16_384)


@pytest.mark.parametrize("n, d, tile_rows, stride", [
    (23, 12, 256, 12), (300, 54, 256, 60), (4096, 54, 256, 60), (300, 200, 64, 204),
])
def test_x_is_laid_out_in_whole_tiles_beside_y(monkeypatch, n, d, tile_rows, stride):
    """X as the fused kernels' tiles form copies it, at the tile rows the
    kernels give the width: every tile one contiguous run of 16-byte words,
    rows padded with zeros to a whole tile and columns to the stride (4 mod
    8 floats); y beside it with one label a data row, and the row count the
    kernel masks by, n: the padded rows are never read as data."""
    X, y = _data(n, d)
    target = fl.make_logistic_regression_target(X, y)
    assert _plan_from_parts(d, 16, 256).tile_rows == tile_rows
    monkeypatch.setattr(fl, "tiles_plan", lambda d: fl.TilesPlan(16, tile_rows, 0))
    inv_var, (tiles, y_dev), rows, k = fl._tiles_target_args(target, torch.device("cpu"), d)
    assert inv_var is None and rows == n
    assert k == pytest.approx((0.01, -0.005))
    assert tiles.shape == (-(-n // tile_rows) * tile_rows, stride)
    assert tiles.dtype == torch.float32 and tiles.is_contiguous()
    assert stride % 8 == 4 and (tile_rows * stride) % 4 == 0
    np.testing.assert_array_equal(tiles[:n, :d].numpy(), X)
    assert not tiles[n:].any() and not tiles[:, d:].any()
    np.testing.assert_array_equal(y_dev.numpy(), y)


def test_analytic_targets_pass_no_data():
    target = fl.make_gaussian_target(4, [1.0, 2.0, 3.0, 4.0])
    inv_var, matrix, rows, k = fl._tiles_target_args(target, torch.device("cpu"), 4)
    assert matrix == (None, None) and rows == 0 and k == (0.0, 0.0)
    np.testing.assert_allclose(inv_var.numpy(), [1.0, 0.5, 1 / 3, 0.25], rtol=1e-7)


def _block_model(X, y, W, k0, k1, K, R, spell):
    """The block gradient in the kernel's order of work, in f32: the chains
    in blocks of K (a partial last block padded with parked chains at w =
    0, whose results are dropped); X in tiles of R rows; per tile the
    forward pass sums each (row, chain) logit over the columns in order and
    adds the row's log-density term to that row's partial sum; the backward
    pass adds X[r] st[r] over the rows r = rho, rho + BC, ... of each of the
    BC row groups; after the last tile the row groups' partial sums are
    added in order, and the rows' log-density partial sums. Returns the
    gradient (spell "grad") or the log density (spell "value")."""
    n, d = X.shape
    C = W.shape[0]
    n_reg = {1: 1, 2: 2, 3: 4, 4: 4}.get(-(-d // 32), 8)
    BC = min(16 // n_reg, K)
    Xt = torch.from_numpy(X)
    yt = torch.from_numpy(y)
    blocks = -(-C // K)
    Wp = torch.zeros(blocks * K, d)
    Wp[:C] = torch.from_numpy(W)
    out = []
    for b in range(blocks):
        w = Wp[b * K:(b + 1) * K]  # (K, d)
        back = torch.zeros(BC, K, d)
        rows_ld = torch.zeros(R, K)
        for t0 in range(0, n, R):
            xt = Xt[t0:t0 + R]
            q = torch.zeros(xt.shape[0], K)
            for j in range(d):
                q = q + xt[:, j:j + 1] * w[:, j]
            yy = yt[t0:t0 + R, None]
            s = yy - torch.sigmoid(q)
            zero = torch.zeros_like(q)
            rows_ld[:xt.shape[0]] += yy * q - torch.logaddexp(zero, q)
            for i in range(0, xt.shape[0], BC):
                xr, sr = xt[i:i + BC], s[i:i + BC]
                back[:xr.shape[0]] += sr[:, :, None] * xr[:, None, :]
        if spell == "grad":
            g = back[0]
            for i in range(1, BC):
                g = g + back[i]
            out.append(g - k0 * w)
        else:
            out.append(rows_ld.sum(0) + k1 * (w * w).sum(1))
    return torch.cat(out)[:C].numpy()


@pytest.fixture(scope="module")
def reference():
    """The reference's tile functions at each case's data, built once."""
    cache = {}

    def get(n, d):
        if (n, d) not in cache:
            X, y = _data(n, d, seed=n + d)
            cache[(n, d)] = (X, y, jmake_logreg(X, y))
        return cache[(n, d)]

    return get


@pytest.mark.parametrize("spell", ["grad", "value"])
@pytest.mark.parametrize("n, d, C, K", [
    (23, 12, 37, 16), (300, 12, 16, 16), (300, 54, 21, 8), (4096, 54, 40, 32), (4096, 12, 5, 16),
])
def test_block_model_matches_reference_tiles(reference, n, d, C, K, spell):
    """The block gradient's order of work (tiles of R rows, chains in blocks
    of K with parked chains in a partial last block, row groups added in
    order) against the reference's ``grad_tile`` and ``logdensity_tile``
    (``blackjax_tpu.ops.make_logistic_regression_target``) at f32, rtol
    1e-5."""
    X, y, ref = reference(n, d)
    R = _plan_from_parts(d, K, 256).tile_rows
    W = (0.3 * np.random.default_rng(C).standard_normal((C, d))).astype(np.float32)
    mask = jnp.ones((1, d), jnp.float32)
    params = [jnp.asarray(p) for p in ref.params]
    if spell == "grad":
        want = np.asarray(ref.grad_tile(jnp.asarray(W), mask, *params))
    else:
        want = np.asarray(ref.logdensity_tile(jnp.asarray(W), mask, *params))
    got = _block_model(X, y, W, 0.01, -0.005, K, R, spell)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())
