"""The port's matrix-class targets against the JAX package.

- ``finnish_horseshoe`` and ``logistic_regression`` (models): log density
  and gradient against the reference's ``logdensity_fn`` and ``jax.grad`` in
  f64, to rtol 1e-10 (measured: 5e-16 and 2e-15 relative). The horseshoe's
  data are rebuilt from the same numpy seed, bit for bit.
- The machine's three targets (``ops/targets_dc.py``): the plain
  ``value_and_grad`` against the reference tiles' ``vg_tile``, run outside
  Pallas as ``tests/ops/test_targets_dc.py`` runs them, in f32 on the same
  inputs. Both follow the same formulas in the same order; what differs is
  the order of the sums inside the contractions (``torch.matmul`` against
  XLA's dot), so values agree to rtol 1e-5 (measured: at most 4e-7
  relative in the log density; 1.2e-6 for the horseshoe's gradient).
- The permutations, the ``M % 8`` refusal, and ``interop``'s rebuilding of
  each target from the reference's name and params.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.models import targets as jtargets  # noqa: E402
from blackjax_tpu.ops import targets_dc as jdc  # noqa: E402
from blackjax_tpu.ops.fused_leapfrog import _round_up  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.models import targets  # noqa: E402
from blackjax_tpu_torch.ops import targets_dc  # noqa: E402

RTOL_F64 = 1e-10
RTOL_F32 = 1e-5
T = 8  # chains for the tile checks


def _value_and_grad_f64(port_fn, x):
    t = torch.from_numpy(x).requires_grad_()
    ld = port_fn(t)
    (g,) = torch.autograd.grad(ld.sum(), t)
    return ld.detach().numpy(), g.numpy()


def _check_model(ref, port, x):
    # one compiled call each: run eagerly, every primitive compiles on its own
    ld_ref = np.asarray(jax.jit(jax.vmap(ref.logdensity_fn))(jnp.asarray(x)))
    g_ref = np.asarray(jax.jit(jax.vmap(jax.grad(ref.logdensity_fn)))(jnp.asarray(x)))
    ld, g = _value_and_grad_f64(port.logdensity_fn, x)
    np.testing.assert_allclose(ld, ld_ref, rtol=RTOL_F64)
    np.testing.assert_allclose(g, g_ref, rtol=RTOL_F64, atol=RTOL_F64 * np.abs(g_ref).max())
    assert (port.name, port.dim) == (ref.name, ref.dim)


@pytest.mark.parametrize("N, M", [(12, 16), (100, 200)])
def test_finnish_horseshoe_matches_reference(N, M):
    ref, port = jtargets.finnish_horseshoe(N, M), targets.finnish_horseshoe(N, M)
    x = 0.3 * np.random.default_rng(N).standard_normal((5, ref.dim))
    _check_model(ref, port, x)
    # the same data: the reference's folded vectors and padded X, bit for bit
    X, y = targets.horseshoe_data(N, M)
    X_pad = np.asarray(jdc.make_finnish_horseshoe_target_dc(N, M).params[2])
    np.testing.assert_array_equal(X_pad[:N], X)
    assert interop.target(ref.name).name == ref.name


def test_logistic_regression_matches_reference():
    ref, X, y = jtargets.logistic_regression(jax.random.key(3), num_points=23, dim=12)
    port, pX, py = targets.logistic_regression(X=np.asarray(X), y=np.asarray(y))
    assert (port.name, port.dim) == (ref.name, ref.dim)
    w = np.random.default_rng(1).standard_normal((6, 12))
    _check_model(ref, port, w)
    np.testing.assert_array_equal(pX.numpy(), np.asarray(X))
    # drawn from a torch.Generator instead: the same shapes, binary labels
    own, oX, oy = targets.logistic_regression(torch.Generator().manual_seed(0), 40, 5)
    assert oX.shape == (40, 5) and set(oy.unique().tolist()) <= {0.0, 1.0}
    assert own.logdensity_fn(torch.zeros(3, 5)).shape == (3,)


# ---- the machine's targets against the reference tiles ----


def _tile_harness(target, positions):
    """The runner's operand preparation (``tests/ops/test_targets_dc.py``):
    positions ``(C, d)`` -> ``x (d_pad, C)``, the row mask and padded
    params."""
    C, d = positions.shape
    d_pad = _round_up(d, 8)
    x = jnp.pad(jnp.asarray(positions, jnp.float32).T, ((0, d_pad - d), (0, 0)))
    mask = (jax.lax.broadcasted_iota(jnp.int32, (d_pad, C), 0) < d).astype(jnp.float32)
    params = []
    for p in target.params:
        a = jnp.asarray(p, jnp.float32)
        if a.ndim == 1:
            rows = _round_up(a.shape[0], 8)
            a = jnp.broadcast_to(jnp.pad(a, (0, rows - a.shape[0]))[:, None], (rows, C))
        params.append(a)
    return x, mask, tuple(params)


def _logreg_data(n, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


DC_CASES = {
    "logreg": (lambda: jdc.make_logreg_target_dc(*_logreg_data(23, 12)), 0.5),
    "horseshoe": (lambda: jdc.make_finnish_horseshoe_target_dc(12, 16), 0.3),
    "eight_schools": (jdc.make_eight_schools_target_dc, 0.5),
}


@pytest.mark.parametrize("case", sorted(DC_CASES))
def test_dc_value_and_grad_matches_reference_tiles(case):
    make, scale = DC_CASES[case]
    ref = make()
    port = interop.target_dc(ref.name, ref.dim, ref.params)
    assert (port.name, port.dim) == (ref.name, ref.dim)
    positions = (scale * np.random.default_rng(4).standard_normal((T, ref.dim))).astype(np.float32)
    x, mask, params = _tile_harness(ref, positions)
    ld_ref, g_ref = jax.jit(ref.vg_tile)(x, mask, *params)
    ld_ref = np.asarray(ld_ref).ravel()
    g_ref = np.asarray(g_ref)[: ref.dim].T
    ld, g = port.value_and_grad(torch.from_numpy(positions))
    assert ld.dtype == torch.float32 and g.shape == positions.shape
    np.testing.assert_allclose(ld.numpy(), ld_ref, rtol=RTOL_F32)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=RTOL_F32,
                               atol=RTOL_F32 * np.abs(g_ref).max())
    # the plain log density in the machine's layout agrees with the tiles
    lp = np.asarray(jax.jit(jax.vmap(ref.logdensity_fn))(jnp.asarray(positions)))
    np.testing.assert_allclose(port.logdensity_fn(torch.from_numpy(positions)).numpy(), lp,
                               rtol=RTOL_F32)
    for a, b in zip(port.params, ref.params):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


def test_permutations_match_reference():
    for M in (16, 200):
        for a, b in zip(targets_dc.horseshoe_dc_perm(M), jdc.horseshoe_dc_perm(M)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(targets_dc.eight_schools_dc_perm(), jdc.eight_schools_dc_perm()):
        np.testing.assert_array_equal(a, b)


# eight schools' machine target keeps y and 1/sigma^2 in f32, as the
# reference's does, against the model's f64 constants: 2.3e-9 measured
@pytest.mark.parametrize("model, make_dc, perm, rtol", [
    (lambda: targets.finnish_horseshoe(12, 16),
     lambda: targets_dc.make_finnish_horseshoe_target_dc(12, 16),
     lambda: targets_dc.horseshoe_dc_perm(16), 1e-10),
    (targets.eight_schools_noncentered, targets_dc.make_eight_schools_target_dc,
     targets_dc.eight_schools_dc_perm, 1e-7),
])
def test_dc_layout_is_the_model_under_the_permutation(model, make_dc, perm, rtol):
    model, dc = model(), make_dc()
    to_dc, from_dc = perm()
    x_model = 0.3 * np.random.default_rng(5).standard_normal((5, model.dim))
    x_dc = x_model[:, to_dc]
    np.testing.assert_allclose(dc.logdensity_fn(torch.from_numpy(x_dc)).numpy(),
                               model.logdensity_fn(torch.from_numpy(x_model)).numpy(),
                               rtol=rtol)
    np.testing.assert_array_equal(x_dc[:, from_dc], x_model)


def test_horseshoe_refuses_unaligned_predictors():
    with pytest.raises(ValueError, match="multiple of 8"):
        targets_dc.make_finnish_horseshoe_target_dc(num_points=12, num_predictors=10)
    with pytest.raises(ValueError, match="multiple of 8"):
        jdc.make_finnish_horseshoe_target_dc(num_points=12, num_predictors=10)


def test_interop_refuses_a_horseshoe_on_other_data():
    ref = jdc.make_finnish_horseshoe_target_dc(12, 16, seed=3)
    with pytest.raises(NotImplementedError, match="default dataset"):
        interop.target_dc(ref.name, ref.dim, ref.params)
