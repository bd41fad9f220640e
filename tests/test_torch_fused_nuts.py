"""The port's older NUTS machine (``ops.fused_nuts``: its plain version,
which ``fused_nuts_run`` takes for CPU tensors) against the Pallas kernel
``blackjax_tpu.ops.fused_nuts.fused_nuts_run`` in interpret mode.

Both draw the same counter-based threefry numbers, so they are held chain by
chain, as ``test_torch_fused_nuts_dc.py`` holds the dc machine: identical
steps and gradient totals, and the share of chains whose final position and
history agree to 1e-5 at least ``AGREE_FLOOR`` (measured: every chain, and
the largest difference under 1e-6 on the Gaussian). Configurations: the
reference test's 4-dim Gaussian cut to 8 chains x 8 transitions (also with
``trace=32``, every column held), the hierarchical target at d=100 on 8
chains x 4, logistic regression, and a budget small enough that chains
exhaust it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import fused_nuts as ref  # noqa: E402
from blackjax_tpu.ops.fused_leapfrog import (  # noqa: E402
    make_gaussian_target,
    make_logistic_regression_target,
)
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts as port  # noqa: E402
from test_torch_fused_nuts_dc import (  # noqa: E402
    AGREE_FLOOR,
    agreeing_chains,
    reference_at_opt0,
)

C = 8
VAR = [1.0, 4.0, 0.25, 2.0]


def _logreg_data(n, d):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


# name: (reference target, step size, scale of the initial positions, num_steps,
# max_num_doublings, budget, chunk, trace)
CASES = {
    "gaussian": (make_gaussian_target(4, jnp.asarray(VAR)), 0.4, 0.2, 8, 6, 256, 32, 32),
    "hierarchical": (ref.make_mxu_safe_hierarchical_target(100), 0.2, 0.5, 4, 6, 128, 32, 0),
    "logreg": (make_logistic_regression_target(*_logreg_data(23, 12)), 0.3, 0.5, 6, 5,
               192, 32, 0),
    "budget": (make_gaussian_target(4, jnp.asarray(VAR)), 0.4, 0.2, 8, 6, 24, 8, 0),
}


def _x0(d, scale):
    return (scale * np.random.default_rng(0).standard_normal((C, d))).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    ref_target, step_size, scale, S, doublings, budget, chunk, trace = CASES[request.param]
    d = ref_target.dim
    x0 = _x0(d, scale)
    kw = dict(num_steps=S, max_num_doublings=doublings, seed=3, num_track=min(d, 8),
              budget=budget, chunk=chunk, trace=trace)
    out_ref = reference_at_opt0(
        ref.fused_nuts_run, jnp.asarray(x0), jnp.ones(d), step_size=step_size, target=ref_target,
        tile_chains=8, interpret=True, **kw)
    target = interop.fused_target(ref_target.name, d, ref_target.params)
    before = dict(port.LAUNCHES)
    out_port = port.fused_nuts_run(torch.from_numpy(x0), torch.ones(d), step_size,
                                   target=target, **kw)
    assert port.LAUNCHES == before, "a CPU call must not count a kernel launch"
    return request.param, out_ref, out_port, S


def test_steps_and_grads_identical(runs):
    name, out_ref, out_port, S = runs
    np.testing.assert_array_equal(out_port[3].numpy(), np.asarray(out_ref[3]))
    assert float(out_port[2]) == float(out_ref[2])
    if name == "budget":
        assert int(out_port[3].min()) < S, "the budget must cut some chain short"
    else:
        assert bool((out_port[3] == S).all())


def test_chains_agree_with_the_pallas_kernel(runs):
    name, out_ref, out_port, _ = runs
    assert out_port[0].shape == out_ref[0].shape and out_port[1].shape == out_ref[1].shape
    assert agreeing_chains(out_ref, out_port).mean() >= AGREE_FLOOR


def test_trace_columns_match_the_reference(runs):
    name, out_ref, out_port, _ = runs
    if CASES[name][-1] == 0:
        assert len(out_port) == 4
        return
    traces_ref, traces_port = out_ref[4], out_port[4]
    assert set(traces_port) == set(port.TRACE_COLS) == set(ref.TRACE_COLS)
    for col in port.TRACE_COLS:
        a, b = np.asarray(traces_ref[col]), traces_port[col].numpy()
        assert b.shape == a.shape, col
        same = np.isclose(b, a, rtol=1e-5, atol=1e-5, equal_nan=True).all(axis=0)
        assert same.mean() >= AGREE_FLOOR, col


def test_unreached_history_rows_stay_zero(runs):
    name, _, out_port, S = runs
    _, hist, _, steps = out_port[:4]
    for c in range(C):
        assert not hist[c, int(steps[c]):].any()


def test_mxu_safe_target_logdensity_matches_reference():
    d = 100
    x = np.random.default_rng(1).standard_normal((16, d)).astype(np.float32)
    ref_target = ref.make_mxu_safe_hierarchical_target(d)
    target = port.make_mxu_safe_hierarchical_target(d)
    assert target.name == ref_target.name == "hierarchical_gaussian_mxu_safe"
    expected = np.asarray(ref_target.logdensity_fn(jnp.asarray(x)))
    np.testing.assert_allclose(target.logdensity_fn(torch.from_numpy(x)).numpy(), expected,
                               rtol=1e-5, atol=1e-5)
    carried = interop.fused_target(ref_target.name, d, ref_target.params)
    assert carried.name == ref_target.name and carried.dim == d


def test_default_budget_and_errors():
    target = port.make_mxu_safe_hierarchical_target(8)
    x = torch.zeros(4, 8)
    out = port.fused_nuts_run(x, torch.ones(8), 0.2, target=target, num_steps=2, num_track=3)
    assert out[1].shape == (4, 2, 3) and bool((out[3] == 2).all())
    with pytest.raises(ValueError, match="num_track"):
        port.fused_nuts_run(x, torch.ones(8), 0.2, target=target, num_steps=2, num_track=9)
    with pytest.raises(ValueError, match="registered target dim"):
        port.fused_nuts_run(torch.zeros(4, 5), torch.ones(5), 0.2, target=target, num_steps=2)
