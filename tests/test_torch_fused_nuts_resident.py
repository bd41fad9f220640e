"""The older NUTS machine's two forms (``ops.fused_nuts``), on the CPU: the
wrapper's plan (which form, by width, target, trace and ``form=``) and what
the CPU path counts. No kernel is built or launched here.

Each form's layout is the kernel's own (``csrc/fused_nuts.cu``): the launch
reads its scratch from ``bjt_fused_nuts_scratch_floats``.
``tests/test_torch_cuda.py`` holds that export and the resident form against
the registers form bit for bit on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackjax_tpu_torch.ops import fused_nuts as fn  # noqa: E402
from blackjax_tpu_torch.ops.fused_leapfrog import (  # noqa: E402
    make_gaussian_target,
    make_logistic_regression_target,
)

HIERARCHICAL, GAUSSIAN, LOGREG = 0, 1, 2

@pytest.mark.parametrize("d", [1, 32, 33, 100, 200, 256])
@pytest.mark.parametrize("target", [HIERARCHICAL, GAUSSIAN])
def test_analytic_targets_take_the_resident_form(target, d):
    """Without a trace, the hierarchical and Gaussian targets take the
    resident form at every width the kernel holds, and ask for it."""
    assert fn.plan(d, target) == fn.plan(d, target, form="resident") == "resident"


@pytest.mark.parametrize("d", [1, 33, 100, 256])
@pytest.mark.parametrize("target, trace", [(HIERARCHICAL, 64), (GAUSSIAN, 1), (LOGREG, 0),
                                           (LOGREG, 16)])
def test_trace_and_logistic_regression_take_the_registers_form(target, trace, d):
    """The trace and logistic regression keep the registers form."""
    assert fn.plan(d, target, trace) == "registers"


@pytest.mark.parametrize("d", [1, 32, 33, 100, 200, 256])
@pytest.mark.parametrize("target", [HIERARCHICAL, GAUSSIAN])
def test_registers_form_on_request(target, d):
    """``form="registers"`` takes the registers form on the analytic
    targets too."""
    assert fn.plan(d, target, form="registers") == "registers"


@pytest.mark.parametrize("target, d, trace", [
    (HIERARCHICAL, 100, 64), (GAUSSIAN, 4, 8), (LOGREG, 54, 0), (HIERARCHICAL, 257, 0),
    (GAUSSIAN, 300, 0),
])
def test_resident_form_is_refused_where_it_does_not_apply(target, d, trace):
    """``form="resident"`` raises for the trace, logistic regression and
    d > 256; nothing falls back to the registers form."""
    with pytest.raises(ValueError):
        fn.plan(d, target, trace, form="resident")


@pytest.mark.parametrize("d", [0, 257, 512])
def test_widths_beyond_the_kernel_are_refused(d):
    with pytest.raises(ValueError):
        fn.plan(d, HIERARCHICAL)


def test_unknown_form_is_refused():
    with pytest.raises(ValueError):
        fn.plan(100, HIERARCHICAL, form="tiles")


def _cpu_run(target, d, **kw):
    x = torch.from_numpy((0.5 * np.random.default_rng(0).standard_normal((4, d)))
                         .astype(np.float32))
    return fn.fused_nuts_run(x, torch.ones(d), 0.2, target=target, num_steps=2,
                             num_track=min(d, 2), seed=1, max_num_doublings=4, **kw)


@pytest.mark.parametrize("form", [None, "resident", "registers"])
def test_cpu_tensors_count_no_launch(form):
    """The CPU path runs the plain version in every form and counts no
    launch."""
    before = dict(fn.LAUNCHES)
    out = _cpu_run(fn.make_mxu_safe_hierarchical_target(8), 8, form=form)
    assert fn.LAUNCHES == before
    assert out[0].shape == (4, 8) and bool((out[3] == 2).all())
    reference = _cpu_run(fn.make_mxu_safe_hierarchical_target(8), 8)
    assert all(torch.equal(a, b) for a, b in zip(out, reference))


@pytest.mark.parametrize("case", ["trace", "logreg"])
def test_cpu_run_refuses_the_resident_form_where_it_does_not_apply(case):
    """The request is checked on every device: a CPU run that asks for the
    resident form of the trace or of logistic regression raises."""
    before = dict(fn.LAUNCHES)
    if case == "trace":
        target, d, kw = make_gaussian_target(4, [1.0, 4.0, 0.25, 2.0]), 4, dict(trace=8)
    else:
        rng = np.random.default_rng(2)
        X = rng.standard_normal((23, 12)).astype(np.float32)
        y = (rng.random(23) < 0.5).astype(np.float32)
        target, d, kw = make_logistic_regression_target(X, y), 12, {}
    with pytest.raises(ValueError):
        _cpu_run(target, d, form="resident", **kw)
    assert fn.LAUNCHES == before
