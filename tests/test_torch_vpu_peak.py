"""The port's ``ops.vpu_peak`` against the JAX package's VPU-peak kernel.

The reference's ``_kernel`` (``benchmarks/vpu_peak.py:41-54``) runs here in
``pallas_call(..., interpret=True)`` with ``_run``'s block specs. On the CPU
its ``fma`` mode contracts ``x * a + b`` into one rounding and its
``select`` mode rounds twice, so ``fma`` is held against the plain
version's fused form and ``select`` against its unfused form, bit for bit.
The fused form is also held against the correctly rounded ``x * a + b`` of
exact rationals, and the wrapper's CPU path, its refusals and the kernel's
source are checked without a card.
"""
import functools
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from benchmarks import vpu_peak as reference  # noqa: E402
from blackjax_tpu_torch.ops import vpu_peak as vp  # noqa: E402

A = 0.999


def _reference_run(x, mode, iters):
    rows = x.shape[0]
    return pl.pallas_call(
        functools.partial(reference._kernel, iters=iters, mode=mode),
        out_shape=jax.ShapeDtypeStruct((rows, reference.COLS), jnp.float32),
        in_specs=[
            pl.BlockSpec((rows, reference.COLS), lambda: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.SMEM),
        ],
        out_specs=pl.BlockSpec((rows, reference.COLS), lambda: (0, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(x, jnp.full((1,), A, jnp.float32))


def _block(rows, seed):
    rng = np.random.default_rng(seed)
    return (0.5 + 0.01 * rng.standard_normal((rows, vp.COLS))).astype(np.float32)


@pytest.mark.parametrize("mode", vp.MODES)
@pytest.mark.parametrize("rows,iters", [(8, 16), (64, 64)])
def test_plain_matches_the_reference_kernel_bit_for_bit(mode, rows, iters):
    x = _block(rows, rows + iters)
    expected = np.asarray(_reference_run(jnp.asarray(x), mode, iters))
    got = vp.vpu_peak_plain(torch.from_numpy(x), A, iters, mode, fused=mode == "fma")
    np.testing.assert_array_equal(got.numpy().view(np.int32), expected.view(np.int32))
    # the other rounding parts from it: the hold sees the rounding
    other = vp.vpu_peak_plain(torch.from_numpy(x), A, iters, mode, fused=mode != "fma")
    assert mode == "select" or not np.array_equal(other.numpy(), expected)


def test_fused_form_is_the_correctly_rounded_fma():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 2.0 ** rng.integers(-8, 9, 4096)).astype(np.float32)
    a = np.float32(rng.standard_normal())
    b = (rng.standard_normal(4096) * 2.0 ** rng.integers(-20, 21, 4096)).astype(np.float32)
    got = vp._fma_plain(torch.from_numpy(x), torch.tensor(a), torch.from_numpy(b)).numpy()
    for xi, bi, gi in zip(x[:512], b[:512], got[:512]):
        exact = Fraction(float(xi)) * Fraction(float(a)) + Fraction(float(bi))
        below = np.float32(float(exact))  # nearest double, then float32: checked below
        candidates = [np.nextafter(below, np.float32(-np.inf)), below,
                      np.nextafter(below, np.float32(np.inf))]
        best = min(candidates, key=lambda c: (abs(Fraction(float(c)) - exact),
                                              int(np.float32(c).view(np.int32)) & 1))
        assert gi == best
    # and it is one rounding: the unfused product-then-sum parts from it somewhere
    unfused = (torch.from_numpy(x) * torch.tensor(a) + torch.from_numpy(b)).numpy()
    assert (unfused != got).any()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_block(8, 0))
    before = dict(vp.LAUNCHES)
    out = vp.vpu_peak(x, A, 20, "select", fused=False)
    assert torch.equal(out, vp.vpu_peak_plain(x, A, 20, "select", fused=False))
    assert vp.LAUNCHES == before  # the CPU path launches nothing


def test_wrapper_refuses_other_shapes_modes_and_devices():
    with pytest.raises(ValueError, match="mode"):
        vp.vpu_peak(torch.zeros(8, vp.COLS), A, 1, "fmadd")
    with pytest.raises(ValueError, match="float32"):
        vp.vpu_peak(torch.zeros(8, 64), A, 1)
    with pytest.raises(ValueError, match="float32"):
        vp.vpu_peak(torch.zeros(8, vp.COLS, dtype=torch.float64), A, 1)
    with pytest.raises(NotImplementedError, match="meta"):
        vp.vpu_peak(torch.zeros(8, vp.COLS, device="meta"), A, 1)


def test_block_rows_fill_every_sm():
    assert vp.block_rows(132, 4, 32) * vp.COLS == 132 * 32 * 32 * 4
    assert vp.block_rows(132, 13, 20) == 132 * 20 * 32 * 13 // vp.COLS
    with pytest.raises(ValueError, match="whole rows"):
        vp.block_rows(1, 1, 1)


def test_source_instantiates_every_lane_count_with_both_roundings():
    src = (vp._nvcc._SRC_DIR / "vpu_peak.cu").read_text()
    assert "__fmaf_rn" in src and "__fmul_rn" in src and "__fadd_rn" in src
    for n in vp.LANES:
        assert f"case {n}: return launch_n<{n}>" in src
