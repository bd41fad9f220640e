"""The dc machine's shared-memory layout and the kernels' build directory,
on the CPU: no kernel is built or launched here.

``shared_memory_plan`` mirrors ``block_bytes`` in
``csrc/fused_nuts_dc.cuh``; ``tests/test_torch_cuda.py`` holds the two
against each other on the card.
"""
import pytest

torch = pytest.importorskip("torch")

from blackjax_tpu_torch.ops import _nvcc  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as dc  # noqa: E402

LIMIT = 232_448  # a Hopper block's shared memory


def _before(n, family, metric, max_depth):
    """A block's bytes before X could be staged: each of four warps holds
    its checkpoint slots and, for a matrix target, a scratch of 3 N 32 + 32
    floats."""
    slots = 2 * max_depth * n * 32 if metric == "diag" else (3 * max_depth + 1) * n * 32
    scratch = 0 if family in (dc._CUDA_HIERARCHICAL, dc._CUDA_GAUSSIAN) else 3 * n * 32 + 32
    return 4 * 4 * (slots + scratch)


def test_full_size_horseshoe_stages_x_in_shared_memory():
    """The 100 x 200 horseshoe (d=404, N=13) at max_depth 10: the warps'
    slots and trimmed scratch (149,760 B) and X at a row stride of 204
    (81,600 B) fit in a block."""
    plan = dc.shared_memory_plan(dc._register_width(404), dc._CUDA_HORSESHOE, "diag", 10,
                                 100, 200)
    assert plan == dc.SharedMemoryPlan("shared", 4 * 4 * (2 * 10 * 416 + 1040) + 4 * 100 * 204)
    assert plan.nbytes <= LIMIT == dc.SHARED_MEMORY_LIMIT
    # the scratch as it was (beta in N x 32 floats, the row chunk apart)
    # would not have fit
    assert _before(13, dc._CUDA_HORSESHOE, "diag", 10) + 4 * 100 * 204 > LIMIT


@pytest.mark.parametrize("rows, cols, max_depth, form", [
    (400, 200, 10, "l2"),  # X alone is 326,400 B
    (100, 200, 11, "l2"),  # one more level of slots tips it over
    (37, 48, 6, "shared"),  # rows % 32 != 0, stride 52
    (12, 16, 10, "shared"),
])
def test_horseshoe_form_follows_the_byte_count(rows, cols, max_depth, form):
    d = 2 * cols + 4
    n = dc._register_width(d)
    plan = dc.shared_memory_plan(n, dc._CUDA_HORSESHOE, "diag", max_depth, rows, cols)
    warps = 4 * 4 * (2 * max_depth * n * 32 + 2 * n * 32 + 16 * n)
    stride = {200: 204, 48: 52, 16: 20}[cols]  # a multiple of 4 that is 4 mod 8
    x_floats = rows * stride
    assert plan.x_form == form
    assert plan.nbytes == (warps + 4 * x_floats if form == "shared" else warps)
    assert (warps + 4 * x_floats <= LIMIT) == (form == "shared")


@pytest.mark.parametrize("metric", ["dense", "low_rank"])
def test_rich_metric_horseshoe_stages_x(metric):
    """The dense and low-rank machines' horseshoe at 12 x 16 (d=36, N=2)
    keeps its checkpoint slots for m, msum and w, and stages X."""
    plan = dc.shared_memory_plan(2, dc._CUDA_HORSESHOE, metric, 6, 12, 16)
    assert plan == dc.SharedMemoryPlan("shared", 4 * 4 * (19 * 64 + 160) + 4 * 12 * 20)


# logistic regression takes the tiles form (tests/test_torch_dc_tiles.py),
# the analytic targets up to d = 256 the resident form
# (tests/test_torch_dc_resident.py)
@pytest.mark.parametrize("family, d, metric, max_depth, rows, cols, x_form", [
    (dc._CUDA_EIGHT_SCHOOLS, 10, "diag", 8, 0, 0, None),
    (dc._CUDA_HIERARCHICAL, 404, "diag", 8, 0, 0, None),
    (dc._CUDA_GAUSSIAN, 512, "diag", 10, 0, 0, None),
])
def test_other_targets_keep_their_layout(family, d, metric, max_depth, rows, cols, x_form):
    n = dc._register_width(d)
    plan = dc.shared_memory_plan(n, family, metric, max_depth, rows, cols)
    assert plan == dc.SharedMemoryPlan(x_form, _before(n, family, metric, max_depth))


@pytest.mark.parametrize("d, n", [(1, 1), (32, 1), (33, 2), (100, 4), (256, 8), (257, 13),
                                  (404, 13), (416, 13), (417, 16), (512, 16)])
def test_register_width_is_the_instantiation(d, n):
    assert dc._register_width(d) == n


def test_build_directory_follows_the_environment(tmp_path, monkeypatch):
    """Libraries and their logs go where BLACKJAX_TPU_TORCH_BUILD_DIR says,
    and into the package's _build/ where it is unset."""
    monkeypatch.delenv(_nvcc.BUILD_DIR_ENV, raising=False)
    default = _nvcc._paths("fused_nuts_dc")
    assert default[1].parent == _nvcc._PACKAGE / "_build" == default[2].parent
    out = tmp_path / "cache" / "kernels"
    monkeypatch.setenv(_nvcc.BUILD_DIR_ENV, str(out))
    src, lib, log = _nvcc._paths("fused_nuts_dc")
    assert lib.parent == out == log.parent
    assert lib.name == default[1].name and src == default[0]
    assert not out.exists()  # made by the build, with its parents
