"""The port's main path end to end on the CPU, at d=8 and 16 chains: NUTS
transitions, then the dc machine from those positions, then min-ESS; each
stage held against the JAX package from the same state.

Also checks that no module of ``blackjax_tpu_torch`` imports JAX or the JAX
package: the machine with the card has no JAX.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu import diagnostics as jdiag  # noqa: E402
from blackjax_tpu.ops import fused_nuts_dc as ref_dc  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as port_dc  # noqa: E402
from blackjax_tpu_torch.util import run_inference_algorithm  # noqa: E402

D, C, S = 8, 16, 8
DC = dict(num_steps=S, max_num_doublings=4, seed=7, num_track=D, budget=S * 16, chunk=16)


@pytest.fixture(scope="module")
def slice_run():
    target = interop.target("hierarchical_gaussian", D)
    x0 = torch.from_numpy(0.5 * np.random.default_rng(0).standard_normal((C, D))).float()
    algo = blackjax_tpu_torch.nuts(
        target.logdensity_fn, step_size=0.2, inverse_mass_matrix=torch.ones(D),
        max_num_doublings=4,
    )
    state, _ = run_inference_algorithm(
        torch.Generator().manual_seed(0), algo, 3, initial_position=x0
    )
    positions = state.position
    dc_target = port_dc.make_hierarchical_target_dc(D)
    out = port_dc.fused_nuts_run_dc(
        positions, torch.ones(D), 0.2, target=dc_target, **DC
    )
    out_ref = ref_dc.fused_nuts_run_dc(
        jnp.asarray(positions.numpy()), jnp.ones(D), 0.2,
        target=ref_dc.make_hierarchical_target_dc(D), interpret=True, **DC,
    )
    return positions, out, out_ref


def test_nuts_stage_moves_every_chain(slice_run):
    positions, *_ = slice_run
    assert positions.shape == (C, D) and positions.dtype == torch.float32
    assert torch.isfinite(positions).all()


def test_machine_stage_agrees_with_pallas_chain_by_chain(slice_run):
    from test_torch_fused_nuts_dc import AGREE_FLOOR, agreeing_chains

    _, out, out_ref = slice_run
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(out_ref[3]))
    assert (out[3] == S).all()
    assert agreeing_chains(out_ref, out).mean() >= AGREE_FLOOR


def test_ess_stage_equals_reference_on_the_same_history(slice_run):
    _, out, _ = slice_run
    hist = out[1].double()  # (C, S, k), chains then samples
    got = blackjax_tpu_torch.ess(hist)
    expected = np.asarray(jax.jit(jdiag.effective_sample_size)(jnp.asarray(hist.numpy())))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-10)
    assert float(got.min()) > 0


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    root = Path(blackjax_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 10
    scripts = [root.parent / name for name in (
        "chip_smoke.py", "warmup_ms_per_leaf.py", "dc_kernel_ms.py", "horseshoe_dc_sections.py",
        "logreg_dc_tiles.py", "fused_logreg_tiles.py")]
    for path in files + scripts:
        for name in _imported_modules(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "blackjax_tpu"), f"{path} imports {name}"
