"""The port's moment-block buffer layer (``adaptation.metric_buffers``) and
the ``draws_svd_low_rank`` recipe over its raw-draw ring, against the JAX
package in float64 on the same numpy-seeded inputs, within 1e-12:

- ``cgl_merge_two`` with an empty block on either side, both empty and both
  full; ``cgl_update_batch`` into an empty and a filled block;
  ``merge_block_ring`` of one slot and of three (one empty);
  ``diag_from_moment_block`` at counts 0, 1 and 2; each diagonal and dense;
- every policy (``reset_window_buffer``, ``accumulating_split_pop_buffer``,
  ``ensemble_batch_buffer``, ``late_start``, ``raw_draw_ring_buffer`` and
  the raw ring a policy builds with ``requires_draws``) through one fixed
  sequence of ``update``s and ``push_split``s, its state, moments, support
  and diagonal reference after every operation;
- the ``draws_svd_low_rank`` core's ``init``/``update``/``final`` on fixed
  draws (the payload's operator ``U diag(lam) U^T``, never ``U``, whose
  columns carry arbitrary signs), and ``lookup_recipe``;
- the guards.

The reference side is compiled once for the module, as one program, at
XLA's optimization level 0 with the older CPU fusion emitters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.adaptation import metric_buffers as jbuf  # noqa: E402
from blackjax_tpu.adaptation import metric_recipes as jrecipes  # noqa: E402
from blackjax_tpu_torch.adaptation import metric_buffers as buf  # noqa: E402
from blackjax_tpu_torch.adaptation import metric_recipes as recipes  # noqa: E402

D = 5
TOL = 1e-12
F64 = torch.float64


def _close(got, expected, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), rtol=tol, atol=tol)


def _close_tree(got, expected):
    if isinstance(got, tuple):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            _close_tree(g, e)
    else:
        _close(got, expected)


def _draws(n, seed, d=D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) * np.linspace(0.5, 3.0, d) + np.arange(d)


def _block(draws, diagonal):
    """A block of ``draws`` (None: an empty block), both packages'."""
    if draws is None:
        count, mean, m2 = 0.0, np.zeros(D), np.zeros((D,) if diagonal else (D, D))
    else:
        count, mean = float(draws.shape[0]), draws.mean(0)
        c = draws - mean
        m2 = (c**2).sum(0) if diagonal else c.T @ c
    return (buf.MomentBlock(torch.tensor(count, dtype=F64), torch.from_numpy(mean),
                            torch.from_numpy(m2)),
            jbuf.MomentBlock(jnp.asarray(count), jnp.asarray(mean), jnp.asarray(m2)))


FORMS = ["diagonal", "dense"]


def _jit(fn):
    """``jax.jit`` at XLA's optimization level 0, with XLA's older CPU fusion
    emitters (a third less compile time here)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_cpu_use_fusion_emitters": False})


# the direct functions' cases: (function, form, its inputs' draws); None is
# an empty block
FUNCTION_CASES = (
    [("cgl_merge_two", form, (a, b)) for form in FORMS
     for a, b in ((None, 7), (6, None), (None, None), (6, 7))]
    + [("cgl_update_batch", form, (start,)) for form in FORMS for start in (None, 9)]
    + [("merge_block_ring", form, sizes) for form in FORMS for sizes in ((8,), (8, None, 5))]
    + [("diag_from_moment_block", form, (count or None,)) for form in FORMS
       for count in (0, 1, 2)]
)
BATCH = _draws(11, 4)


def _case_id(case):
    return f"{case[0]}-{case[1]}-" + "-".join(str(n) for n in case[2])


def _call(module, case, port):
    """``case``'s function of ``module`` on its inputs (``port``: the port's
    tensors, else the reference's arrays)."""
    name, form, sizes = case
    blocks = [_block(None if n is None else _draws(n, 10 + i), form == "diagonal")[0 if port else 1]
              for i, n in enumerate(sizes)]
    if name == "cgl_update_batch":
        return module.cgl_update_batch(blocks[0], torch.from_numpy(BATCH) if port
                                       else jnp.asarray(BATCH))
    if name == "merge_block_ring":
        stack = torch.stack if port else jnp.stack
        return module.merge_block_ring(*(stack([b[f] for b in blocks]) for f in range(3)))
    return getattr(module, name)(*blocks)


@pytest.mark.parametrize("case", FUNCTION_CASES, ids=_case_id)
def test_function_matches_the_reference(references, case):
    got = _call(buf, case, port=True)
    _close_tree(got, references["functions"][FUNCTION_CASES.index(case)])
    name, _, sizes = case
    if name == "cgl_merge_two" and None not in sizes:  # the pooled draws' statistics
        pooled = np.concatenate([_draws(n, 10 + i) for i, n in enumerate(sizes)])
        _close(got.mean, pooled.mean(0))
    if name == "diag_from_moment_block" and sizes[0] is None or sizes == (1,):
        _close(got, np.ones(D), 0)  # the isotropic fallback below a count of 2


# ---------------------------------------------------------------------------
# the policies through one sequence
# ---------------------------------------------------------------------------

ENSEMBLE = 4
# each operation: ("update", seed), four rows, or ("push",); the second push
# wraps a ring of two slots, 20 rows a raw ring of 6 (the rings share their
# shapes, so the cases share the reference's compiled operations)
SEQUENCE = [("update", 20), ("update", 21), ("push",), ("update", 22), ("update", 23),
            ("push",), ("update", 24)]
# the moments, support and diagonal after these operations: a ring partly
# filled, and wrapped
CHECKED = (0, 6)
POLICIES = {
    "reset_window": lambda m, d, **kw: m.reset_window_buffer(d, **kw),
    "accumulating_k2": lambda m, d, **kw: m.accumulating_split_pop_buffer(d, 2, **kw),
    "ensemble_k2": lambda m, d, **kw: m.ensemble_batch_buffer(d, ENSEMBLE, 2, **kw),
    # the first update after each boundary skipped, the second taken
    "late_start_1": lambda m, d, **kw: m.late_start(m.accumulating_split_pop_buffer(d, 2, **kw), 1),
    "raw_ring_6": lambda m, d, **kw: m.raw_draw_ring_buffer(d, 6),
    # requires_draws: the raw ring of capacity max(2, k max(d // 2, 2)) = 6
    "requires_draws_k3": lambda m, d, **kw: m.accumulating_split_pop_buffer(
        d, 3, requires_draws=True),
}
# every policy dense, the two that add state of their own to the ring
# (late_start's count, the ensemble's guard) over a ring the diagonal cases
# of the others hold
CASES = [(policy, form) for policy in sorted(POLICIES) for form in FORMS
         if form == "dense" or policy in ("reset_window", "accumulating_k2")]


def _reference_sequence(ref, batches):
    """The reference policy's states after every operation of SEQUENCE, and
    its moments, support and diagonal after the CHECKED ones."""
    state, states, checked = ref.init(), [], []
    batches = iter(batches)
    for i, op in enumerate(SEQUENCE):
        state = ref.update(state, next(batches)) if op[0] == "update" else ref.push_split(state)
        states.append(state)
        if i in CHECKED:
            # every policy's diagonal reference is diag_from_moment_block of
            # its moments
            moments = ref.get_moments(state)
            checked.append((moments, ref.get_support(state),
                            jbuf.diag_from_moment_block(moments)))
    return states, checked


def _policy(module, policy, form):
    kw = {} if policy.startswith(("raw", "requires")) else {"diagonal": form == "diagonal"}
    return POLICIES[policy](module, D, **kw)


BATCHES = [_draws(ENSEMBLE, op[1]) for op in SEQUENCE if op[0] == "update"]


@pytest.mark.parametrize("policy, form", CASES)
def test_policy_follows_the_reference_through_a_sequence(references, policy, form):
    port = _policy(buf, policy, form)
    ref_states, ref_checked = references["policies"][CASES.index((policy, form))]
    state, batches = port.init(dtype=F64), iter(BATCHES)
    for i, op in enumerate(SEQUENCE):
        if op[0] == "update":
            state = port.update(state, torch.from_numpy(next(batches)))
        else:
            state = port.push_split(state)
        _close_tree(state, ref_states[i])
        if i in CHECKED:
            got = (port.get_moments(state), port.get_support(state),
                   port.get_diag_reference(state))
            _close_tree(got, ref_checked[CHECKED.index(i)])
    if policy == "raw_ring_6":  # 20 rows through 6 slots: the ring wrapped
        assert state.count == 20 and state.write_pos == 2
    if policy == "late_start_1":  # two updates taken, the first forgotten by the wrap
        assert float(port.get_support(state)[0]) == ENSEMBLE


def test_guards_raise():
    ensemble = buf.ensemble_batch_buffer(D, ENSEMBLE)
    with pytest.raises(ValueError, match="partial batches"):
        ensemble.update(ensemble.init(dtype=F64), torch.zeros(3, D, dtype=F64))
    with pytest.raises(ValueError, match="capacity must be >= 2"):
        buf.raw_draw_ring_buffer(D, 1)
    ring = buf.raw_draw_ring_buffer(D, 3)
    with pytest.raises(ValueError, match="exceeds ring capacity"):
        ring.update(ring.init(dtype=F64), torch.zeros(4, D, dtype=F64))
    with pytest.raises(ValueError, match="k must be >= 1"):
        buf.accumulating_split_pop_buffer(D, 0)
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        pb, _ = _block(None, True)
        buf.cgl_update_batch(pb, torch.zeros(2, D, dtype=F64), axis_name="chains")


# ---------------------------------------------------------------------------
# the draws_svd_low_rank recipe
# ---------------------------------------------------------------------------


def _operator(payload):
    U, lam = (np.asarray(x.numpy() if torch.is_tensor(x) else x) for x in payload[1:])
    return (U * lam) @ U.T


SVD_CORE = {"capacity": 6, "max_rank": 3}
SVD_CASES = [(1, 1), (4,), (4, 4, 4)]  # below min_support, filling, wrapped


def _svd_draws(chunks):
    mixing = np.random.default_rng(41).standard_normal((D, D))
    # a chunk of one row is a single (d,) draw
    return [(_draws(rows, 40 + i) @ mixing)[0 if rows == 1 else slice(None)]
            for i, rows in enumerate(chunks)]


def _svd_reference(draws):
    core = jrecipes.lookup_recipe("draws_svd_low_rank").build_core(**SVD_CORE)
    state = core.init(D)
    for x in draws:
        state = core.update(state, x)
    return state.ring, core.final(state).inverse_mass_matrix


@pytest.mark.parametrize("chunks", SVD_CASES)
def test_draws_svd_core_matches_the_reference(references, chunks):
    core = recipes.lookup_recipe("draws_svd_low_rank").build_core(**SVD_CORE)
    draws = _svd_draws(chunks)
    ref_ring, ref_payload = references["svd"][SVD_CASES.index(chunks)]
    state = core.init(D, dtype=F64)
    for x in draws:
        state = core.update(state, torch.from_numpy(x))
    _close_tree(state.ring, ref_ring)
    payload = core.final(state).inverse_mass_matrix
    _close(payload.sigma, ref_payload.sigma)
    _close(payload.lam, ref_payload.lam)
    _close(_operator(payload), _operator(ref_payload))
    recomputed = sum(chunks) >= 3
    assert recomputed == (not bool((payload.lam == 1.0).all()))


@pytest.fixture(scope="module")
def references():
    """Every reference result of the module, compiled as one program (a
    fifth less compile time here than one program each): the direct
    functions' cases, each policy's sequence, each recipe case."""

    def reference(batches, svd_draws):
        return {
            "functions": [_call(jbuf, case, port=False) for case in FUNCTION_CASES],
            "policies": [_reference_sequence(_policy(jbuf, *case), batches) for case in CASES],
            "svd": [_svd_reference(draws) for draws in svd_draws],
        }

    return _jit(reference)([jnp.asarray(b) for b in BATCHES],
                           [[jnp.asarray(x) for x in _svd_draws(chunks)] for chunks in SVD_CASES])


def test_lookup_recipe_returns_the_ported_draws_svd_recipe():
    recipe = recipes.lookup_recipe("draws_svd_low_rank")
    ref = jrecipes.lookup_recipe("draws_svd_low_rank")
    assert (recipe.name, recipe.needs, recipe.emits, recipe.provenance) == (
        ref.name, ref.needs, ref.emits, ref.provenance)
    assert recipes.REGISTRY["draws_svd_low_rank"] is recipe
    with pytest.raises(ValueError, match="'fisher_diag' is not yet ported"):
        recipes.lookup_recipe("fisher_diag")
