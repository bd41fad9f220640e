"""The port's public names against the reference's, and its packaging.

- The top-level ``__all__`` and ``ops.__all__`` are subsets of the
  reference's (``blackjax_tpu/__init__.py``, ``blackjax_tpu/ops/__init__.py``);
  the kernels' other entry points stay in their modules, where the reference
  keeps them.
- ``nuts.build_kernel`` reaches both engines, and ``build_fused_many_steps``
  is in ``mcmc.nuts``.
- The SMC slice's names (``mala``, ``tempered_smc``, ``adaptive_tempered_smc``,
  ``inner_kernel_tuning``, ``partial_posteriors_smc``) are exported with
  their modules' ``init`` and ``build_kernel``, and every ported module of
  ``smc`` is reachable from the package as in the reference.
- The MCMC family's names (``mhmc``, ``dhmc``, ``ghmc``, ``barker``, the
  random walks, adjusted MCLMC, the slice samplers, ``orbital_hmc``,
  ``mgrad_gaussian``, ``hmc_family``) and ``ess_tail`` and ``pareto_khat``
  are exported as the reference builds them, and each ported ``mcmc``
  module's ``__all__`` is its reference module's; so are the GIST samplers'
  and the SG-MCMC samplers' (``sgld``, ``sghmc``, ``sgnht``, ``csgld``), and
  each ``sgmcmc`` module's ``__all__``.
- Persistent sampling, pretuning and nested slice sampling (``smc_family``,
  ``ns_family``) are exported as the reference builds them, the families'
  members in its order, every ``ns`` module's ``__all__`` its reference
  module's; with ``chees_adaptation`` and ``meads_adaptation``, and
  Pathfinder's five (``pathfinder``, ``multipathfinder``, ``lbfgs``,
  ``pathfinder_adaptation``, ``VIAlgorithm``), and the rest of ``vi``'s four
  (``meanfield_vi``, ``fullrank_vi`` and ``schrodinger_follmer`` as
  ``GenerateVariationalAPI``s, ``svgd`` from its module), 70 of its 78
  names; the ported ``vi`` modules, ``optimizers.lbfgs`` and
  ``adaptation.pathfinder_adaptation`` export their reference modules'
  names.
- ``pyproject.toml``'s package data names every CUDA source under ``csrc/``,
  so that an installed copy can build its kernels.
"""
import fnmatch
import importlib
import tomllib
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import blackjax_tpu  # noqa: E402
import blackjax_tpu.ops  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
import blackjax_tpu_torch.ops  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402

ROOT = Path(blackjax_tpu_torch.__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["top level", "ops"])
def test_public_names_are_the_reference_s(name):
    port, ref = {
        "top level": (blackjax_tpu_torch, blackjax_tpu),
        "ops": (blackjax_tpu_torch.ops, blackjax_tpu.ops),
    }[name]
    extra = set(port.__all__) - set(ref.__all__)
    assert not extra, f"names the reference does not export: {sorted(extra)}"
    for public in port.__all__:
        assert hasattr(port, public), public


@pytest.mark.parametrize("module, function", [
    ("fused_mclmc", "fused_mclmc"),
    ("fused_nuts", "fused_nuts_run"),
    ("fused_nuts_dc", "fused_nuts_run_dc"),
])
def test_kernel_modules_are_reachable(module, function):
    mod = importlib.import_module(f"blackjax_tpu_torch.ops.{module}")
    assert isinstance(mod, types.ModuleType) and callable(getattr(mod, function))
    # the package attribute is the module, as in the reference
    assert getattr(blackjax_tpu_torch.ops, module) is mod


@pytest.mark.parametrize("name, module", [
    ("mala", "mcmc.mala"),
    ("tempered_smc", "smc.tempered"),
    ("adaptive_tempered_smc", "smc.adaptive_tempered"),
    ("inner_kernel_tuning", "smc.inner_kernel_tuning"),
    ("partial_posteriors_smc", "smc.partial_posteriors_path"),
    ("persistent_sampling_smc", "smc.persistent_sampling"),
    ("adaptive_persistent_sampling_smc", "smc.adaptive_persistent_sampling"),
    ("pretuning", "smc.pretuning"),
])
def test_smc_slice_names_are_exported(name, module):
    assert name in blackjax_tpu_torch.__all__ and name in blackjax_tpu.__all__
    api = getattr(blackjax_tpu_torch, name)
    mod = importlib.import_module(f"blackjax_tpu_torch.{module}")
    assert api.init is mod.init and api.build_kernel is mod.build_kernel
    assert api.differentiable is mod.as_top_level_api


@pytest.mark.parametrize("module", [
    "base", "ess", "from_mcmc", "resampling", "solver", "adaptive_tempered",
    "partial_posteriors_path", "tempered", "inner_kernel_tuning", "tuning", "waste_free",
    "persistent_sampling", "adaptive_persistent_sampling", "pretuning",
])
def test_smc_modules_are_reachable(module):
    import blackjax_tpu.smc
    import blackjax_tpu_torch.smc

    mod = importlib.import_module(f"blackjax_tpu_torch.smc.{module}")
    assert getattr(blackjax_tpu_torch.smc, module) is mod
    assert set(blackjax_tpu_torch.smc.__all__) <= set(blackjax_tpu.smc.__all__)
    ref = importlib.import_module(f"blackjax_tpu.smc.{module}")
    assert set(getattr(mod, "__all__", [])) == set(getattr(ref, "__all__", []))


def test_the_registry_holds_59_of_the_reference_s_names():
    """70 of the 78 since the rest of ``vi``'s four names (the test keeps
    its name)."""
    assert len(set(blackjax_tpu_torch.__all__)) == 70 and len(set(blackjax_tpu.__all__)) == 78
    assert set(blackjax_tpu_torch.__all__) <= set(blackjax_tpu.__all__)


def test_chees_adaptation_is_built_as_the_reference_builds_it():
    """The warmup function itself, imported from its module, as
    ``blackjax_tpu/__init__.py:21`` does."""
    from blackjax_tpu.adaptation import chees_adaptation as reference
    from blackjax_tpu_torch.adaptation import chees_adaptation as port

    assert blackjax_tpu.chees_adaptation is reference.chees_adaptation
    assert blackjax_tpu_torch.chees_adaptation is port.chees_adaptation
    assert "chees_adaptation" in blackjax_tpu_torch.__all__
    assert set(port.__all__) == set(reference.__all__)


def test_meads_adaptation_is_built_as_the_reference_builds_it():
    """The warmup function itself, imported from its module, as
    ``blackjax_tpu/__init__.py:25`` does; ``adaptation`` exports its module
    and ``metric_buffers``, as the reference's ``adaptation/__init__.py``."""
    import blackjax_tpu.adaptation
    import blackjax_tpu_torch.adaptation
    from blackjax_tpu.adaptation import meads_adaptation as reference
    from blackjax_tpu_torch.adaptation import meads_adaptation as port

    assert blackjax_tpu.meads_adaptation is reference.meads_adaptation
    assert blackjax_tpu_torch.meads_adaptation is port.meads_adaptation
    assert "meads_adaptation" in blackjax_tpu_torch.__all__
    assert set(port.__all__) == set(reference.__all__)
    for name in ("meads_adaptation", "metric_buffers"):
        assert name in blackjax_tpu.adaptation.__all__
        assert name in blackjax_tpu_torch.adaptation.__all__
        module = getattr(blackjax_tpu_torch.adaptation, name)
        assert set(module.__all__) == set(getattr(blackjax_tpu.adaptation, name).__all__)


@pytest.mark.parametrize("family, size", [("smc_family", 5), ("ns_family", 2)])
def test_families_list_their_members_in_the_reference_s_order(family, size):
    port, ref = getattr(blackjax_tpu_torch, family), getattr(blackjax_tpu, family)
    assert len(port) == len(ref) == size
    for port_api, ref_api in zip(port, ref):
        name = ref_api.differentiable.__module__.rsplit(".", 1)[-1]
        assert port_api.differentiable.__module__.rsplit(".", 1)[-1] == name
        assert port_api.differentiable.__name__ == ref_api.differentiable.__name__


@pytest.mark.parametrize("name, top_level", [
    ("nss", "as_top_level_api"), ("nsswig", "swig_as_top_level_api")])
def test_nested_samplers_are_exported(name, top_level):
    from blackjax_tpu_torch.ns import nss

    api = getattr(blackjax_tpu_torch, name)
    assert api.init is nss.init and api.differentiable is getattr(nss, top_level)
    assert api.build_kernel is (nss.build_kernel if name == "nss" else nss.build_swig_kernel)


@pytest.mark.parametrize("module", [
    "base", "integrator", "adaptive", "from_mcmc", "utils", "nss"])
def test_ns_modules_are_reachable(module):
    import blackjax_tpu.ns
    import blackjax_tpu_torch.ns

    mod = importlib.import_module(f"blackjax_tpu_torch.ns.{module}")
    ref = importlib.import_module(f"blackjax_tpu.ns.{module}")
    assert set(getattr(mod, "__all__", [])) == set(getattr(ref, "__all__", []))
    assert blackjax_tpu_torch.ns.__all__ == blackjax_tpu.ns.__all__
    if module != "nss":  # nss is not in the reference's ns.__all__ either
        assert getattr(blackjax_tpu_torch.ns, module) is mod


@pytest.mark.parametrize("name, module", [
    ("ghmc", "mcmc.ghmc"),
    ("adjusted_mclmc", "mcmc.adjusted_mclmc"),
    ("adjusted_mclmc_dynamic", "mcmc.adjusted_mclmc_dynamic"),
    ("dhmc", "mcmc.dynamic_hmc"),
    ("dynamic_hmc", "mcmc.dynamic_hmc"),
    ("barker", "mcmc.barker"),
    ("barker_proposal", "mcmc.barker"),
    ("elliptical_slice", "mcmc.elliptical_slice"),
    ("slice_sampling", "mcmc.slice"),
    ("orbital_hmc", "mcmc.periodic_orbital"),
    ("mgrad_gaussian", "mcmc.marginal_latent_gaussian"),
    ("gist_step_size", "mcmc.gist_step_size"),
    ("gist_trajectory_length", "mcmc.gist_trajectory_length"),
    ("sgld", "sgmcmc.sgld"),
    ("sghmc", "sgmcmc.sghmc"),
    ("sgnht", "sgmcmc.sgnht"),
    ("csgld", "sgmcmc.csgld"),
])
def test_mcmc_family_names_are_exported(name, module):
    assert name in blackjax_tpu_torch.__all__ and name in blackjax_tpu.__all__
    api = getattr(blackjax_tpu_torch, name)
    mod = importlib.import_module(f"blackjax_tpu_torch.{module}")
    assert api.init is mod.init and api.build_kernel is mod.build_kernel
    assert api.differentiable is mod.as_top_level_api


@pytest.mark.parametrize("name, builds", [
    ("mhmc", ("mcmc.hmc", "as_top_level_api", "build_kernel")),
    ("multinomial_hmc", ("mcmc.hmc", "as_top_level_api", "build_kernel")),
    ("dmhmc", ("mcmc.dynamic_hmc", "as_top_level_api", "build_kernel")),
    ("rmh", ("mcmc.random_walk", "rmh_as_top_level_api", "build_rmh")),
    ("irmh", ("mcmc.random_walk", "irmh_as_top_level_api", "build_irmh")),
    ("additive_step_random_walk",
     ("mcmc.random_walk", "additive_step_random_walk", "build_additive_step")),
    ("coordinate_slice", ("mcmc.slice", "coordinate_slice", "build_coordinate_kernel")),
])
def test_composed_names_are_built_as_the_reference_builds_them(name, builds):
    module, top, build = builds
    mod = importlib.import_module(f"blackjax_tpu_torch.{module}")
    api = getattr(blackjax_tpu_torch, name)
    assert name in blackjax_tpu_torch.__all__ and name in blackjax_tpu.__all__
    assert api.init is mod.init
    for got, expected in ((api.differentiable, getattr(mod, top)),
                          (api.build_kernel, getattr(mod, build))):
        # the multinomial names bind the multinomial proposal, as the reference's do
        target = getattr(got, "func", got)
        assert target is expected
        if name in ("mhmc", "multinomial_hmc", "dmhmc"):
            assert got.keywords["build_proposal"] is blackjax_tpu_torch.mcmc.hmc.multinomial_hmc_proposal


def test_family_lists_and_diagnostics_names():
    port = blackjax_tpu_torch
    assert port.hmc_family == [port.hmc, port.nuts, port.mhmc]
    assert port.normal_random_walk is port.mcmc.random_walk.normal_random_walk
    assert port.additive_step_random_walk.normal_random_walk is port.normal_random_walk
    assert port.ess_tail is port.diagnostics.ess_tail
    assert port.pareto_khat is port.diagnostics.pareto_khat


def test_pathfinder_names_are_built_as_the_reference_builds_them():
    """``pathfinder`` a ``GeneratePathfinderAPI`` over the module's
    functions, ``multipathfinder`` its module's ``as_top_level_api``,
    ``lbfgs`` the module, ``pathfinder_adaptation`` the warmup function
    (``blackjax_tpu/__init__.py:16, 26, 130, 287-290``)."""
    from blackjax_tpu.adaptation import pathfinder_adaptation as ref_pa
    from blackjax_tpu_torch.adaptation import pathfinder_adaptation as port_pa
    from blackjax_tpu_torch.base import VIAlgorithm
    from blackjax_tpu_torch.optimizers import lbfgs
    from blackjax_tpu_torch.vi import multipathfinder, pathfinder

    api = blackjax_tpu_torch.pathfinder
    assert type(api).__name__ == type(blackjax_tpu.pathfinder).__name__ == "GeneratePathfinderAPI"
    assert api.differentiable is pathfinder.as_top_level_api
    assert api.approximate is pathfinder.approximate and api.sample is pathfinder.sample
    assert blackjax_tpu_torch.multipathfinder is multipathfinder.as_top_level_api
    assert blackjax_tpu_torch.lbfgs is lbfgs
    assert blackjax_tpu_torch.pathfinder_adaptation is port_pa.pathfinder_adaptation
    assert blackjax_tpu_torch.VIAlgorithm is VIAlgorithm
    assert set(port_pa.__all__) == set(ref_pa.__all__)
    assert "pathfinder_adaptation" in blackjax_tpu_torch.adaptation.__all__


@pytest.mark.parametrize("module", ["vi.pathfinder", "vi.multipathfinder", "optimizers.lbfgs"])
def test_pathfinder_modules_export_the_reference_s_names(module):
    mod = importlib.import_module(f"blackjax_tpu_torch.{module}")
    ref = importlib.import_module(f"blackjax_tpu.{module}")
    assert set(mod.__all__) == set(ref.__all__)
    for name in mod.__all__:
        assert hasattr(mod, name), name


@pytest.mark.parametrize("module", [
    "hmc", "dynamic_hmc", "ghmc", "barker", "random_walk", "adjusted_mclmc",
    "adjusted_mclmc_dynamic", "elliptical_slice", "slice", "periodic_orbital",
    "marginal_latent_gaussian", "trajectory", "gist", "gist_step_size", "gist_trajectory_length",
])
def test_mcmc_modules_export_the_reference_s_names(module):
    import blackjax_tpu.mcmc
    import blackjax_tpu_torch.mcmc

    mod = importlib.import_module(f"blackjax_tpu_torch.mcmc.{module}")
    assert getattr(blackjax_tpu_torch.mcmc, module) is mod
    ref = importlib.import_module(f"blackjax_tpu.mcmc.{module}")
    assert set(mod.__all__) == set(ref.__all__)
    assert set(blackjax_tpu_torch.mcmc.__all__) <= set(blackjax_tpu.mcmc.__all__)


@pytest.mark.parametrize("module", ["gradients", "diffusions", "sgld", "sghmc", "sgnht", "csgld"])
def test_sgmcmc_modules_export_the_reference_s_names(module):
    import blackjax_tpu.sgmcmc
    import blackjax_tpu_torch.sgmcmc

    mod = importlib.import_module(f"blackjax_tpu_torch.sgmcmc.{module}")
    assert getattr(blackjax_tpu_torch.sgmcmc, module) is mod
    ref = importlib.import_module(f"blackjax_tpu.sgmcmc.{module}")
    assert set(mod.__all__) == set(ref.__all__)
    assert blackjax_tpu_torch.sgmcmc.__all__ == blackjax_tpu.sgmcmc.__all__


@pytest.mark.parametrize("engine", ["flattened", "nested"])
def test_nuts_registry_reaches_both_engines(engine):
    kernel = blackjax_tpu_torch.nuts.build_kernel(engine=engine)
    state = blackjax_tpu_torch.nuts.init(torch.zeros(3, 2, dtype=torch.float64),
                                         lambda x: -0.5 * (x**2).sum(-1))
    new, info = kernel(torch.Generator().manual_seed(0), state,
                       lambda x: -0.5 * (x**2).sum(-1), 0.5, torch.ones(2, dtype=torch.float64), 4)
    assert new.position.shape == (3, 2) and info.num_integration_steps.shape == (3,)
    assert callable(nuts.build_fused_many_steps)
    assert "build_fused_many_steps" in nuts.__all__


def test_package_data_names_every_cuda_source():
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    patterns = config["tool"]["setuptools"]["package-data"]["blackjax_tpu_torch"]
    sources = sorted((ROOT / "blackjax_tpu_torch" / "csrc").iterdir())
    assert sources
    for path in sources:
        rel = path.relative_to(ROOT / "blackjax_tpu_torch").as_posix()
        assert any(fnmatch.fnmatch(rel, pattern) for pattern in patterns), rel


@pytest.mark.parametrize("name", ["meanfield_vi", "fullrank_vi", "schrodinger_follmer"])
def test_variational_names_are_built_as_the_reference_builds_them(name):
    """``GenerateVariationalAPI`` over the module's ``as_top_level_api``,
    ``init``, ``step`` and ``sample`` (``blackjax_tpu/__init__.py:119-127,
    267-286``)."""
    module = importlib.import_module(f"blackjax_tpu_torch.vi.{name}")
    ref = importlib.import_module(f"blackjax_tpu.vi.{name}")
    api, ref_api = getattr(blackjax_tpu_torch, name), getattr(blackjax_tpu, name)
    assert type(api).__name__ == type(ref_api).__name__ == "GenerateVariationalAPI"
    assert name in blackjax_tpu_torch.__all__
    for field in ("differentiable", "init", "step", "sample"):
        got, expected = getattr(api, field), getattr(ref_api, field)
        assert got is getattr(module, expected.__name__)
        assert expected is getattr(ref, expected.__name__)


def test_svgd_is_built_from_its_module():
    from blackjax_tpu_torch.vi import svgd

    api = blackjax_tpu_torch.svgd
    assert type(api).__name__ == type(blackjax_tpu.svgd).__name__ == "GenerateSamplingAPI"
    assert api.differentiable is svgd.as_top_level_api
    assert api.init is svgd.init and api.build_kernel is svgd.build_kernel
    assert "svgd" in blackjax_tpu_torch.__all__


@pytest.mark.parametrize("module", [
    "_gaussian_vi", "meanfield_vi", "fullrank_vi", "svgd", "schrodinger_follmer"])
def test_vi_modules_export_the_reference_s_names(module):
    import blackjax_tpu.vi
    import blackjax_tpu_torch.vi

    mod = importlib.import_module(f"blackjax_tpu_torch.vi.{module}")
    ref = importlib.import_module(f"blackjax_tpu.vi.{module}")
    assert set(mod.__all__) == set(ref.__all__)
    for name in mod.__all__:
        assert hasattr(mod, name), name
    assert blackjax_tpu_torch.vi.__all__ == blackjax_tpu.vi.__all__
    if not module.startswith("_"):
        assert getattr(blackjax_tpu_torch.vi, module) is mod
