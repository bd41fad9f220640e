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
])
def test_smc_modules_are_reachable(module):
    import blackjax_tpu.smc
    import blackjax_tpu_torch.smc

    mod = importlib.import_module(f"blackjax_tpu_torch.smc.{module}")
    assert getattr(blackjax_tpu_torch.smc, module) is mod
    assert set(blackjax_tpu_torch.smc.__all__) <= set(blackjax_tpu.smc.__all__)
    ref = importlib.import_module(f"blackjax_tpu.smc.{module}")
    assert set(getattr(mod, "__all__", [])) == set(getattr(ref, "__all__", []))


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
