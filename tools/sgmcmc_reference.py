"""The JAX package's own run of ``chip_smoke.py``'s phase 18 on the CPU.

Phase 18 drives the port's SGLD on the two tracked SG-MCMC configurations
(``benchmarks/tracked.py``: ``config_sgld``, ``:486-563``, one chain, and
``config_sgld_chains``, ``:790-856``, 4,096 chains) at their chip sizes on
the reference's dataset, ``logistic_regression(num_points=4096, dim=54)``
from ``jax.random.key(0)``, and gates the final positions on bands around
the JAX package's values at the same keys. This script computes them, in
f32 as the configurations run: each configuration's first variant
(``config_sgld``: the start ``0.01 N(0, I)`` of ``split(key(15), 4)[0]``;
``config_sgld_chains``: the run key ``split(key(26), 4)[0]``), the
minibatches and step keys drawn as the configuration draws them. It prints
one JSON object that ``chip_smoke.SG_REFERENCE`` holds:

- ``sgld``: the final position (54), and each coordinate's standard
  deviation over the second half of the chain's path, the band's scale;
- ``sgld_chains``: the mean of the final positions over the chains (54) and
  their standard deviation across the chains.

The functions here are also the reference side of
``tests/test_torch_sgmcmc.py``, which runs them at the configurations' CPU
sizes in f64.

Usage, from the root of the repository (about a minute and a half on a
few CPU cores)::

    python tools/sgmcmc_reference.py [--steps S] [--chains C]
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from blackjax_tpu import sgld  # noqa: E402
from blackjax_tpu.models.targets import logistic_regression  # noqa: E402
from blackjax_tpu.sgmcmc import gradients  # noqa: E402

STEP_SIZE = 1e-5  # tracked.py:518 and :826


def logprior_fn(w):
    return -0.5 * jnp.sum(w**2)


def loglikelihood_fn(w, minibatch):
    xb, yb = minibatch
    logits = xb @ w
    return jnp.sum(yb * logits - jnp.logaddexp(0.0, logits))


def dataset(jit=jax.jit):
    """The configurations' data: ``logistic_regression(num_points=4096,
    dim=54)`` of ``jax.random.key(0)``, ``(X, y)``, compiled by ``jit`` (with
    ``jax.jit``'s defaults the same bits as the configurations' eager call,
    in f32 and in f64)."""
    return jit(lambda key: logistic_regression(key, num_points=4096, dim=54)[1:])(
        jax.random.key(0))


def sgld_single(X, y, num_steps, batch, variant=0, jit=jax.jit):
    """``config_sgld``'s run: the minibatch indices of ``split(key(13),
    num_steps)``, the step keys ``split(key(14), num_steps)``, the start of
    the variant. Returns the final position, the path ``(num_steps, d)``
    and the indices ``(num_steps, batch)``. ``jit`` compiles the run (a
    test passes faster compiler options)."""
    data_size, d = X.shape
    batch_keys = jax.random.split(jax.random.key(13), num_steps)
    batch_idx = jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, data_size))(batch_keys)
    step_keys = jax.random.split(jax.random.key(14), num_steps)
    step = sgld(gradients.grad_estimator(logprior_fn, loglikelihood_fn, data_size)).step
    w0 = 0.01 * jax.random.normal(jax.random.split(jax.random.key(15), 4)[variant], (d,))

    @jit
    def run(w):
        def one(w, xs):
            k, idx = xs
            w = step(k, w, (X[idx], y[idx]), STEP_SIZE)
            return w, w

        return jax.lax.scan(one, w, (step_keys, batch_idx))

    final, path = run(w0)
    return np.asarray(final), np.asarray(path), np.asarray(batch_idx)


def sgld_chains(X, y, num_chains, num_steps, batch, variant=0, jit=jax.jit):
    """``config_sgld_chains``'s run: the start ``0.1 N(0, I)`` of key 25,
    the run key ``split(key(26), 4)[variant]`` split a step, each step's
    key split into the minibatch's and the chains'. Returns the final
    positions ``(num_chains, d)`` and the indices ``(num_steps, batch)``;
    ``jit`` as :func:`sgld_single`'s."""
    data_size, d = X.shape
    step = sgld(gradients.grad_estimator(logprior_fn, loglikelihood_fn, data_size)).step

    @jit
    def run(key, w):
        def one(w, k):
            k_idx, k_step = jax.random.split(k)
            idx = jax.random.randint(k_idx, (batch,), 0, data_size)
            keys = jax.random.split(k_step, num_chains)
            w = jax.vmap(lambda kk, wi: step(kk, wi, (X[idx], y[idx]), STEP_SIZE))(keys, w)
            return w, idx

        return jax.lax.scan(one, w, jax.random.split(key, num_steps))

    w0 = 0.1 * jax.random.normal(jax.random.key(25), (num_chains, d))
    final, idx = run(jax.random.split(jax.random.key(26), 4)[variant], w0)
    return np.asarray(final), np.asarray(idx)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=20000)
    parser.add_argument("--chains", type=int, default=4096)
    args = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")  # f32, JAX's default, as the configurations run
    X, y = dataset()
    t0 = time.perf_counter()
    final, path, _ = sgld_single(X, y, args.steps, 512)
    spread = path[args.steps // 2:].std(0)
    print(f"sgld: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    t0 = time.perf_counter()
    finals, _ = sgld_chains(X, y, args.chains, args.steps, 256)
    print(f"sgld_chains: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    out = {
        "sgld": {"final": final.tolist(), "second_half_sd": spread.tolist()},
        "sgld_chains": {"mean": finals.mean(0).tolist(), "sd": finals.std(0).tolist()},
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
