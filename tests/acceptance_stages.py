"""One acceptance iteration's stages in the port and in the JAX package, on
the CPU, from the same numpy inputs: what decides the course of a
reference-config run (tools/acceptance.py, tools/acceptance_torch.py)
besides the two packages' random draws.

From observations (x, y), the first n_init of them the initial design, and
a pool drawn with numpy from the task's domain prior, each package:

  fit   fit_gp_padded at the run's observation bucket: the hypers and the
        negative log marginal likelihood, each fit's under both packages;
  eta   the incumbent of pi (the largest posterior mean at the data);
  pi    the pool's weights cleanse(pi / p) under the domain prior's
        density p, as the sampler makes them, each package from its own
        fit and the port from JAX's fit too: the positive count (the
        sampler's n_pos before any refill) and the largest difference of
        pi;
  prior the proposal's update (Sober.update_prior) on the pool with JAX's
        weights: the WKDE's effective size and bandwidth (a mixed prior's
        continuous block) and a binary block's Bernoulli MLE; and, as the
        WKDE draws its components at random when the weights are rich, its
        effective size over `draws` component draws in each package
        (quartiles, and how many draws collapsed to one component);
  reset the stagnation reset's trigger (Sober.should_reset_prior) on the
        targets after each batch of the history.

Used by tests/test_torch_acceptance_stages.py at a small pool, and run
whole as a script at a task's acceptance config:

    python tests/acceptance_stages.py TASK [--seed S] [--history RUN.npz]
        [--iterations 0,7,14] [--n-rec N] [--bucket B]

without --history from the port's initial design for the seed (its
KeyRing, on the CPU); with it, from the states of a saved run
(tools/acceptance_torch.py --history) after the listed iterations. Prints
one JSON line a state.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sober_tpu import Sober as JaxSober  # noqa: E402
from sober_tpu.core.pi import PI as JaxPI  # noqa: E402
from sober_tpu.gp import exact as jx  # noqa: E402
from sober_tpu.priors.wkde import WeightedKernelDensityEstimation as JaxWKDE  # noqa: E402
from sober_tpu.tasks import synthetic as jtasks  # noqa: E402
from sober_tpu.utils.weights import cleansing_weights as jax_cleansing  # noqa: E402
from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.core.pi import PI  # noqa: E402
from sober_tpu_torch.gp import exact as tx  # noqa: E402
from sober_tpu_torch.interop import gp_state_from_numpy, gp_state_to_numpy  # noqa: E402
from sober_tpu_torch.priors.wkde import WeightedKernelDensityEstimation as WKDE  # noqa: E402
from sober_tpu_torch.tasks import synthetic as ttasks  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402
from sober_tpu_torch.utils.weights import cleansing_weights  # noqa: E402

# the continuous tasks whose acceptance rows fall short of JAX's on a seed:
# n_init, batch, n_rec of tools/acceptance.py's config
CONFIGS = {"shekel": (100, 100, 200000), "ackley": (100, 200, 20000)}


def acceptance_bucket(task: str) -> int:
    """tools/acceptance_torch.py's _full_bucket: one bucket for the run."""
    n_init, batch, _ = CONFIGS[task]
    return -(-(n_init + 15 * batch) // 128) * 128


def setups(task: str):
    """((JAX prior, objective), (port prior, objective)) of the task on the
    CPU."""
    return (getattr(jtasks, "setup_" + task)(),
            getattr(ttasks, "setup_" + task)(device="cpu"))


def initial_design(task: str, seed: int, n_init: int):
    """The port's initial design for `seed` as run_bo_loop draws it, on the
    CPU, with its values: (x, y) in numpy."""
    _, (prior, fn) = setups(task)
    x = prior.sample(KeyRing(seed, device="cpu").next(), n_init)
    return x.numpy(), fn(x).numpy()


def draw_pool(task: str, n: int, seed: int) -> np.ndarray:
    """n rows of the task's domain prior drawn with numpy: uniform in the
    box, a binary block 0 or 1 with even odds."""
    rng = np.random.default_rng(seed)
    (jprior, _), _ = setups(task)
    lo, hi = (np.asarray(b, np.float64) for b in jprior.bounds)
    x = lo + (hi - lo) * rng.random((n, len(lo)))
    if task == "ackley":
        x = np.concatenate([x, rng.integers(0, 2, (n, jprior.n_dims_binary))], axis=1)
    return x.astype(np.float32)


def _hypers(params: dict, noise) -> dict:
    out = {k: np.asarray(v, np.float64).round(7).tolist() for k, v in params.items()}
    return {**out, "noise": float(noise)}


def _raw(state):
    """The port's GPParams (raw, unconstrained) of a fitted state."""
    ls, os_ = (state.kernel.params[k] for k in ("lengthscale", "outputscale"))
    return tx.GPParams(tx._inv_softplus(ls), tx._inv_softplus(os_),
                       tx._inv_interval(state.noise, 1e-8, 1e-3))


def _neg_mll(state) -> float:
    """The port's negative log marginal likelihood of a state's hypers on
    its own standardized, padded data."""
    return float(tx.neg_mll(_raw(state), state.x, state.y, state.config, state.mask))


def wkde_draws(x: np.ndarray, w: np.ndarray, draws: int) -> dict:
    """The WKDE's effective size on (x, w) over `draws` component draws in
    each package: its quartiles, and the draws whose effective size is
    below 1.01 (one component)."""
    def summary(neff):
        return {"quartiles": np.percentile(neff, [25, 50, 75]).round(4).tolist(),
                "collapsed": int(sum(n < 1.01 for n in neff))}
    d = x.shape[1]
    jax_neff = [float(JaxWKDE(jnp.asarray(x), jnp.asarray(w), d, key=jax.random.key(i)).neff)
                for i in range(draws)]
    port_neff = [float(WKDE(x, w, d, gen=torch.Generator().manual_seed(i), device="cpu").neff)
                 for i in range(draws)]
    return {"draws": draws, "jax": summary(jax_neff), "port": summary(port_neff)}


def stages(task: str, x: np.ndarray, y: np.ndarray, pool: np.ndarray,
           n_init: int, batch: int, bucket: int, history_y: np.ndarray | None = None,
           seed: int = 0, draws: int = 0) -> dict:
    """Each stage of both packages from (x, y) and the pool (module
    docstring); `history_y` (default y) holds the targets whose prefixes
    after each batch the reset's trigger is asked about."""
    (jprior, _), (tprior, _) = setups(task)
    jm = jx.fit_gp_padded(jnp.asarray(x), jnp.asarray(y), bucket=bucket)
    tm = tx.fit_gp_padded(torch.as_tensor(x), torch.as_tensor(y), bucket=bucket)
    jm_t = gp_state_from_numpy(gp_state_to_numpy(jm), device="cpu")
    out = {"n_obs": len(y),
           "fit": {"jax": _hypers(jm.kernel.params, jm.noise),
                   "port": _hypers({k: v.numpy() for k, v in tm.kernel.params.items()},
                                   tm.noise),
                   "neg_mll_jax_fit": _neg_mll(jm_t), "neg_mll_port_fit": _neg_mll(tm)}}

    jpi, tpi, tpi_j = JaxPI(jm), PI(tm), PI(jm_t)
    out["eta"] = {"jax": float(jpi.eta), "port": float(tpi.eta),
                  "port_on_jax_fit": float(tpi_j.eta)}
    pool_j, pool_t = jnp.asarray(pool), torch.as_tensor(pool)
    pi_j, pdf_j = jpi(pool_j), jprior.pdf(pool_j)
    pi_t, pi_tj, pdf_t = tpi(pool_t), tpi_j(pool_t), tprior.pdf(pool_t)
    w_j = np.array(jax_cleansing(pi_j / jnp.maximum(pdf_j, 1e-38)))
    positive = lambda pi: int((cleansing_weights(pi / pdf_t.clamp_min(1e-38)) > 0).sum())
    diff = lambda a: float(np.abs(a.double().numpy() - np.asarray(pi_j, np.float64)).max())
    out["pi"] = {"n_pool": len(pool), "positive_jax": int((w_j > 0).sum()),
                 "positive_port": positive(pi_t), "positive_port_on_jax_fit": positive(pi_tj),
                 "max_diff_own_fits": diff(pi_t), "max_diff_same_fit": diff(pi_tj),
                 "max": float(pi_j.max())}

    js, ts = JaxSober(jprior, jm, seed=seed), Sober(tprior, tm, seed=seed)
    js.update_prior(pool_j, jnp.asarray(w_j, jnp.float32))
    ts.update_prior(pool_t, torch.as_tensor(w_j, dtype=torch.float32))
    prior = {}
    for name, new in (("jax", js.prior), ("port", ts.prior)):
        wkde = getattr(new, "prior_cont", new)
        row = {"neff": float(wkde.neff), "bw": float(wkde.bw)}
        if hasattr(new, "prior_disc"):
            row["probs"] = np.asarray(new.prior_disc.probs, np.float64)
        prior[name] = row
    if "probs" in prior["jax"]:
        pj, pt = prior["jax"].pop("probs"), prior["port"].pop("probs")
        prior["bernoulli_max_diff"] = float(np.abs(pt - pj).max())
        prior["bernoulli_range_jax"] = [float(pj.min()), float(pj.max())]
    if draws:
        n_cont = getattr(jprior, "n_dims_cont", pool.shape[1])
        prior["neff_draws"] = wkde_draws(pool[:, :n_cont], w_j, draws)
    out["prior"] = prior

    hist = y if history_y is None else history_y
    for s in (js, ts):
        s.n_init = n_init
    ends = range(n_init + batch, len(hist) + 1, batch)
    out["reset"] = {"after_n": list(ends),
                    "jax": [bool(js.should_reset_prior(batch, True, targets=np.asarray(hist[:e])))
                            for e in ends],
                    "port": [bool(ts.should_reset_prior(batch, True, targets=np.asarray(hist[:e])))
                             for e in ends]}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("task", choices=sorted(CONFIGS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history", help="a run's x and y (tools/acceptance_torch.py --history)")
    ap.add_argument("--iterations", default="0",
                    help="with --history, the states after these iterations")
    ap.add_argument("--n-rec", type=int, help="the pool (default: the task's n_rec)")
    ap.add_argument("--bucket", type=int, help="default: the acceptance run's bucket")
    ap.add_argument("--draws", type=int, default=64,
                    help="the WKDE's component draws a package (default: %(default)s)")
    args = ap.parse_args(argv)
    n_init, batch, n_rec = CONFIGS[args.task]
    n_rec = args.n_rec or n_rec
    bucket = args.bucket or acceptance_bucket(args.task)
    pool = draw_pool(args.task, n_rec, args.seed)
    if args.history is None:
        runs = [(0, *initial_design(args.task, args.seed, n_init))]
        history_y = None
    else:
        run = np.load(args.history)
        history_y = run["y"]
        runs = [(k, run["x"][:n_init + k * batch], run["y"][:n_init + k * batch])
                for k in map(int, args.iterations.split(","))]
    for k, x, y in runs:
        row = stages(args.task, x, y, pool, n_init, batch, bucket, history_y, args.seed,
                     args.draws)
        print(json.dumps({"task": args.task, "seed": args.seed, "iteration": k,
                          "bucket": bucket, **row}), flush=True)


if __name__ == "__main__":
    main()
