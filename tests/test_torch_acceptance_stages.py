"""The stages of one acceptance iteration, the port against the JAX package
on the same numpy inputs (tests/acceptance_stages.py): Shekel and Ackley,
the two tasks whose acceptance rows fall short of JAX's on a seed, from
the port's initial design for seed 0 and a 4,096-row pool of the domain
prior, at the default observation bucket."""
import numpy as np
import pytest
from acceptance_stages import CONFIGS, draw_pool, initial_design, stages

N_POOL = 4096


def _history(y0: np.ndarray, batch: int) -> np.ndarray:
    """The initial targets, a batch that sets a new best, then four that do
    not: the stagnation reset's trigger turns on along the way."""
    rng = np.random.default_rng(1)
    lo = float(y0.min())
    batches = [np.full(batch, lo, np.float32) for _ in range(5)]
    batches[0][batch // 2] = float(y0.max()) + 1.0
    for b in batches[1:]:
        b[:] = rng.uniform(lo, float(y0.max()), batch)
    return np.concatenate([y0, *batches])


@pytest.mark.parametrize("task", sorted(CONFIGS))
def test_stages_match_jax(task):
    """The port's fit is as good as JAX's (its loss at most JAX's plus
    1e-3 |loss|, the fit tests' criterion); from JAX's fit, eta within 1e-5,
    pi within 1e-5 and the pool's positive weights as many as JAX's, up to
    0.1% of the pool; the proposal's update from the same weights
    gives the WKDE's effective size and bandwidth within 1e-4 and the
    Bernoulli MLE within 1e-5; the reset fires after the same batches."""
    n_init, batch, _ = CONFIGS[task]
    x, y = initial_design(task, 0, n_init)
    row = stages(task, x, y, draw_pool(task, N_POOL, 0), n_init, batch, bucket=128,
                 history_y=_history(y, batch))
    fit = row["fit"]
    assert fit["neg_mll_port_fit"] <= fit["neg_mll_jax_fit"] + 1e-3 * abs(fit["neg_mll_jax_fit"])
    eta = row["eta"]
    assert abs(eta["port_on_jax_fit"] - eta["jax"]) <= 1e-5 * max(1.0, abs(eta["jax"]))
    pi = row["pi"]
    assert pi["max_diff_same_fit"] <= 1e-5 and pi["positive_jax"] > 0
    assert abs(pi["positive_port_on_jax_fit"] - pi["positive_jax"]) <= 1e-3 * N_POOL
    prior = row["prior"]
    for key in ("neff", "bw"):
        np.testing.assert_allclose(prior["port"][key], prior["jax"][key], rtol=1e-4)
    if task == "ackley":
        assert prior["bernoulli_max_diff"] <= 1e-5
    reset = row["reset"]
    assert reset["port"] == reset["jax"] and len(reset["jax"]) == 5
    assert True in reset["jax"] and False in reset["jax"]
