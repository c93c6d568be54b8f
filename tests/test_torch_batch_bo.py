"""Parity of the port's pathwise GP sampling (gp/sampling.py) and batch-BO
baselines (benchmarks/batch_bo.py) with the JAX package, on the CPU. The
same seeded numpy inputs and a carried GP state go through both; random
stages take JAX's draws where they can (the RFF frequencies, the path
weights and noise, the joint normals, the Sobol seed) and are compared by
distribution where they cannot."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.benchmarks import batch_bo as jbo
from sober_tpu.gp import exact as jexact
from sober_tpu.gp import sampling as jsampling
from sober_tpu.priors import Uniform as JUniform
from sober_tpu_torch import interop
from sober_tpu_torch.benchmarks import batch_bo as tbo
from sober_tpu_torch.gp import exact as texact
from sober_tpu_torch.gp import sampling as tsampling
from sober_tpu_torch.priors import Uniform

KEY = jax.random.key(0)
BOUNDS = [[-2.0, -2.0], [2.0, 2.0]]
ALL_SPECTRAL = ["rbf", "matern12", "matern32", "matern52"]


def _data(n=40, seed=0):
    """A wiggly function on [-2, 2]^2: its fit has a unit-order lengthscale
    and outputscale, so posterior variances are not float32 cancellation
    (on tests/test_benchmarks.py's quadratic the outputscale fits at ~66
    and the posterior variance at ~1e-3 keeps 2 digits)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, 2)).astype(np.float32)
    y = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.05 * rng.normal(size=n)
    return x, y.astype(np.float32)


def _fitted(kernel="rbf", **cfg):
    """A JAX fit and the port's copy of it (CPU tensors)."""
    x, y = _data()
    jstate = jexact.fit_gp(jnp.asarray(x), jnp.asarray(y), kernel_name=kernel, **cfg)
    return jstate, interop.gp_state_from_numpy(interop.gp_state_to_numpy(jstate), "cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _xq(n=30, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 2)).astype(np.float32)


# The default noise bounds let the noise fit near its floor, where K + s^2 I
# is ill-conditioned and both packages' float32 solves lie far from
# float64's. Solves are held on a fit whose noise is at least 1e-2.
WELL_POSED = dict(noise_lo=1e-2, noise_hi=1e-1)


# ----------------------------------------------------------------------------
# pathwise sampling
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ALL_SPECTRAL)
def test_rff_features_match_jax(kernel):
    jstate, tstate = _fitted(kernel)
    jbasis = jsampling.make_rff_basis(KEY, jstate, num_basis=256)
    carried = interop.rff_basis_from_numpy(interop.rff_basis_to_numpy(jbasis), "cpu")
    rebuilt = tsampling.rff_basis(tstate, carried.omega, carried.phase)
    x = _xq()
    want = np.asarray(jbasis(jnp.asarray(x)))
    for basis in (carried, rebuilt):
        assert np.abs(basis(torch.as_tensor(x)).numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("kernel", ALL_SPECTRAL)
def test_rff_approximates_kernel(kernel):
    """E[phi(x) phi(y)^T] -> k(x, y) for the port's own frequency draws
    (chi2 as sums of squared normals for the Matern t-frequencies), at
    tests/test_benchmarks.py's basis counts and error bars."""
    _, tstate = _fitted(kernel)
    n_basis = 4096 if kernel == "rbf" else 32768
    basis = tsampling.make_rff_basis(_gen(), tstate, num_basis=n_basis)
    x = torch.as_tensor(_xq())
    phi = basis(x)
    k_true = tstate.kernel.gram(x, x).numpy()
    rel = np.abs((phi @ phi.T).numpy() - k_true).max() / k_true.max()
    assert rel < (0.05 if kernel == "rbf" else 0.10), (kernel, rel)


def test_unknown_kernel_raises():
    _, tstate = _fitted()
    bad = tstate._replace(kernel=tstate.kernel.__class__(
        "tanimoto", {"outputscale": torch.tensor(1.0)}))
    with pytest.raises(ValueError, match="spectral density"):
        tsampling.make_rff_basis(_gen(), bad, num_basis=64)


@pytest.mark.parametrize("kernel", ["rbf", "matern52"])
def test_decoupled_paths_match_jax(kernel):
    """The paths from JAX's own basis, weights and noise normals (its key
    split replayed) on an unpadded state, against decoupled_sampler's."""
    jstate, tstate = _fitted(kernel, **WELL_POSED)
    n_samples, n_basis = 16, 512
    k_basis, k_w, k_eps = jax.random.split(KEY, 3)
    jbasis = jsampling.make_rff_basis(k_basis, jstate, n_basis)
    w = np.asarray(jax.random.normal(k_w, (n_samples, n_basis)))
    eps = np.asarray(jax.random.normal(k_eps, (n_samples, jstate.x.shape[0])))
    xq = _xq()
    want = np.asarray(jsampling.decoupled_sampler(KEY, jstate, n_samples, n_basis)(
        jnp.asarray(xq)))
    basis = interop.rff_basis_from_numpy(interop.rff_basis_to_numpy(jbasis), "cpu")
    paths = tsampling.decoupled_paths(tstate, basis, torch.tensor(w),
                                      torch.tensor(eps))
    got = paths(torch.as_tensor(xq)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def _padded_pair(cfg):
    """States of the same hypers on the real rows and on a bucket-padded
    buffer (standardize_y off, so both hold the same targets)."""
    x, y = (torch.as_tensor(a) for a in _data())
    params = texact.fit_params(x, y, cfg, optimiser="adam")
    x_pad, y_pad, mask = texact.pad_observations(x, y, 64)
    return (texact.build_state(params, x, y, cfg),
            texact.build_state(params, x_pad, y_pad, cfg, mask=mask))


def test_padded_paths_equal_unpadded():
    """On a padded state the noise is drawn for the real rows only and the
    correction vanishes on the padding: the paths are the unpadded ones."""
    unpadded, padded = _padded_pair(texact.GPConfig(standardize_y=False, fit_iters=30,
                                                    **WELL_POSED))
    xq = torch.as_tensor(_xq())
    a = tsampling.decoupled_sampler(_gen(3), unpadded, 16, 512)(xq)
    b = tsampling.decoupled_sampler(_gen(3), padded, 16, 512)(xq)
    assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(a.abs().max()))


@pytest.mark.parametrize("kernel", ALL_SPECTRAL)
def test_pathwise_matches_posterior(kernel):
    _, tstate = _fitted(kernel)
    paths = tsampling.decoupled_sampler(_gen(), tstate, 512, num_basis=2048)
    xq = torch.tensor([[0.5, 0.5], [1.5, -1.0]])
    y = paths(xq).numpy()
    mu, var = texact.predict(tstate, xq, include_noise=False)
    assert np.allclose(y.mean(0), mu.numpy(), atol=0.15), kernel
    assert np.allclose(y.std(0), np.sqrt(var.numpy()), atol=0.15), kernel


def test_joint_samples_match_jax():
    """The joint draw from JAX's own normals: mu + z L^T."""
    jstate, tstate = _fitted(**WELL_POSED)
    xq = _xq(12)
    z = np.asarray(jax.random.normal(KEY, (64, 12)))
    want = np.asarray(jsampling.joint_posterior_samples(KEY, jstate, jnp.asarray(xq), 64))
    got = tsampling.joint_samples_from_normals(tstate, torch.as_tensor(xq),
                                               torch.tensor(z)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


# ----------------------------------------------------------------------------
# acquisition machinery
# ----------------------------------------------------------------------------

def test_expected_improvement_matches_jax():
    jstate, tstate = _fitted()
    x = _xq(100, seed=4) * 2.0
    eta = float(jnp.max(jstate.y))
    want = np.asarray(jbo.expected_improvement(jstate, eta, jnp.asarray(x)))
    got = tbo.expected_improvement(tstate, eta, torch.as_tensor(x)).detach().numpy()
    assert (got >= -1e-6).all()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("acq", ["quadratic", "ei"])
def test_maximize_acqf_matches_jax(acq):
    """From the same Sobol seed (JAX's randint of the key), the restarts,
    the 30 projected Adam steps and the pick agree."""
    jstate, tstate = _fitted()
    centre = np.array([0.3, -0.7], np.float32)
    eta = float(jnp.max(jstate.y))
    if acq == "quadratic":
        jfn = lambda x: -jnp.sum((x - jnp.asarray(centre)) ** 2, axis=1)
        tfn = lambda x: -torch.sum((x - torch.as_tensor(centre)) ** 2, dim=1)
    else:
        jfn = lambda x: jbo.expected_improvement(jstate, eta, x)
        tfn = lambda x: tbo.expected_improvement(tstate, eta, x)
    seed = int(jax.random.randint(KEY, (), 0, 2**31 - 1))
    want = np.asarray(jbo.maximize_acqf(KEY, jfn, jnp.asarray(BOUNDS), q=2,
                                        raw_samples=128))
    got = tbo.maximize_from_seed(seed, tfn, torch.tensor(BOUNDS), q=2,
                                 raw_samples=128).numpy()
    assert got.shape == (2, 2)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("mode,lam", [("mult", 1.0), ("pow", 2.0)])
def test_dpp_logdet_matches_jax(mode, lam):
    jstate, tstate = _fitted()
    xb = _xq(6, seed=7) * 2.0
    want = float(jbo._dpp_logdet_jit(jstate, jnp.asarray(xb), lam, mode))
    got = float(tbo._dpp_logdet(tstate, torch.as_tensor(xb), lam, mode))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def test_dpp_logdet_rejects_unknown_mode():
    _, tstate = _fitted()
    with pytest.raises(ValueError, match="lambda_mode"):
        tbo._dpp_logdet(tstate, torch.zeros((2, 2)), 1.0, "sum")


def test_greedy_argmax_matches_jax_loop():
    """The device loop picks what the JAX package's numpy loop picks, ties
    included (to the lower index)."""
    jstate, _ = _fitted()
    x_cand = jnp.asarray(_xq(64, seed=2) * 2.0)
    y = np.array(jsampling.joint_posterior_samples(KEY, jstate, x_cand, 20))
    y[3, :] = y[3, 0]                                  # a row of ties
    taken, want = np.zeros(64, bool), []
    for row in y:
        j = int(np.argmax(np.where(taken, -np.inf, row)))
        want.append(j)
        taken[j] = True
    assert tbo.greedy_argmax(torch.as_tensor(y)).tolist() == want


def test_turbo_state_transitions_match_jax():
    """update_turbo_state transition for transition: initialization, the
    success and failure counters, growth, shrinking and the restart."""
    jst = jbo.TurboState(dim=2, batch_size=4)
    tst = tbo.TurboState(dim=2, batch_size=4)
    ys = [1.0, 2.0] + [2.5] * 12 + [0.0] * 40
    for y in ys:
        jst = jbo.update_turbo_state(jst, jnp.array([y]))
        tst = tbo.update_turbo_state(tst, torch.tensor([y]))
        assert vars(tst) == vars(jst), y
    assert tst.restart_triggered


# ----------------------------------------------------------------------------
# baselines
# ----------------------------------------------------------------------------

def _prior():
    return Uniform(BOUNDS, device="cpu")


BASELINES = {
    "ts": lambda g, m, p: tbo.thompson_sampling(g, m, p, 256, 4),
    "dts": lambda g, m, p: tbo.decoupled_thompson_sampling(g, m, p, 256, 4,
                                                           num_basis=512),
    "dpp": lambda g, m, p: tbo.dpp_ts(g, m, p, 256, 4, n_mcmc=10),
    "dpp_pow_first_ts": lambda g, m, p: tbo.dpp_ts(g, m, p, 256, 4, n_mcmc=5,
                                                   dpp_lambda=2.0, lambda_mode="pow",
                                                   first_ts=True),
    "gibbon": lambda g, m, p: tbo.gibbon(g, m, p, 256, 4),
    "lp": lambda g, m, p: tbo.local_penalisation(g, m, p, 3),
    "hallucination": lambda g, m, p: tbo.hallucination(
        g, m, lambda x, y: texact.fit_gp(x, y), p, 3),
    "turbo": lambda g, m, p: tbo.turbo(g, tbo.TurboState(dim=2, batch_size=4), m, p, 4),
    "sober_ts": lambda g, m, p: tbo.sober_ts(g, m, p, 4, n_cand_super=512,
                                             n_cand=256, n_nys=32),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_each_returns_valid_batch(name):
    """tests/test_benchmarks.py's properties for every baseline of the
    port: (batch, 2), finite, inside the box, not all one point."""
    _, tstate = _fitted()
    xb = BASELINES[name](_gen(), tstate, _prior()).numpy()
    assert xb.ndim == 2 and xb.shape[1] == 2, name
    assert np.isfinite(xb).all(), name
    assert (np.abs(xb) <= 2.0 + 1e-4).all(), name
    assert len(np.unique(xb.round(5), axis=0)) > 1, name


def test_thompson_rows_are_distinct():
    _, tstate = _fitted()
    xb = tbo.thompson_sampling(_gen(), tstate, _prior(), 256, 16).numpy()
    assert len(np.unique(xb, axis=0)) == 16


def test_hallucination_padded_equals_unpadded():
    """hallucination starts from the real rows of a padded state, so it
    returns what it returns on the unpadded one (the JAX package would
    fantasize the padding rows as observations at the origin)."""
    cfg = texact.GPConfig(standardize_y=False, fit_iters=30)
    unpadded, padded = _padded_pair(cfg)
    set_model = lambda x, y: texact.fit_gp(x, y, cfg, optimiser="adam")
    a = tbo.hallucination(_gen(5), unpadded, set_model, _prior(), 2)
    b = tbo.hallucination(_gen(5), padded, set_model, _prior(), 2)
    assert torch.equal(a, b)


def test_turbo_centres_on_real_rows():
    """A padded state's padding rows (zeros, at the box's centre) are not
    candidates for TurBO's centre: the batch is the unpadded one's."""
    unpadded, padded = _padded_pair(texact.GPConfig(standardize_y=False, fit_iters=30))
    st = lambda: tbo.TurboState(dim=2, batch_size=4)
    a = tbo.turbo(_gen(6), st(), unpadded, _prior(), 4)
    b = tbo.turbo(_gen(6), st(), padded, _prior(), 4)
    assert float((a - b).abs().max()) <= 1e-5
