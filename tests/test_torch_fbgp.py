"""The port's fully-Bayesian GP against the JAX package's on the CPU: the
FITBO LML sweep against jax.vmap(fitbo_mll) (failing lanes included), the
hyperprior, the WSABI base model, the distillation, the chain caches, the
carried FullyBayesianGP's predictions, pi and acquisitions, and Sober with
an FBGP model (next_batch, step's refusal, step_fbgp). Inputs are made with
numpy and handed to both packages; models fitted by JAX are carried across
(sober_tpu_torch.interop) where a stage is compared on its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from sober_tpu.core.rchq import recombination as jax_recombination
from sober_tpu.gp import fbgp as jf
from sober_tpu.utils.weights import cleansing_weights as jax_cleansing
from sober_tpu_torch import Sober
from sober_tpu_torch.core.rchq import nystrom_basis, recombination
from sober_tpu_torch.gp import fbgp as tf
from sober_tpu_torch.gp.exact import neg_mll, raw_params_from_state
from sober_tpu_torch.interop import (fbgp_from_numpy, fbgp_to_numpy,
                                     fitbo_gp_from_numpy, fitbo_gp_to_numpy,
                                     gp_state_from_numpy, gp_state_to_numpy,
                                     hyperprior_from_numpy, hyperprior_to_numpy)
from sober_tpu_torch.ops.kernels import Kernel
from sober_tpu_torch.priors import Uniform
from sober_tpu_torch.utils.linalg import symmetrize

KEY = jax.random.key(0)
BUCKET = 32
t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))


def _loglik_data(n=25, seed=3):
    """A 1-d Gaussian likelihood surface on [-3, 3] (tests/test_bq_fbgp.py)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    return x, np.exp(-0.5 * (x[:, 0] / 0.7) ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def base():
    """A JAX FitboGP on 25 points (bucket 32) and its copy in the port."""
    x, y = _loglik_data()
    gp = jf.FitboGP(jnp.asarray(x), jnp.asarray(y), bucket=BUCKET)
    return x, y, gp, fitbo_gp_from_numpy(fitbo_gp_to_numpy(gp), "cpu")


@pytest.fixture(scope="module")
def hypers(base):
    """JAX's sweep over 100 hyperprior draws and the MAP anchor, and its
    distillation to 12 chains."""
    _, _, gp, _ = base
    hy, lmls = jf.sampling_hypers(gp, jf.RBFHyperPrior(), n_hypers=100, key=KEY)
    w_qd, theta_qd = jf.quadrature_distillation(hy, lmls, n_nys=32, n_qd=12)
    return hy, lmls, w_qd, theta_qd


@pytest.fixture(scope="module")
def carried(base, hypers):
    """JAX's FullyBayesianGP on the distilled chains and its copy."""
    _, _, gp, _ = base
    _, _, w_qd, theta_qd = hypers
    jm = jf.FullyBayesianGP(gp, w_qd, theta_qd)
    return jm, fbgp_from_numpy(fbgp_to_numpy(jm), "cpu")


# ----------------------------------------------------------------------------
# the FITBO LML sweep
# ----------------------------------------------------------------------------

def _sweep_inputs(n_hypers=100, seed=0):
    """Padded 2-d observations (24 of 32 rows real), their targets and eta,
    and hyperprior draws with two lanes that fail: an outputscale of e^90
    (the Gram overflows) first, as the MAP anchor row sits, and one in the
    middle."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    mask = np.r_[np.ones(24), np.zeros(8)].astype(np.float32)
    fobs = (np.exp(-np.sum(x ** 2, axis=1)) * mask).astype(np.float32)
    eta = np.float32(fobs.max())
    th = np.asarray(jf.RBFHyperPrior().sample(KEY, n_hypers))
    bad = [0.0, -4.0, 0.0, 90.0]
    th = np.vstack([bad, th[:50], bad, th[50:]]).astype(np.float32)
    return th, x, fobs, eta, mask


@pytest.mark.parametrize("masked", [True, False])
def test_sweep_matches_jax(masked):
    """Same thetas, inputs, targets and eta: the port's batched sweep
    against fitbo_mll_batch(use_blocked=False), which is
    jax.vmap(fitbo_mll), within 2e-3 (tests/test_pallas.py's tolerance for
    the sweep), with EPS_LML on the same lanes."""
    th, x, fobs, eta, mask = _sweep_inputs()
    m = mask if masked else None
    want = np.asarray(jf.fitbo_mll_batch(
        jnp.asarray(th), jnp.asarray(x), jnp.asarray(fobs), jnp.asarray(eta),
        None if m is None else jnp.asarray(m), use_blocked=False))
    got = tf.fitbo_mll_batch(t(th), t(x), t(fobs), t(eta),
                             None if m is None else t(m)).numpy()
    dead = want == jf.EPS_LML
    assert dead[0] and dead[51] and dead.sum() == 2
    np.testing.assert_array_equal(got == tf.EPS_LML, dead)
    assert tf.EPS_LML == jf.EPS_LML
    np.testing.assert_allclose(got[~dead], want[~dead], rtol=2e-3, atol=2e-3)
    assert np.isfinite(got).all()


def test_failing_lanes_score_eps_lml():
    """TestFixedJitterAnchor's cases in the port: the failing anchor lane
    scores EPS_LML and the others stay finite; a batch's negative-definite
    matrix fails its own lane of the fixed-jitter factorization (cholesky_ex
    leaves a partial factor there, which the sweep never uses) and no
    other; duplicated inputs with inconsistent targets and ~zero noise give
    EPS_LML or a finite value, never NaN, and JAX's verdict."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (24, 2)).astype(np.float32)
    fobs = rng.normal(size=(24,)).astype(np.float32)
    eta = np.float32(fobs.max())
    th = np.vstack([[0.0, -4.0, 0.0, 90.0],
                    np.tile([0.0, -4.0, 0.0, 0.0], (3, 1))]).astype(np.float32)
    lmls = tf.fitbo_mll_batch(t(th), t(x), t(fobs), t(eta)).numpy()
    assert lmls[0] == tf.EPS_LML
    assert np.isfinite(lmls[1:]).all() and (lmls[1:] > tf.EPS_LML).all()
    w = np.exp(lmls - lmls.max())
    assert np.isfinite(w).all() and w[0] == 0.0

    spd = np.eye(4, dtype=np.float32) + 0.1
    a = t(np.stack([spd, -spd, spd]))
    chol, ok = tf._fixed_jitter_cholesky(a)
    assert ok.tolist() == [True, False, True]
    np.testing.assert_allclose((chol[0] @ chol[0].T).numpy(), spd, atol=1e-5)

    xd = np.zeros((32, 2), np.float32)
    fd = np.linspace(-1.0, -2.0, 32).astype(np.float32)
    thd = np.log([[1e-3, 1e-12, 1.0, 1.0]]).astype(np.float32)
    v = float(tf.fitbo_mll_batch(t(thd), t(xd), t(fd), t(-0.5))[0])
    want = float(jf.fitbo_mll(jnp.asarray(thd[0]), jnp.asarray(xd), jnp.asarray(fd),
                              jnp.float32(-0.5)))
    # so ill-conditioned that the two factorizations' values differ by
    # percents; only the verdict is held
    assert not np.isnan(v) and (v == tf.EPS_LML) == (want == jf.EPS_LML)


# ----------------------------------------------------------------------------
# the hyperprior and the base model
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n_ls", [1, 3])
def test_hyperprior_matches_jax(n_ls):
    """logpdf and initialise(theta_map) within 1e-6; the draws are the
    hyperprior's (by moments); a theta_map of the wrong width raises."""
    jhp = jf.RBFHyperPrior(n_ls=n_ls)
    hp = tf.RBFHyperPrior(n_ls=n_ls, device="cpu")
    np.testing.assert_allclose(hp.hypermu.numpy(), np.asarray(jhp.hypermu), atol=1e-6)
    np.testing.assert_allclose(hp.hyperstd.numpy(), np.asarray(jhp.hyperstd), atol=1e-6)
    th = np.random.default_rng(1).normal(size=(50, 3 + n_ls)).astype(np.float32)
    np.testing.assert_allclose(hp.logpdf(t(th)).numpy(),
                               np.asarray(jhp.logpdf(jnp.asarray(th))), rtol=1e-6,
                               atol=1e-6)
    theta_map = np.linspace(0.2, 2.0, 2 + n_ls).astype(np.float32)
    jhp.initialise(jnp.asarray(theta_map))
    hp.initialise(t(theta_map))
    np.testing.assert_allclose(hp.hypermu.numpy(), np.asarray(jhp.hypermu), atol=1e-6)
    np.testing.assert_allclose(hp.hyperstd.numpy(), np.asarray(jhp.hyperstd), atol=1e-6)
    draws = hp.sample(torch.Generator().manual_seed(0), 20000)
    np.testing.assert_allclose(draws.mean(0).numpy(), hp.hypermu.numpy(), atol=5e-3)
    np.testing.assert_allclose(draws.std(0).numpy(), hp.hyperstd.numpy(), rtol=3e-2)
    with pytest.raises(ValueError, match="theta_map"):
        hp.initialise(t(theta_map[:-1]))
    carried = hyperprior_from_numpy(hyperprior_to_numpy(jhp), "cpu")
    assert torch.equal(carried.hypermu, hp.hypermu) and carried.n_ls == n_ls


def test_fitbo_warp_and_alpha_match_jax(base):
    """The port's own FitboGP on the same data: alpha, the padded targets
    and the WSABI warp of the padded buffer equal JAX's exactly; its fit
    reaches JAX's MLL on the same warped targets."""
    x, y, jgp, _ = base
    gp = tf.FitboGP(t(x), t(y), bucket=BUCKET)
    assert float(gp.alpha) == float(jgp.alpha)
    np.testing.assert_array_equal(gp.fobs_padded.numpy(), np.asarray(jgp.fobs_padded))
    mask = gp.model.mask
    assert gp.model.x.shape == (BUCKET, 1) and float(mask.sum()) == 25
    warped = gp._process_y(t(np.asarray(jgp.fobs_padded)), mask)
    jwarped = jgp._process_y(jnp.asarray(jgp.fobs_padded), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(warped.numpy(), np.asarray(jwarped))
    ys = t(np.linspace(-1.0, 1.5, 11))
    np.testing.assert_array_equal(gp.warp_y(ys).numpy(),
                                  np.asarray(jgp.warp_y(jnp.asarray(ys.numpy()))))
    np.testing.assert_allclose(gp.unwarp_y(gp.warp_y(ys[ys <= gp.alpha])).numpy(),
                               ys[ys <= gp.alpha].numpy(), atol=1e-6)
    # the two L-BFGS searches stop at different points: the port's MLL is
    # held within 1% of JAX's
    carried = gp_state_from_numpy(gp_state_to_numpy(jgp.model), "cpu")
    loss = lambda s: float(neg_mll(raw_params_from_state(s), gp.model.x, warped,
                                   gp.cfg, mask))
    assert loss(gp.model) <= loss(carried) + 1e-2 * abs(loss(carried))


@pytest.mark.parametrize("label", ["wsabil", "wsabim"])
def test_fitbo_predict_and_kernel_carried(base, label):
    """With JAX's fitted state carried across, predict and kernel agree
    within 1e-5 of their scale. The WSABI GP's noise is 1e-10: on the 25
    points of the shared model alpha exceeds 1e4, so the one-ulp
    differences of the two packages' Grams (held here to 2e-7) move its
    predictions far past 1e-5 in either package; the parity is held on 16
    points of the same surface, where alpha stays below 100."""
    x, _, jgp, gp = base
    assert float(gp.model.alpha.abs().max()) > 1e4
    xq = np.linspace(-3, 3, 40).reshape(-1, 1).astype(np.float32)
    np.testing.assert_allclose(
        gp.model.kernel.gram(t(xq), gp.model.x).numpy(),
        np.asarray(jgp.model.kernel.gram(jnp.asarray(xq), jgp.model.x)), atol=2e-7)
    x, y = _loglik_data(16, seed=1)
    jgp = jf.FitboGP(jnp.asarray(x), jnp.asarray(y), bucket=BUCKET, label=label)
    gp = fitbo_gp_from_numpy(fitbo_gp_to_numpy(jgp), "cpu")
    assert float(gp.model.alpha.abs().max()) < 100
    xq = np.linspace(-3, 3, 40).reshape(-1, 1).astype(np.float32)
    for got, want in zip(gp.predict(t(xq)), jgp.predict(jnp.asarray(xq))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # between the grid's points, where the posterior covariance is not all
    # cancellation (at the observations it is ~1e-7 of the prior's)
    yq = xq[::2] + 0.04
    want = np.asarray(jgp.kernel(jnp.asarray(xq), jnp.asarray(yq)))
    np.testing.assert_allclose(gp.kernel(t(xq), t(yq)).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_fitbo_all_negative_observations():
    """All-negative observations (alpha < 0): the padded rows warp at alpha
    and no NaN reaches the fit; carried from JAX, predictions agree within
    1e-5 of their scale over the observations and 30 points of the cube
    (at the observations the variance is cancellation noise, ~1e-6 of
    it)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    y = (-1.0 - rng.uniform(0, 5, 10)).astype(np.float32)
    gp = tf.FitboGP(t(x), t(y), fit_iters=20, bucket=16)
    assert float(gp.alpha) < 0
    mu, var = gp.predict(t(x))
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
    jgp = jf.FitboGP(jnp.asarray(x), jnp.asarray(y), fit_iters=20, bucket=16)
    cgp = fitbo_gp_from_numpy(fitbo_gp_to_numpy(jgp), "cpu")
    xq = np.concatenate([x, rng.uniform(-1, 1, (30, 3)).astype(np.float32)])
    for got, want in zip(cgp.predict(t(xq)), jgp.predict(jnp.asarray(xq))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


# ----------------------------------------------------------------------------
# the distillation and the chain caches
# ----------------------------------------------------------------------------

def test_sampling_hypers_layout(base):
    """The port's sweep from its own draws: the MAP anchor row first, eta
    plus exp(theta_0) in the first column, finite LMLs; an ARD width that
    the hyperprior lacks raises."""
    _, y, _, gp = base
    hp = tf.RBFHyperPrior(device="cpu")
    hy, lmls = tf.sampling_hypers(gp, hp, n_hypers=64)
    assert hy.shape == (65, 4) and lmls.shape == (65,)
    assert torch.isfinite(lmls).all()
    assert (hy[:, 0] > float(y.max()) - 1e-5).all()
    theta_map = tf._theta_map_of(gp, hp)
    np.testing.assert_allclose(hy[0, 1:].numpy(), theta_map.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="n_ls"):
        tf.sampling_hypers(gp, tf.RBFHyperPrior(n_ls=2, device="cpu"), 8)


def _strip(kernel, pool, nys, n_test):
    k_nys = symmetrize(torch.nan_to_num(kernel(nys, nys)))
    phi = nystrom_basis(k_nys, n_test) @ kernel(nys, pool)
    return phi / phi.abs().max()


def test_distillation_matches_jax(base, hypers):
    """Same hypersamples, LMLs, Nystrom subset and surrogate kernel (JAX's
    fit carried): the port's recombination against JAX's, by the moment
    error on the normalized feature strip (both below 1e-4) and the weight
    both put on a common support (at least half). Then the surrogate's fit:
    the port's MAP hypers reach JAX's MLL."""
    hy, lmls, _, _ = hypers
    w = jax_cleansing(jnp.exp(lmls - jnp.max(lmls)))
    nys = jf._nystrom_with_top(jax.random.key(1), hy, w, 32)
    vbq = jf.ScaleVanillaGP(hy, lmls, fit_n=jf._SURROGATE_FIT_N)
    jidx, jw = jax_recombination(hy, nys, 12, vbq.prior_kernel, init_weights=w)
    params = {k: t(v) for k, v in vbq.model.kernel.params.items()}
    kernel = Kernel("rbf", params).gram
    idx, wq = recombination(t(hy), t(nys), 12, kernel, init_weights=t(w))
    assert (wq >= 0).all() and abs(float(wq.sum()) - 1.0) < 1e-4
    phi = _strip(kernel, t(hy), t(nys), 11)
    target = phi @ t(w)
    for i, ww in ((idx, wq), (torch.as_tensor(np.array(jidx)), t(jw))):
        assert float((phi[:, i] @ ww - target).abs().max()) < 1e-4
    jmass = dict(zip(np.asarray(jidx).tolist(), np.asarray(jw).tolist()))
    shared = sum(min(v, jmass.get(i, 0.0)) for i, v in zip(idx.tolist(), wq.tolist()))
    assert shared >= 0.5

    # the surrogate's MAP fit, on the same 101 rows
    y = torch.clamp_min(t(lmls), tf.EPS_LML)
    ours = tf._surrogate_params(t(hy), y, tf._VBQ_CFG, "lbfgs", tf._SURROGATE_FIT_N)
    jstate = gp_state_from_numpy(gp_state_to_numpy(vbq.model), "cpu")
    y_exp = torch.exp(y - y.max())
    loss = lambda p: float(neg_mll(p, t(hy), y_exp, tf._VBQ_CFG))
    assert loss(ours) <= loss(raw_params_from_state(jstate)) + 1e-3


def test_scale_vanilla_gp_matches_jax(hypers):
    """ScaleVanillaGP with fit_n: beta and the exp-warped targets it
    conditions on (all 101 rows, normalized by the global max, as JAX's)
    equal JAX's; its MAP fit on the first 64 rows (normalized within them)
    reaches JAX's MLL there; predictions are finite."""
    hy, lmls, _, _ = hypers
    jv = jf.ScaleVanillaGP(hy, lmls, fit_n=64)
    v = tf.ScaleVanillaGP(t(hy), t(lmls), fit_n=64)
    assert float(v.beta) == float(jv.beta)
    np.testing.assert_allclose(v.model.y.numpy(), np.asarray(jv.model.y), rtol=2.4e-7)
    y = torch.clamp_min(t(lmls)[:64], tf.EPS_LML)
    y_exp = torch.exp(y - y.max())
    jstate = gp_state_from_numpy(gp_state_to_numpy(jv.model), "cpu")
    loss = lambda s: float(neg_mll(raw_params_from_state(s), t(hy)[:64], y_exp, v.cfg))
    assert loss(v.model) <= loss(jstate) + 1e-3
    mu, var = v.predict(t(hy[:10]))
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()
    assert v.prior_kernel(t(hy[:5]), t(hy[:7])).shape == (5, 7)


def test_fbgp_refit_keeps_the_posterior(base):
    """The port's whole hyper pipeline (fbgp_refit): a valid distilled
    quadrature, finite caches, and a marginal posterior within 0.25 of the
    undistilled 201-chain one (tests/test_bq_fbgp.py's regression guard for
    the top-pinned Nystrom set)."""
    _, _, _, gp = base
    hp = tf.RBFHyperPrior(device="cpu")
    model = tf.fbgp_refit(gp, hp, n_hypers=200, n_nys=32, n_qd=16,
                          gen=torch.Generator().manual_seed(0))
    assert model.Theta_qd.shape == (16, 4)
    assert (model.w_qd >= 0).all() and abs(float(model.w_qd.sum()) - 1.0) < 1e-3
    assert torch.isfinite(model._cache.alpha).all()
    xq = t(np.linspace(-2, 2, 10).reshape(-1, 1))
    mu, var = model.marginal_predict(xq)
    assert torch.isfinite(mu).all() and (var >= -1e-5).all()
    hy, lmls = tf.sampling_hypers(gp, hp, 200, torch.Generator().manual_seed(0))
    w_full = torch.exp(lmls - lmls.max())
    full = tf.FullyBayesianGP(gp, w_full / w_full.sum(), hy)
    np.testing.assert_allclose(mu.numpy(), full.marginal_predict(xq)[0].numpy(),
                               atol=0.25)
    cov = model.marginal_predictive_covariance(xq, xq)
    np.testing.assert_allclose(cov.numpy(), cov.T.numpy(), atol=1e-4)


def test_chain_caches_match_jax(base, hypers):
    """From the same Theta_qd, the port's batched caches (each chain on its
    own jitter ladder) against JAX's vmapped _chain_cache_sweep, within
    1e-4."""
    _, _, jgp, _ = base
    _, _, _, theta_qd = hypers
    jl, ja = jf._chain_cache_sweep(theta_qd, jgp.model.x, jgp.fobs_padded,
                                   jgp.model.mask)
    got = tf.chain_caches(t(theta_qd), t(jgp.model.x), t(jgp.fobs_padded),
                          t(jgp.model.mask))
    np.testing.assert_allclose(got.linv.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-4)


def test_chain_ladders_are_per_chain():
    """Each matrix of a batch climbs its own jitter ladder, as jax.vmap runs
    jitter_cholesky: a positive-definite one keeps its first factor, a
    singular one and a negative-definite one retry until they factor, and
    one that no rung repairs (off-diagonal entries 1e6 times its diagonal)
    falls back to its diagonal; all as JAX's factors."""
    from sober_tpu.utils.linalg import jitter_cholesky

    spd = np.eye(3, dtype=np.float32) + 0.2
    singular = np.ones((3, 3), np.float32)               # rank 1, PSD
    hopeless = np.eye(3, dtype=np.float32)
    hopeless[0, 1] = hopeless[1, 0] = 1e6
    a = np.stack([spd, singular, -spd, hopeless])
    chol = tf._batched_jitter_cholesky(t(a)).numpy()
    want = np.asarray(jax.vmap(lambda m: jitter_cholesky(m)[0])(jnp.asarray(a)))
    np.testing.assert_allclose(chol, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(chol[3], np.eye(3, dtype=np.float32))
    assert np.abs(chol[1] @ chol[1].T - singular).max() < 1e-3


# ----------------------------------------------------------------------------
# the carried FullyBayesianGP
# ----------------------------------------------------------------------------

def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def test_fbgp_predictions_match_jax(carried):
    """batch_predict, marginal_predict and marginal_predictive_covariance
    (and the rc kernel Sober takes) within 1e-5 of their scale."""
    jm, pm = carried
    xq = np.linspace(-4, 4, 57).reshape(-1, 1).astype(np.float32)
    yq = xq[::3] + 0.05
    for got, want in zip(pm.batch_predict(t(xq)), jm.batch_predict(jnp.asarray(xq))):
        _close(got, want)
    for got, want in zip(pm.marginal_predict(t(xq)), jm.marginal_predict(jnp.asarray(xq))):
        _close(got, want)
    want = jm.marginal_predictive_covariance(jnp.asarray(xq), jnp.asarray(yq))
    _close(pm.marginal_predictive_covariance(t(xq), t(yq)), want)
    _close(pm.rc_kernel()(t(xq), t(yq)), want)
    xt = t(xq)
    _close(pm.rc_kernel()(xt, xt),
           jm.marginal_predictive_covariance(jnp.asarray(xq), jnp.asarray(xq)))
    _close(pm.marginal_predictive_mean(t(xq)),
           jm.marginal_predictive_mean(jnp.asarray(xq)))


@pytest.mark.parametrize("label", tf.FBGPAcquisitionFunction.LABELS)
def test_fbgp_acquisitions_match_jax(carried, label):
    """Each acquisition within 1e-5 of its scale (BQBC is the weighted
    mean of centred chain means: zero up to rounding, held absolutely)."""
    jm, pm = carried
    xq = np.linspace(-4, 4, 57).reshape(-1, 1).astype(np.float32)
    got = tf.FBGPAcquisitionFunction(pm, label)(t(xq)).numpy()
    want = np.asarray(jf.FBGPAcquisitionFunction(jm, label)(jnp.asarray(xq)))
    if label == "BQBC":
        assert np.abs(got).max() < 1e-6 and np.abs(want).max() < 1e-6
    else:
        _close(got, want)
    with pytest.raises(ValueError, match="Acquisition"):
        tf.FBGPAcquisitionFunction(pm, "PI")


def test_pi_matches_jax_and_keeps_the_lower_tail(base, hypers, carried):
    """pi of the carried distilled model within 1e-5 relative where it is
    above 1e-3. Then a one-chain model at the MAP hypers with noise 1e-2,
    whose pi falls below z = -6 next to low observations: there the port
    keeps Phi's float32 tail (torch.special.ndtr gives 0), equal to a
    float64 Phi of its own z within 1e-4, and JAX's within 1e-3 (z enters
    through mu_f - eta, whose cancellation |z| amplifies)."""
    jm, pm = carried
    xq = np.linspace(-3, 3, 61).reshape(-1, 1).astype(np.float32)
    got = tf.PIFBGP(pm)(t(xq)).numpy()
    want = np.asarray(jf.PIFBGP(jm)(jnp.asarray(xq)))
    big = want > 1e-3
    assert big.sum() > 10
    np.testing.assert_allclose(got[big], want[big], rtol=1e-5)
    np.testing.assert_allclose(tf.PIFBGP(pm)(t(xq), log=True).numpy(),
                               np.log(got + tf.EPS), rtol=1e-6)

    _, _, jgp, _ = base
    hy = np.asarray(hypers[0])
    theta = hy[:1].copy()
    theta[0, 1] = 1e-2
    jm1 = jf.FullyBayesianGP(jgp, jnp.ones(1), jnp.asarray(theta))
    pm1 = fbgp_from_numpy(fbgp_to_numpy(jm1), "cpu")
    xq = np.linspace(-3, 3, 601).reshape(-1, 1).astype(np.float32)
    mu, var = pm1.batch_predict(t(xq))
    z = ((mu - pm1.Theta_qd[:, :1]) / var.sqrt())[0]
    tail = (z < -6).numpy()
    assert tail.sum() >= 5
    assert float(torch.special.ndtr(z[tail]).max()) == 0.0
    got = tf.PIFBGP(pm1)(t(xq)).numpy()
    assert (got[tail] > 0).all()
    exact = 0.5 * scipy.special.erfc(-z.double().numpy() / np.sqrt(2.0))
    np.testing.assert_allclose(got[tail], exact[tail], rtol=1e-4)
    want = np.asarray(jf.PIFBGP(jm1)(jnp.asarray(xq)))
    np.testing.assert_allclose(got[tail], want[tail], rtol=1e-3)
    np.testing.assert_allclose(got[~tail], want[~tail], rtol=1e-3)


# ----------------------------------------------------------------------------
# Sober with an FBGP model
# ----------------------------------------------------------------------------

N_REC, N_NYS, BATCH = 512, 64, 8


def _legal(xb):
    return xb.shape == (BATCH, 1) and bool(((xb > -3) & (xb < 3)).all())


def test_sober_with_fbgp(base, carried):
    """Sober takes an FBGP model: pi and the kernel are the model's,
    next_batch gives a legal batch with and without an acquisition as
    calc_obj and with return_weights; step refuses the model."""
    _, _, jgp, gp = base
    _, pm = carried
    sober = Sober(Uniform([[-3.0], [3.0]], device="cpu"), pm)
    assert sober.fbgp and not sober.is_bq and sober.n_init == 25
    assert isinstance(sober.pi, tf.PIFBGP)
    assert _legal(sober.next_batch(N_REC, N_NYS, BATCH))
    assert _legal(sober.next_batch(N_REC, N_NYS, BATCH,
                                   calc_obj=tf.FBGPAcquisitionFunction(pm, "UCB")))
    w, xb = sober.next_batch(N_REC, N_NYS, BATCH, return_weights=True)
    assert _legal(xb) and (w >= 0).all() and abs(float(w.sum()) - 1.0) < 1e-4
    assert sober._targets().shape == (25,)
    with pytest.raises(TypeError, match="exact GP"):
        sober.step(gp.model.x, gp.Y_unwarp, N_REC, N_NYS, BATCH)


def test_step_fbgp(base):
    """step_fbgp at a small config: a legal batch, the model replaced by a
    FullyBayesianGP over the new observations, return_weights, an
    acquisition label; a wrong label or hyperprior width raises."""
    x, y, _, gp = base
    sober = Sober(Uniform([[-3.0], [3.0]], device="cpu"), tf.fbgp_refit(
        gp, tf.RBFHyperPrior(device="cpu"), n_hypers=50, n_nys=16, n_qd=8))
    old = sober.pi.model
    hp = tf.RBFHyperPrior(device="cpu")
    kw = dict(n_hypers=50, n_nys_qd=16, n_qd=8, bucket=BUCKET)
    xb = sober.step_fbgp(x, y, hp, N_REC, N_NYS, BATCH, **kw)
    assert _legal(xb)
    model = sober.pi.model
    assert model is not old and isinstance(model, tf.FullyBayesianGP)
    assert model.Theta_qd.shape == (8, 4) and float(model.mask.sum()) == 25
    assert sober.last_timings["total"] > 0
    x2 = np.concatenate([x, xb.numpy()])
    y2 = np.concatenate([y, np.exp(-0.5 * (xb.numpy()[:, 0] / 0.7) ** 2)])
    w, xb = sober.step_fbgp(x2, y2, hp, N_REC, N_NYS, BATCH, return_weights=True,
                            calc_obj="MES", **kw)
    assert _legal(xb) and (w >= 0).all() and abs(float(w.sum()) - 1.0) < 1e-4
    assert float(sober.pi.model.mask.sum()) == 33
    assert sober.pi.model.Xobs.shape[0] == 2 * BUCKET
    with pytest.raises(ValueError, match="calc_obj"):
        sober.step_fbgp(x, y, hp, N_REC, N_NYS, BATCH, calc_obj="PI", **kw)
    with pytest.raises(ValueError, match="n_ls"):
        sober.step_fbgp(x, y, tf.RBFHyperPrior(n_ls=2, device="cpu"), N_REC, N_NYS,
                        BATCH, **kw)
