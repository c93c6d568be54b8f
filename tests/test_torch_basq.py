"""The port's warped BQ model and BASQ against the JAX package's on the CPU:
ScaleMmltGP's warps, its g-space predictions, kernel and pi from a carried
state, the MixtureSampler's density on a carried proposal, Sober with a BQ
model, and BASQ's evidence of a Gaussian likelihood (and of one shifted by
500 in log space) with its posterior sampling and MAP."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core.sampler import MixtureSampler as JaxMixture
from sober_tpu.gp import warped as jw
from sober_tpu.priors import continuous as jc
from sober_tpu.priors.wkde import WeightedKernelDensityEstimation as JaxWKDE
from sober_tpu_torch import Sober
from sober_tpu_torch.apps.basq import BASQ
from sober_tpu_torch.core.sampler import MixtureSampler
from sober_tpu_torch.gp import warped as tw
from sober_tpu_torch.interop import (continuous_prior_from_numpy,
                                     continuous_prior_to_numpy,
                                     scale_mmlt_from_numpy, scale_mmlt_to_numpy)
from sober_tpu_torch.priors import Uniform
from sober_tpu_torch.utils.prng import KeyRing

t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))
TRUTH = np.log(np.sqrt(2 * np.pi) * 0.7 / 6.0)


def _loglik_data(n=40, seed=0):
    """A 1-d Gaussian log-likelihood surface on [-3, 3], peak at 0."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    return x, (-0.5 * (x[:, 0] / 0.7) ** 2).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """A JAX ScaleMmltGP on 40 points and its copy in the port."""
    x, ll = _loglik_data()
    jm = jw.ScaleMmltGP(jnp.asarray(x), jnp.asarray(ll))
    return x, ll, jm, scale_mmlt_from_numpy(scale_mmlt_to_numpy(jm), "cpu")


def test_warps_match_jax(carried):
    """beta equals JAX's, and the warped targets h = log(exp(y - beta) + 1)
    are JAX's within 2 ulp (the two libraries' exp and log round apart);
    the g <-> h warps round-trip; the port's own fit conditions on them."""
    x, ll, jm, _ = carried
    m = tw.ScaleMmltGP(t(x), t(ll))
    assert float(m.beta) == float(jm.beta)
    np.testing.assert_allclose(m.model.y.numpy(), np.asarray(jm.model.y), rtol=2.4e-7)
    g = t([0.3, 1.5, 0.0])
    np.testing.assert_allclose(m.unwarp_from_h_to_g(m.warp_from_g_to_h(g)).numpy(),
                               g.numpy(), atol=1e-6)
    mu_g, _ = m.gspace_predict(t(x))
    want = np.exp(ll - float(m.beta))
    assert np.corrcoef(mu_g.numpy(), want)[0, 1] > 0.99
    m.update(t(x[:5] + 0.01), t(ll[:5]))
    assert m.model.x.shape[0] == 45 and m.y_log.shape[0] == 45


def test_carried_predictions_match_jax(carried):
    """From JAX's state: h- and g-space predictions, the g-space kernel and
    pi within 1e-5 of their scale. The noise is 1e-10, so the posterior
    variances and covariances between dense observations are cancellation
    (k - v^T v); they are held against the prior's scale: the outputscale,
    times mu_g^2 in g-space."""
    x, _, jm, pm = carried
    xq = np.linspace(-3, 3, 40).reshape(-1, 1).astype(np.float32)
    yq = xq[::2] + 0.04
    os_ = float(pm.model.kernel.params["outputscale"])
    close = lambda got, want, scale: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * scale)
    mu_h, var_h = pm.hspace_predict(t(xq))
    jmu_h, jvar_h = jm.hspace_predict(jnp.asarray(xq))
    close(mu_h, jmu_h, np.abs(np.asarray(jmu_h)).max())
    close(var_h, jvar_h, os_)
    mu_g, var_g = pm.gspace_predict(t(xq))
    jmu_g, jvar_g = jm.gspace_predict(jnp.asarray(xq))
    g2 = float(np.abs(np.asarray(jmu_g)).max()) ** 2
    close(mu_g, jmu_g, np.abs(np.asarray(jmu_g)).max())
    close(var_g, jvar_g, g2 * os_)
    close(pm.gspace_kernel(t(xq), t(yq)),
          jm.gspace_kernel(jnp.asarray(xq), jnp.asarray(yq)), g2 * os_)
    close(pm.rc_kernel()(t(xq), t(yq)),
          jm.gspace_kernel(jnp.asarray(xq), jnp.asarray(yq)), g2 * os_)
    xt = t(xq)
    close(pm.rc_kernel()(xt, xt), jm.gspace_kernel(jnp.asarray(xq), jnp.asarray(xq)),
          g2 * os_)
    pi = tw.PIBQ(pm)(t(xq)).numpy()
    jpi = np.asarray(jw.PIBQ(jm)(jnp.asarray(xq)))
    assert (pi >= 0).all() and (pi <= 1).all()
    np.testing.assert_allclose(pi, jpi, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.PIBQ(pm)(t(xq), log=True).numpy(),
                               np.log(pi + tw.EPS), rtol=1e-6)


def test_mixture_sampler_matches_jax():
    """MixtureSampler over a carried WKDE proposal and a Uniform prior: the
    density equals JAX's; a draw takes int(ratio * n) rows from the
    proposal and the rest from the prior."""
    rng = np.random.default_rng(2)
    bounds = np.array([[-3.0, -3.0], [3.0, 3.0]], np.float32)
    pts = rng.normal(0.0, 0.8, (300, 2)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 300).astype(np.float32)
    jwkde = JaxWKDE(jnp.asarray(pts), jnp.asarray(w / w.sum()), 2,
                    bounds=jnp.asarray(bounds), key=jax.random.key(0))
    wkde = continuous_prior_from_numpy(continuous_prior_to_numpy(jwkde), "cpu")
    jprior, prior = jc.Uniform(jnp.asarray(bounds)), Uniform(bounds, device="cpu")
    xq = rng.uniform(-3.5, 3.5, (200, 2)).astype(np.float32)
    for ratio in (0.3, 1.0):
        mix = MixtureSampler(prior, SimpleNamespace(prior=wkde), ratio_wkde=ratio)
        jmix = JaxMixture(jprior, SimpleNamespace(prior=jwkde), ratio_wkde=ratio)
        np.testing.assert_allclose(mix.pdf(t(xq)).numpy(),
                                   np.asarray(jmix.pdf(jnp.asarray(xq))),
                                   rtol=1e-5, atol=1e-8)
    mix = MixtureSampler(prior, SimpleNamespace(prior=wkde), ratio_wkde=0.25)
    draws = mix.sample(torch.Generator().manual_seed(0), 4000)
    assert draws.shape == (4000, 2) and torch.isfinite(draws).all()
    # the proposal's rows (first 1000) concentrate near 0; the prior's fill
    # the box
    assert float(draws[:1000].std()) < 1.2 < float(draws[1000:].std())


def _fit_and_sober(shift=0.0):
    """tests/test_bq_fbgp.py's BASQ setup in the port: 100 Sobol points of
    U(-3, 3), a ScaleMmltGP on their log-likelihoods (plus `shift`), and a
    Sober whose proposal has learned from one next_batch."""
    keys = KeyRing(0, device="cpu")
    prior = Uniform([[-3.0], [3.0]], device="cpu")
    x = prior.sample(keys.next(), 100)
    model = tw.ScaleMmltGP(x, shift - 0.5 * (x[:, 0] / 0.7) ** 2)
    sober = Sober(prior, model)
    assert sober.is_bq and not sober.fbgp and sober.n_init == 100
    xb = sober.next_batch(512, 64, 8)
    assert xb.shape == (8, 1) and bool(((xb > -3) & (xb < 3)).all())
    return prior, model, sober


def test_gaussian_evidence():
    """The evidence of N(x; 0, 0.7^2) under U(-3, 3), sqrt(2 pi) 0.7 / 6,
    within 0.15 in log space; posterior draws centred at 0; the MAP near 0;
    Sober.step refuses the BQ model."""
    prior, model, sober = _fit_and_sober()
    basq = BASQ(prior, model, sober, verbose=False)
    with pytest.raises(ValueError, match="Evidence"):
        basq.posterior(t([[0.0]]))
    elml, avlml = basq.quadrature(2048, 128, 32)
    assert abs(elml - TRUTH) < 0.15 and np.isfinite(avlml)
    samples = basq.sampling_posterior(200)
    assert samples.shape == (200, 1) and abs(float(samples.mean())) < 0.3
    assert abs(float(basq.MAP(500)[0])) < 0.5
    assert float(basq.EML) == pytest.approx(np.exp(elml - float(model.beta)), rel=1e-5)
    post = basq.posterior(t([[0.0], [2.9]]))
    assert float(post[0]) > float(post[1]) >= 0
    with pytest.raises(TypeError, match="exact GP"):
        sober.step(model.model.x, model.y_log, 512, 64, 8)


def test_huge_loglik_no_overflow():
    """beta = max log-likelihood ~ 500 (exp(beta) overflows float32): the
    log-space evidence is finite and within 0.5 of the truth, and the
    posterior machinery still concentrates near 0."""
    prior, model, sober = _fit_and_sober(shift=500.0)
    basq = BASQ(prior, model, sober, verbose=False)
    elml, _ = basq.quadrature(2048, 128, 32)
    assert np.isfinite(elml) and abs(elml - (500.0 + TRUTH)) < 0.5
    samples = basq.sampling_posterior(200)
    assert abs(float(samples.mean())) < 0.3 and float(samples.std()) < 1.5
    assert abs(float(basq.MAP(500)[0])) < 0.5
