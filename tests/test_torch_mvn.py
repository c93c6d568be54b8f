"""The port's Genz box probability and MVN CDF, the truncated-MVN samplers
and the TruncatedGaussian prior against the JAX package's on the CPU.

Deterministic stages (the Genz scan, its closed-form gradients, the normal
CDF helpers, the Gibbs setup, the tilting setup, the prior's constant and
density) are held tightly to JAX's on the same numpy inputs; the two
packages' random streams differ, so draws are held by distribution, to
JAX's draws and to tests/test_mvn.py's rejection truths within that file's
tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.priors import mvn_cdf as jm
from sober_tpu.priors import tmvn as jt
from sober_tpu.priors.continuous import TruncatedGaussian as JaxTG
from sober_tpu_torch.priors import TruncatedGaussian, TruncatedMVN
from sober_tpu_torch.priors import mvn_cdf as tm
from sober_tpu_torch.priors import tmvn as tt
from sober_tpu_torch.priors.continuous import tgauss_reject_sample

KEY = jax.random.key(0)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _spd(d, seed, ridge=None):
    a = np.random.default_rng(seed).normal(size=(d, d))
    return (a @ a.T + (d if ridge is None else ridge) * np.eye(d)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


# -- the Genz scan ---------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 5, 15])
def test_cdf_and_box_probability_match_jax(d):
    """multivariate_normal_cdf (a batch of three limits), mvn_box_prob and
    mvn_box_log_prob: 1e-5 relative. The Sobol nodes are the same bit for
    bit, so only the float32 arithmetic differs."""
    rng = np.random.default_rng(d)
    cov = _spd(d, d)
    mu = rng.normal(size=d).astype(np.float32)
    b = (mu + rng.normal(size=(3, d))).astype(np.float32)
    lo = (mu - 1.5 * np.sqrt(np.diag(cov)) + 0.2 * rng.normal(size=d)).astype(np.float32)
    j, t = jnp.asarray, torch.as_tensor
    want = np.asarray(jm.multivariate_normal_cdf(j(b), j(mu), j(cov)))
    got = tm.multivariate_normal_cdf(t(b), t(mu), t(cov)).numpy()
    assert got.shape == (3,) and _rel(got, want) < 1e-5
    want_box = float(jm.mvn_box_prob(j(lo), j(b[0]), j(mu), j(cov)))
    got_box = float(tm.mvn_box_prob(t(lo), t(b[0]), t(mu), t(cov)))
    assert want_box > 0 and _rel(got_box, want_box) < 1e-5
    want_log = float(jm.mvn_box_log_prob(j(lo), j(b[0]), j(mu), j(cov)))
    got_log = float(tm.mvn_box_log_prob(t(lo), t(b[0]), t(mu), t(cov)))
    assert abs(got_log - want_log) < 1e-5 * abs(want_log) + 1e-6


def test_batched_covariance_matches_jax():
    """A batch of covariances (torch-distributions broadcasting), and loc
    with batch dims that value lacks: 1e-5 relative."""
    rng = np.random.default_rng(2)
    d, nb = 3, 4
    covs = np.stack([_spd(d, 10 + k) for k in range(nb)])
    vals = rng.normal(size=(nb, d)).astype(np.float32)
    locs = (rng.normal(size=(nb, d)) * 0.3).astype(np.float32)
    j, t = jnp.asarray, torch.as_tensor
    want = np.asarray(jm.multivariate_normal_cdf(j(vals), j(locs), j(covs)))
    got = tm.multivariate_normal_cdf(t(vals), t(locs), t(covs)).numpy()
    assert got.shape == (nb,) and _rel(got, want) < 1e-5
    want_b = np.asarray(jm.multivariate_normal_cdf(j(vals[0]), j(locs), j(covs[0])))
    got_b = tm.multivariate_normal_cdf(t(vals[0]), t(locs), t(covs[0])).numpy()
    assert got_b.shape == (nb,) and _rel(got_b, want_b) < 1e-5


@pytest.mark.parametrize("d,a,b", [(2, -8.0, -6.0), (4, -10.0, -8.0),
                                   (4, -16.0, -14.0), (8, -8.0, -6.0)])
def test_far_tail_boxes_match_jax(d, a, b):
    """Boxes in the far tail at rho = 0.8 (tests/test_mvn.py's), the last
    pair beyond float32's linear range: log probabilities within 1e-4."""
    cov = (np.full((d, d), 0.8) + 0.2 * np.eye(d)).astype(np.float32)
    lo, hi, z = np.full(d, a, np.float32), np.full(d, b, np.float32), np.zeros(d, np.float32)
    want = float(jm.mvn_box_log_prob(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(z),
                                     jnp.asarray(cov)))
    got = float(tm.mvn_box_log_prob(torch.as_tensor(lo), torch.as_tensor(hi),
                                    torch.as_tensor(z), torch.as_tensor(cov)))
    assert np.isfinite(got) and abs(got - want) < 1e-4


@pytest.mark.parametrize("d", [1, 3])
def test_gradients_match_jax_grad(d):
    """The autograd Function's backward against jax.grad of the custom JVP,
    in value (a batch of three), loc and covariance: 1e-4 relative to each
    gradient's largest entry. d = 3 runs the second-order conditional CDFs
    of the covariance term; d = 2's is test_gradient_of_one_input_and_
    batched_covariances."""
    rng = np.random.default_rng(20 + d)
    cov = _spd(d, 30 + d)
    val = (rng.normal(size=(3, d)) * 0.5).astype(np.float32)
    loc = (rng.normal(size=d) * 0.3).astype(np.float32)
    weights = np.array([1.0, -2.0, 0.5], np.float32)

    def f(v, l, c):
        return jnp.sum(jm.multivariate_normal_cdf(v, l, c) * weights)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(val), jnp.asarray(loc),
                                          jnp.asarray(cov))
    leaves = [torch.tensor(a, requires_grad=True) for a in (val, loc, cov)]
    torch.sum(tm.multivariate_normal_cdf(*leaves) * torch.as_tensor(weights)).backward()
    for w, leaf in zip(want, leaves):
        w = np.asarray(w)
        assert leaf.grad.shape == w.shape
        assert np.abs(leaf.grad.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_gradient_of_one_input_and_batched_covariances():
    """Only the asked-for input gets a gradient (value alone: the
    covariance branch does not run), and the covariance gradient through a
    batch of covariances matches jax.grad: 1e-4 relative."""
    rng = np.random.default_rng(3)
    d, nb = 2, 3
    covs = np.stack([_spd(d, 40 + k) for k in range(nb)])
    vals = (rng.normal(size=(nb, d)) * 0.5).astype(np.float32)

    def f(c):
        sym = 0.5 * (c + jnp.swapaxes(c, -1, -2))
        return jnp.sum(jm.multivariate_normal_cdf(jnp.asarray(vals), jnp.zeros((nb, d)), sym))

    want = np.asarray(jax.grad(f)(jnp.asarray(covs)))
    c = torch.tensor(covs, requires_grad=True)
    sym = 0.5 * (c + c.transpose(-1, -2))
    torch.sum(tm.multivariate_normal_cdf(torch.as_tensor(vals), torch.zeros(nb, d),
                                         sym)).backward()
    assert np.abs(c.grad.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    v = torch.tensor(vals[0], requires_grad=True)
    cov0 = torch.as_tensor(covs[0])
    tm.multivariate_normal_cdf(v, torch.zeros(d), cov0).backward()
    want_v = np.asarray(jax.grad(lambda x: jm.multivariate_normal_cdf(
        x, jnp.zeros(d), jnp.asarray(covs[0])))(jnp.asarray(vals[0])))
    assert cov0.grad is None
    assert np.abs(v.grad.numpy() - want_v).max() <= 1e-4 * np.abs(want_v).max()


def test_normal_helpers_match_jax():
    """Phi, log Phi and the clipped inverse Phi on z in [-40, 10], and
    _ndtri_log on log p down to -5000. Phi in the erfc form keeps the lower
    tail as JAX's ndtr does: 1e-5 relative wherever JAX's value is a normal
    float32 (above 1e-37); below, JAX's XLA flushes subnormals to 0 where
    torch keeps them, so within float32's smallest normal (1.18e-38)
    absolute; log Phi 1e-5 relative (plus 1e-7 absolute where it is ~0);
    the inverses 1e-5 relative (plus 1e-5 absolute near 0), _ndtri_log to
    JAX's in the lower tail and to float64 scipy wherever exp(log p) is a
    float64."""
    z = np.concatenate([np.linspace(-40.0, 10.0, 1001), [-12.5, -5.5, 0.0]]).astype(np.float32)
    zj, zt = jnp.asarray(z), torch.as_tensor(z)
    phi_j = np.asarray(jax.scipy.special.ndtr(zj), np.float64)
    phi_t = tm._phi(zt).numpy().astype(np.float64)
    normal = phi_j > 1e-37
    assert _rel(phi_t[normal], phi_j[normal]) < 1e-5
    assert np.abs(phi_t[~normal] - phi_j[~normal]).max() <= np.finfo(np.float32).tiny
    log_j = np.asarray(jax.scipy.special.log_ndtr(zj))
    assert np.all(np.abs(tm._log_phi(zt).numpy() - log_j) <= 1e-5 * np.abs(log_j) + 1e-7)
    p = np.clip(phi_j, 1e-30, 1 - 1e-7).astype(np.float32)
    inv_j = np.asarray(jt._phinv(jnp.asarray(p)))
    inv_t = tt._phinv(torch.as_tensor(p)).numpy()
    assert np.all(np.abs(inv_t - inv_j) <= 1e-5 * np.abs(inv_j) + 1e-5)
    logp = -np.concatenate([np.logspace(-7, np.log10(5000.0), 400), [15.0, 5000.0]])
    logp = logp.astype(np.float32)
    back_j = np.asarray(jm._ndtri_log(jnp.asarray(logp)))
    back_t = tm._ndtri_log(torch.as_tensor(logp)).numpy()
    # above log p ~ -1e-3 (z > 3) JAX's float32 log_ndtr is coarse (z off by
    # up to 0.015 at z ~ 5); there the port is held to float64 scipy instead
    tail = logp < -1e-3
    assert np.all(np.abs(back_t - back_j)[tail] <= 1e-5 * np.abs(back_j[tail]) + 1e-5)
    from scipy.special import ndtri

    f64 = logp > -700.0
    truth = ndtri(np.exp(logp[f64].astype(np.float64)))
    assert np.all(np.abs(back_t[f64] - truth) <= 1e-5 * np.abs(truth) + 1e-5)
    assert np.isfinite(back_t).all() and back_t.min() < -99.0


# -- the truncated-MVN samplers -------------------------------------------------

def _rho_box(rho, lo, hi, mu=(0.0, 0.0)):
    cov = np.array([[1.0, rho], [rho, 1.0]])
    return np.asarray(mu, float), cov, np.asarray(lo, float), np.asarray(hi, float)


def _d15():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(15, 15))
    cov = a @ a.T + 0.5 * np.eye(15)
    sd = np.sqrt(np.diag(cov))
    mu = rng.normal(size=15)
    return mu, cov, mu - 1.5 * sd, mu + 1.5 * sd


# tests/test_mvn.py's boxes: (mu, cov, lo, hi), rejection proposals, Gibbs
# mean and sd tolerances in sd units
CASES = {
    "correlated": (_rho_box(0.6, [-0.5, -2.0], [1.5, 0.5], mu=(0.5, -0.5)),
                   400_000, 0.03, 0.03),
    "rho095": (_rho_box(0.95, [-1.0, -1.5], [2.0, 1.0]), 2_000_000, 0.05, 0.06),
    "tail": (_rho_box(0.8, [2.0, 2.0], [4.0, 4.0]), 6_000_000, 0.08, 0.10),
    "d15": (_d15(), 4_000_000, 0.06, 0.06),
}


def _truth(mu, cov, lo, hi, n_prop, seed=1, chunk=500_000):
    """Moments of the box's rejection draws, drawn in chunks."""
    rng = np.random.default_rng(seed)
    chol = np.linalg.cholesky(cov)
    keep = []
    for start in range(0, n_prop, chunk):
        raw = mu + rng.standard_normal((min(chunk, n_prop - start), len(mu))) @ chol.T
        keep.append(raw[((raw > lo) & (raw < hi)).all(axis=1)])
    keep = np.concatenate(keep)
    assert len(keep) > 500
    return keep.mean(0), keep.std(0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gibbs_setup_matches_jax(case):
    """prec and cond_sd within 1e-5 relative of JAX's, and the same
    burn_in, computed in float64 from each package's float32 precision."""
    (mu, cov, lo, hi), *_ = CASES[case]
    bounds = np.stack([lo, hi])
    js = jt.TruncatedMVN(mu, cov, bounds)
    ts = TruncatedMVN(mu, cov, bounds, device="cpu")
    prec_j = np.asarray(js.prec)
    assert np.abs(ts.prec.numpy() - prec_j).max() <= 1e-5 * np.abs(prec_j).max()
    assert _rel(ts.cond_sd.numpy(), np.asarray(js.cond_sd)) < 1e-5
    assert ts.burn_in == js.burn_in
    if case == "rho095":
        assert ts.burn_in > 50


@pytest.mark.parametrize("case", ["correlated", "rho095", "tail"])
def test_gibbs_draws_match_jax_and_truth(case):
    """20,000 Gibbs draws of each package inside the box, their marginal
    means and sds within test_mvn.py's tolerances (in sd units) of the
    rejection truth and of each other. The d = 15 box's setup is held in
    test_gibbs_setup_matches_jax and its draws by tilting: its 1,100 Gibbs
    coordinate steps on 20,000 rows take over a minute on a loaded CPU."""
    (mu, cov, lo, hi), n_prop, mean_tol, sd_tol = CASES[case]
    bounds = np.stack([lo, hi])
    mean, sd = _truth(mu, cov, lo, hi, n_prop)
    xj = np.asarray(jt.TruncatedMVN(mu, cov, bounds).sample(KEY, 20_000))
    xt = TruncatedMVN(mu, cov, bounds, device="cpu").sample(_gen(), 20_000).numpy()
    assert ((xt > lo - 1e-4) & (xt < hi + 1e-4)).all()
    for x in (xt, xj):
        assert (np.abs(x.mean(0) - mean) / sd < mean_tol).all()
        assert (np.abs(x.std(0) - sd) / sd < sd_tol).all()
    assert (np.abs(xt.mean(0) - xj.mean(0)) / sd < 2 * mean_tol).all()


@pytest.mark.parametrize("case", ["correlated", "tail", "d15"])
def test_tilting_factors_match_jax(case):
    """The host setup in float64 on both sides: the ordered Cholesky, the
    permutation and the saddle point's psistar within 1e-10; the float32
    factors equal."""
    (mu, cov, lo, hi), *_ = CASES[case]
    lj, pj, lbj, ubj = jt._colperm_chol_np(cov, lo - mu, hi - mu)
    lt, pt, lbt, ubt = tt._colperm_chol_np(cov, lo - mu, hi - mu)
    np.testing.assert_array_equal(pt, pj)
    for a, b in ((lt, lj), (lbt, lbj), (ubt, ubj)):
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(b).max(), 1.0)
    fj = jt.TiltingFactors.build(mu, cov, lo, hi)
    ft = tt.TiltingFactors.build(mu, cov, lo, hi, device="cpu")
    assert abs(ft.psistar - fj.psistar) <= 1e-10 * max(abs(fj.psistar), 1.0)
    for name in ("l_scaled", "l_unscaled", "lb", "ub", "mu_tilt", "inv_perm"):
        np.testing.assert_array_equal(getattr(ft, name).numpy(), np.asarray(getattr(fj, name)))


@pytest.mark.parametrize("case,mean_tol,sd_tol,rate", [
    ("correlated", 0.03, 0.04, 0.3), ("tail", 0.04, 0.05, 0.5), ("d15", 0.05, 0.05, 0.1)])
def test_tilting_draws_match_jax_and_truth(case, mean_tol, sd_tol, rate):
    """iid tilting draws at test_mvn.py's tighter tolerances, against the
    rejection truth and JAX's draws, with its acceptance-rate floors."""
    (mu, cov, lo, hi), n_prop, _, _ = CASES[case]
    bounds = np.stack([lo, hi])
    mean, sd = _truth(mu, cov, lo, hi, n_prop)
    js = jt.TruncatedMVN(mu, cov, bounds, method="tilting")
    ts = TruncatedMVN(mu, cov, bounds, method="tilting", device="cpu")
    xj = np.asarray(js.sample(KEY, 20_000))
    xt = ts.sample(_gen(), 20_000).numpy()
    assert ((xt > lo - 1e-4) & (xt < hi + 1e-4)).all()
    for x in (xt, xj):
        assert (np.abs(x.mean(0) - mean) / sd < mean_tol).all()
        assert (np.abs(x.std(0) - sd) / sd < sd_tol).all()
    assert ts.last_accept_rate > rate and js.last_accept_rate > rate
    assert abs(ts.last_accept_rate - js.last_accept_rate) < 0.05


def test_tilting_deep_univariate_tail_and_method_check():
    """d = 1 five sd out (no free tilting coordinate): truncnorm's moments
    within 0.01; an unknown method raises."""
    from scipy.stats import truncnorm

    s = TruncatedMVN(np.zeros(1), np.eye(1), np.array([[5.0], [6.0]]),
                     method="tilting", device="cpu").sample(_gen(), 4000).numpy()[:, 0]
    assert ((s >= 5.0) & (s <= 6.0)).all()
    assert abs(s.mean() - truncnorm(5.0, 6.0).mean()) < 0.01
    assert abs(s.std() - truncnorm(5.0, 6.0).std()) < 0.01
    with pytest.raises(ValueError):
        TruncatedMVN(np.zeros(2), np.eye(2), np.array([[0.0, 0.0], [1.0, 1.0]]),
                     method="botev", device="cpu")


# -- TruncatedGaussian -----------------------------------------------------------

# tests/test_fused_sampling.py:841-856's two priors: a box that holds most
# of the mass (rejection) and one far from the mean (the Gibbs chain)
REGIMES = {"rejection": ([0.5, 0.5], 0.3 * np.eye(2)),
           "gibbs": ([3.0, 3.0], 0.25 * np.eye(2))}
UNIT = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_truncated_gaussian_matches_jax(regime):
    """constant (the Genz box probability, at least 1e-8) and pdf within
    1e-5 relative, the same regime, and draws inside the box whose moments
    agree with JAX's within 0.05."""
    mu, cov = REGIMES[regime]
    jp = JaxTG(jnp.asarray(mu, jnp.float32), jnp.asarray(cov, jnp.float32), jnp.asarray(UNIT))
    tp = TruncatedGaussian(mu, cov, UNIT, device="cpu")
    assert tp._use_gibbs == jp._use_gibbs == (regime == "gibbs")
    assert _rel(float(tp.constant), float(jp.constant)) < 1e-5
    x = np.random.default_rng(4).uniform(-0.2, 1.2, (256, 2)).astype(np.float32)
    want = np.asarray(jp.pdf(jnp.asarray(x)))
    got = tp.pdf(torch.as_tensor(x)).numpy()
    assert ((want == 0) == (got == 0)).all()
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want))
    xt = tp.sample(_gen(), 20_000).numpy()
    xj = np.asarray(jp.sample(KEY, 20_000))
    assert ((xt >= 0) & (xt <= 1)).all()
    assert np.allclose(xt.mean(0), xj.mean(0), atol=0.05)
    assert np.allclose(xt.std(0), xj.std(0), atol=0.05)


def test_rejection_rounds_then_clip():
    """With no rejection round every row outside the box is clipped onto
    it, as the JAX package's tgauss_reject_sample does; with ten rounds
    (the default) a box of mass 0.75 leaves no row outside in 4096."""
    mu, chol = torch.zeros(2), torch.eye(2)
    lb, ub = torch.tensor([-0.2, -0.2]), torch.tensor([0.3, 0.3])
    x0 = tgauss_reject_sample(_gen(1), mu, chol, lb, ub, 4096, 0)
    on_edge = ((x0 == lb) | (x0 == ub)).any(dim=1)
    assert ((x0 >= lb) & (x0 <= ub)).all() and on_edge.float().mean() > 0.9
    x10 = tgauss_reject_sample(_gen(2), mu, torch.eye(2), torch.tensor([-1.5, -1.5]),
                               torch.tensor([1.5, 1.5]), 4096, 10)
    assert not ((x10 == -1.5) | (x10 == 1.5)).any()
