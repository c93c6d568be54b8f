"""The port's continuous-domain modules against the JAX package's on the
CPU: the linear-algebra remainder, the Sobol points, the Uniform and
Gaussian priors, KMeans, the WKDE, the proposal update, the synthetic
objectives, the warm start, the exploit polish and the RBF Gram's
gradient. Inputs are made with numpy from seeds and handed to both;
deterministic stages are held tightly, random ones by distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core import prior_update as jpu
from sober_tpu.gp import exact as jx
from sober_tpu.ops.kmeans import kmeans as jkmeans
from sober_tpu.priors import continuous as jc
from sober_tpu.priors import wkde as jwk
from sober_tpu.tasks import synthetic as jsyn
from sober_tpu.utils import linalg as jla
from sober_tpu.utils import sobol as jsob
from sober_tpu_torch.core import prior_update as tpu
from sober_tpu_torch.gp import exact as tx
from sober_tpu_torch.interop import (continuous_prior_from_numpy,
                                     continuous_prior_to_numpy,
                                     gp_state_from_numpy, gp_state_to_numpy)
from sober_tpu_torch.ops.kmeans import kmeans, kmeans_resampling
from sober_tpu_torch.ops.rbf_gram import rbf_gram_backward, rbf_gram_reference
from sober_tpu_torch.priors import continuous as tc
from sober_tpu_torch.priors import wkde as twk
from sober_tpu_torch.tasks import synthetic as tsyn
from sober_tpu_torch.utils import linalg as tla
from sober_tpu_torch.utils import sobol as tsob
from sober_tpu_torch.utils.prng import KeyRing

t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
j = lambda a: jnp.asarray(np.asarray(a, np.float32))


def close(got, want, tol, rel=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1.0) if rel else 1.0
    np.testing.assert_array_less(np.abs(got - want) / scale, tol)


# ----------------------------------------------------------------------------
# linear algebra (tolerance 1e-6: the same float32 formulas)
# ----------------------------------------------------------------------------

def _spd(n, seed, cond_jitter=0.0):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return (a @ a.T / n + cond_jitter * np.eye(n)).astype(np.float32)


LINALG = {
    "remove_anomalies": lambda m: m.remove_anomalies(
        (t if m is tla else j)([1.0, np.nan, np.inf, -np.inf, -1e30, 2.5])),
    "remove_anomalies_uniform": lambda m: m.remove_anomalies_uniform(
        *((t if m is tla else j)(a) for a in (
            np.random.default_rng(0).uniform(-1.2, 1.2, (50, 3)),
            [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]))),
    "make_psd": lambda m: m.make_psd((t if m is tla else j)(_spd(5, 1))),
    "make_psd_rank_deficient": lambda m: m.make_psd(
        (t if m is tla else j)(np.ones((4, 4)))),
    "solve_psd": lambda m: m.solve_psd((t if m is tla else j)(_spd(6, 2, 0.5)),
                                       (t if m is tla else j)(np.arange(6.0))),
    "mvn_logpdf": lambda m: m.mvn_logpdf(
        (t if m is tla else j)(np.random.default_rng(3).normal(size=(40, 3))),
        (t if m is tla else j)([0.1, -0.2, 0.3]),
        (t if m is tla else j)(np.linalg.cholesky(_spd(3, 4, 0.5)))),
    "safe_mvn_prob": lambda m: m.safe_mvn_prob(
        (t if m is tla else j)([0.1, -0.2, 0.3]),
        (t if m is tla else j)(_spd(3, 5, 0.5)),
        (t if m is tla else j)(np.random.default_rng(6).normal(size=(40, 3)))),
    "jitter_cholesky_escalates": lambda m: m.jitter_cholesky(
        (t if m is tla else j)(np.ones((5, 5)) - 1e-3 * np.eye(5)))[0],
}


@pytest.mark.parametrize("name", sorted(LINALG))
def test_linalg_matches_jax(name):
    got, want = LINALG[name](tla), LINALG[name](jla)
    assert got.dtype in (torch.float32, torch.bool)
    close(got.numpy(), np.asarray(want), 1e-6, rel=True)


@pytest.mark.parametrize("case", ["indefinite", "nan"])
def test_jitter_cholesky_escalates_and_falls_back_like_jax(case):
    """A matrix that climbs the ladder (ones - 0.001 I) takes JAX's rung and
    factor; one that no rung factors (all NaN) falls back to JAX's diagonal:
    1e-6 relative."""
    a = (np.ones((6, 6), np.float32) - 1e-3 * np.eye(6, dtype=np.float32)
         if case == "indefinite" else np.full((3, 3), np.nan, np.float32))
    got = tla.jitter_cholesky(t(a), max_tries=4)
    want = jla.jitter_cholesky(j(a), max_tries=4)
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), 1e-6, rel=True)


# ----------------------------------------------------------------------------
# Sobol points: bit for bit
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 4, 10])
@pytest.mark.parametrize("offset", [0, 4096])
def test_sobol_matches_jax_bit_for_bit(d, offset):
    js = jsob.sobol_engine(d, seed=d)
    ts = tsob.sobol_engine(d, seed=d, device="cpu")
    assert np.array_equal(ts.sv.numpy(), np.asarray(js.sv, np.int64))
    got = tsob.sobol_sample(ts, offset, 3000).numpy()
    want = np.asarray(jsob.sobol_sample(js, offset, 3000))
    assert got.dtype == np.float32 and got.shape == (3000, d)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ----------------------------------------------------------------------------
# the Uniform and Gaussian priors (1e-6)
# ----------------------------------------------------------------------------

def test_uniform_matches_jax():
    bounds = np.array([[-2.0, 0.0, 1.0], [3.0, 1.0, 5.0]], np.float32)
    jp, tp = jc.Uniform(j(bounds), seed=4), tc.Uniform(bounds, seed=4, device="cpu")
    for _ in range(2):                     # the offset advances alike
        got, want = tp.sample(None, 500), jp.sample(None, 500)
        close(got.numpy(), np.asarray(want), 1e-6)
    assert tp._offset == jp._offset == 1000
    x = np.random.default_rng(0).uniform(-2.5, 5.5, (300, 3)).astype(np.float32)
    x[:3] = bounds[0]                      # on the boundary: outside
    for fn in ("pdf", "logpdf"):
        got = getattr(tp, fn)(t(x)).numpy()
        want = np.asarray(getattr(jp, fn)(j(x)))
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        close(got[fin], want[fin], 1e-6, rel=True)
    # interop carries the engine and its offset
    carried = continuous_prior_from_numpy(continuous_prior_to_numpy(jp), "cpu")
    close(carried.sample(None, 64).numpy(), np.asarray(jp.sample(None, 64)), 1e-6)
    assert not tc.Uniform(bounds, qmc=False, device="cpu").sample(
        KeyRing(0, device="cpu").next(), 8).isnan().any()


def test_gaussian_matches_jax():
    mu = np.array([0.3, -0.1], np.float32)
    cov = np.array([[0.5, 0.1], [0.1, 0.4]], np.float32)
    jp, tp = jc.Gaussian(j(mu), j(cov)), tc.Gaussian(mu, cov, device="cpu")
    close(tp.chol.numpy(), np.asarray(jp.chol), 1e-6)
    x = np.random.default_rng(1).normal(size=(200, 2)).astype(np.float32)
    for fn in ("pdf", "logpdf"):
        close(getattr(tp, fn)(t(x)).numpy(), np.asarray(getattr(jp, fn)(j(x))),
              1e-6, rel=True)
    s = tp.sample(KeyRing(0, device="cpu").next(), 20000).numpy()
    # sampling noise of 20000 draws: the mean's standard error is 0.005
    assert np.abs(s.mean(0) - mu).max() < 0.03
    assert np.abs(np.cov(s.T) - cov).max() < 0.03


# ----------------------------------------------------------------------------
# KMeans (1e-5: the same Lloyd iterations from the same start)
# ----------------------------------------------------------------------------

def test_kmeans_matches_jax_on_separated_clusters():
    rng = np.random.default_rng(0)
    centres = rng.uniform(-10, 10, (6, 3))
    x = np.concatenate([c + 0.3 * rng.normal(size=(80, 3)) for c in centres])
    x = x[rng.permutation(len(x))].astype(np.float32)
    jl, jcent = jkmeans(j(x), 6, 10)
    tl, tcent = kmeans(t(x), 6, 10)
    close(tcent.numpy(), np.asarray(jcent), 1e-5, rel=True)
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    close(kmeans_resampling(t(x), 6).numpy(), np.asarray(jcent), 1e-5, rel=True)


def test_kmeans_keeps_the_centroid_of_an_empty_cluster():
    x = torch.tensor([[0.0, 0.0], [0.0, 0.0], [5.0, 5.0], [5.1, 5.0]])
    labels, c = kmeans(x, 3, 5)
    assert torch.equal(c[1], torch.zeros(2))       # the duplicate start stays
    assert labels.tolist() == [0, 0, 2, 2]


# ----------------------------------------------------------------------------
# the WKDE (1e-5)
# ----------------------------------------------------------------------------

def _pool(n=600, d=2, seed=0, n_pos=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    w = np.exp(-4 * np.sum((x - 0.3) ** 2, 1)).astype(np.float32)
    if n_pos is not None:                  # a few comparable weights
        w[:n_pos] = rng.uniform(0.5, 1.0, n_pos)
        w[n_pos:] = 0.0
    return x, w / w.sum()


def _jax_fit(x, w, n_kde, bw="scott"):
    return jwk._wkde_fit(jax.random.key(0), j(x), j(w), n_kde, bw, x.shape[1])


@pytest.mark.parametrize("bw", ["scott", "silverman"])
def test_wkde_fit_matches_jax_on_the_rich_branch(bw):
    """n_kde = N: the inverse-weight draw takes every row, in an order of
    its own, so the components match as a set and the rest to 1e-5."""
    x, w = _pool()
    want = _jax_fit(x, w, len(x), bw)
    got = twk.wkde_fit(KeyRing(0, device="cpu").next(), t(x), t(w), len(x), bw, 2)
    order = lambda a: np.lexsort(np.asarray(a).T[::-1])
    close(got["x_obs"].numpy()[order(got["x_obs"])],
          np.asarray(want["x_obs"])[order(want["x_obs"])], 1e-6)
    for k in ("covariance", "chol", "log_norm", "neff", "bw"):
        close(got[k].numpy(), np.asarray(want[k]), 1e-5, rel=True)


def test_wkde_fit_matches_jax_on_the_poor_branch():
    """Fewer than 5 distinct weights: the positive-weight rows first, in
    index order (a stable argsort), exactly as JAX."""
    x, w = _pool(n_pos=3)
    want = _jax_fit(x, w, 64)
    got = twk.wkde_fit(KeyRing(0, device="cpu").next(), t(x), t(w), 64, "scott", 2)
    assert np.array_equal(got["x_obs"].numpy(), np.asarray(want["x_obs"]))
    for k in ("weights", "covariance", "chol", "log_norm", "neff", "bw"):
        close(got[k].numpy(), np.asarray(want[k]), 1e-5, rel=True)


@pytest.mark.parametrize("bounded", [True, False])
def test_wkde_pdf_matches_jax(bounded, monkeypatch):
    """From carried parameters, relative 1e-5; in row blocks of 97 (the
    full-width block is 65,536 rows) it gives the same values."""
    x, w = _pool()
    params = _jax_fit(x, w, len(x))
    bounds = np.array([[-1.0, -1.0], [1.0, 1.0]], np.float32) if bounded else None
    jprior = jwk.WeightedKernelDensityEstimation.from_params(
        params, 2, None if bounds is None else j(bounds), len(x))
    tprior = continuous_prior_from_numpy(continuous_prior_to_numpy(jprior), "cpu")
    xq = np.random.default_rng(5).uniform(-1.3, 1.3, (1000, 2)).astype(np.float32)
    want = np.asarray(jprior.pdf(j(xq)))
    close(tprior.pdf(t(xq)).numpy(), want, 1e-5, rel=True)
    monkeypatch.setattr(twk, "PDF_ROWS", 97)
    close(tprior.pdf(t(xq)).numpy(), want, 1e-5, rel=True)
    if bounded:
        assert (want[np.any(np.abs(xq) > 1, 1)] == 0).all()


def test_wkde_sample_matches_jax_by_distribution():
    x, w = _pool()
    params = _jax_fit(x, w, len(x))
    bounds = np.array([[-1.0, -1.0], [1.0, 1.0]], np.float32)
    jprior = jwk.WeightedKernelDensityEstimation.from_params(params, 2, j(bounds), 600)
    tprior = continuous_prior_from_numpy(continuous_prior_to_numpy(jprior), "cpu")
    got = tprior.sample(KeyRing(0, device="cpu").next(), 20000).numpy()
    want = np.asarray(jprior.sample(jax.random.key(1), 20000))
    assert ((got >= -1) & (got <= 1)).all()
    # two samples of 20000 from one mixture: means within 0.02, covariances
    # within 0.01 (standard errors below 0.005)
    assert np.abs(got.mean(0) - want.mean(0)).max() < 0.02
    assert np.abs(np.cov(got.T) - np.cov(want.T)).max() < 0.01
    # components by weight: the zero-weight ones are never drawn
    params0 = dict(tprior._params, weights=torch.tensor([0.0, 1.0] + [0.0] * 598))
    s = twk.wkde_sample(KeyRing(1, device="cpu").next(), params0, None, 500)
    spread = s - params0["x_obs"][1]
    assert float(spread.mean(0).abs().max()) < 0.1


def test_update_continuous_prior_matches_jax():
    x, w = _pool(n_pos=4)
    bounds = np.array([[-1.0, -1.0], [1.0, 1.0]], np.float32)
    jprior = jc.Uniform(j(bounds))
    tprior = tc.Uniform(bounds, device="cpu")
    want = jpu.update_continuous_prior(j(x), j(w), jprior, 2, key=jax.random.key(0))
    got = tpu.update_continuous_prior(t(x), t(w), tprior, 2,
                                      gen=KeyRing(0, device="cpu").next())
    assert isinstance(got, twk.WeightedKernelDensityEstimation)
    assert torch.equal(got.bounds, tprior.bounds) and got.n_kde == want.n_kde
    close(got.covariance.numpy(), np.asarray(want.covariance), 1e-5, rel=True)


# ----------------------------------------------------------------------------
# the synthetic tasks (1e-6, relative)
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name,d,lo,hi", [("branin_product", 2, -2, 3),
                                          ("shekel", 4, 0, 10),
                                          ("hartmann6", 6, 0, 1),
                                          ("ackley", 5, -1, 1)])
def test_objectives_match_jax(name, d, lo, hi):
    """Relative 1e-6; Ackley's terms cancel from ~22.7, where a float32 ulp
    is 1.9e-6, so it is held to 4e-6."""
    x = np.random.default_rng(0).uniform(lo, hi, (500, d)).astype(np.float32)
    close(getattr(tsyn, name)(t(x)).numpy(), np.asarray(getattr(jsyn, name)(j(x))),
          4e-6 if name == "ackley" else 1e-6, rel=True)


@pytest.mark.parametrize("name", ["setup_branin", "setup_shekel", "setup_hartmann"])
def test_setups_match_jax(name):
    jp, jf = getattr(jsyn, name)(seed=2)
    tp, tf = getattr(tsyn, name)(seed=2, device="cpu")
    assert np.array_equal(tp.bounds.numpy(), np.asarray(jp.bounds))
    x = tp.sample(None, 64)
    close(x.numpy(), np.asarray(jp.sample(None, 64)), 1e-6)
    close(tf(x).numpy(), np.asarray(jf(j(x.numpy()))), 1e-6, rel=True)


# ----------------------------------------------------------------------------
# the warm start, the posterior mean and the polish
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def branin_gp():
    """A JAX GP on 40 Branin points, bucket-padded, and its port copy."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-2, 3, (40, 2)).astype(np.float32)
    y = np.asarray(jsyn.branin_product(j(x)))
    js = jx.fit_gp_padded(j(x), j(y), bucket=64)
    return js, gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")


def test_raw_params_from_state_matches_jax(branin_gp):
    js, ts = branin_gp
    want = jx.raw_params_from_state(js)
    got = tx.raw_params_from_state(ts)
    for k in ("raw_lengthscale", "raw_outputscale", "raw_noise"):
        close(getattr(got, k).numpy(), np.asarray(getattr(want, k)), 1e-5, rel=True)
    # the round trip gives the state's hypers back
    kernel, noise = tx.materialize(got, ts.config)
    close(kernel.params["lengthscale"].numpy(), ts.kernel.params["lengthscale"].numpy(),
          1e-5, rel=True)
    close(noise.numpy(), ts.noise.numpy(), 1e-5, rel=True)


def test_posterior_mean_matches_predict(branin_gp):
    js, ts = branin_gp
    xq = np.random.default_rng(4).uniform(-2, 3, (100, 2)).astype(np.float32)
    want = np.asarray(jx.predict(js, j(xq))[0])
    close(tx.posterior_mean(ts, t(xq)).numpy(), want, 1e-5, rel=True)


def test_polish_matches_jax(branin_gp):
    """50 Adam steps from the same 8 starts: points and means to 1e-4."""
    js, ts = branin_gp
    starts = np.random.default_rng(6).uniform(-2, 3, (8, 2)).astype(np.float32)
    lo, hi = np.array([-2.0, -2.0], np.float32), np.array([3.0, 3.0], np.float32)
    jxp, jmu = jx.polish_posterior_mean(js, j(starts), j(lo), j(hi))
    txp, tmu = tx.polish_posterior_mean(ts, t(starts), t(lo), t(hi))
    close(txp.numpy(), np.asarray(jxp), 1e-4, rel=True)
    close(tmu.numpy(), np.asarray(jmu), 1e-4, rel=True)
    assert ((txp >= t(lo)) & (txp <= t(hi))).all()


@pytest.mark.parametrize("ard", [False, True])
def test_rbf_gram_function_gradient_matches_autograd(ard):
    """The autograd Function's backward (the card's route for gradients in
    x and y), run on the CPU from a reference Gram, against autograd
    through the reference: relative 1e-5."""
    rng = np.random.default_rng(7)
    x, y = t(rng.uniform(-1, 1, (8, 4))), t(rng.uniform(-1, 1, (50, 4)))
    ls = t(rng.uniform(0.5, 1.5, 4)) if ard else t(0.7)
    params = {"lengthscale": ls, "outputscale": t(1.3)}
    g = t(rng.normal(size=(8, 50)))
    got = rbf_gram_backward(g, x, y, ls, rbf_gram_reference(params, x, y))
    a, b = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
    torch.sum(rbf_gram_reference(params, a, b) * g).backward()
    for got, want in zip(got, (a.grad, b.grad)):
        close(got.numpy(), want.numpy(), 1e-5, rel=True)
