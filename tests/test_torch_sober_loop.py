"""The port's continuous Sober loop against the JAX package's on the CPU:
the candidate pipeline of each proposal family (Uniform, WKDE, Gaussian)
on its healthy, degenerate and totally degenerate branches, next_batch,
the proposal reset, step with its warm start, the exploit polish, and the
quick-start Branin gate (slow). Both packages start from one carried GP
state and proposal. Their random streams differ, so pools and batches are
compared by distribution and by the invariants every batch must keep."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu import Sober as JaxSober
from sober_tpu.core import fused_sampling as jfs
from sober_tpu.gp import exact as jx
from sober_tpu.priors import continuous as jc
from sober_tpu.priors.wkde import WeightedKernelDensityEstimation as JaxWKDE
from sober_tpu_torch import Sober
from sober_tpu_torch.core import fused_sampling as fs
from sober_tpu_torch.core import rchq as tr
from sober_tpu_torch.core.sampler import EmpiricalSampler
from sober_tpu_torch.core.pi import lfi, normal_cdf
from sober_tpu_torch.gp import exact as tx
from sober_tpu_torch.interop import (continuous_prior_from_numpy,
                                     continuous_prior_to_numpy,
                                     dataset_prior_from_numpy,
                                     gp_state_from_numpy, gp_state_to_numpy)
from sober_tpu_torch.priors import Gaussian, Uniform, WeightedKernelDensityEstimation
from sober_tpu_torch.tasks.synthetic import branin_product, setup_branin
from sober_tpu_torch.utils.linalg import symmetrize
from sober_tpu_torch.utils.prng import KeyRing

N_REC, N_NYS, BATCH = 2048, 64, 8
BOX = np.array([[-1.0, -1.0], [1.0, 1.0]], np.float32)
COV = 0.3 * np.array([[0.5, 0.1], [0.1, 0.4]], np.float32)


def _objective(x):
    """A bump at (0.2, 0.2): pi decays away from it, so the pools' weighted
    moments are stable estimates."""
    return np.exp(-np.sum((x - 0.2) ** 2, axis=1) / 0.18).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """A JAX GP on 40 points of [-1, 1]^2 and its copy in the port."""
    x = np.random.default_rng(0).uniform(-1, 1, (40, 2)).astype(np.float32)
    js = jx.fit_gp(jnp.asarray(x), jnp.asarray(_objective(x)))
    return js, gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")


def _jax_uniform():
    return jc.Uniform(jnp.asarray(BOX), seed=3)


def _port(jprior):
    return continuous_prior_from_numpy(continuous_prior_to_numpy(jprior), "cpu")


def _stats(x, w):
    """Weighted mean and covariance of a pool."""
    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    mean = w @ x
    r = x - mean
    return mean, (r.T * w) @ r


def _check_pool(x, x_nys, w, bounds):
    x, x_nys, w = (np.asarray(a) for a in (x, x_nys, w))
    assert x.shape == (N_REC, 2) and x_nys.shape == (N_NYS, 2)
    assert np.isfinite(x).all() and np.isfinite(x_nys).all()
    assert (w >= 0).all() and abs(w.sum() - 1.0) < 1e-4
    if bounds is not None:
        assert ((x >= bounds[0]) & (x <= bounds[1])).all()


# the pools' weighted moments are importance-sampling estimates of the same
# measure from about 2000 draws: they agree to 0.1 (the JAX package's own
# bar between its fused and staged pools, tests/test_fused_sampling.py)
MOMENT_TOL = 0.1


def _same_distribution(port, jax_out):
    (m1, c1), (m2, c2) = _stats(port.x, port.w), _stats(jax_out[0], jax_out[2])
    assert np.abs(m1 - m2).max() < MOMENT_TOL
    assert np.abs(c1 - c2).max() < MOMENT_TOL


def _candidates(pi, prior, seed):
    """The port's continuous pipeline from `prior` (EmpiricalSampler.
    sampling_candidates, thresh 5, n_kde = N_REC): the pool, whether the
    proposal moved on to a refit WKDE, the proposal after, and the host
    reads."""
    s = EmpiricalSampler(prior, pi, None, label="continuous", seed=seed)
    x, x_nys, w = s.sampling_candidates(N_REC, N_NYS)
    return SimpleNamespace(x=x, x_nys=x_nys, w=w, prior=s.prior,
                           moved=s.prior is not prior, reads=s.last_reads)


def _jax_keys(seed=0):
    return [jax.random.key(seed + i) for i in range(4)]


# ----------------------------------------------------------------------------
# the candidate pipelines: the healthy branch of each family
# ----------------------------------------------------------------------------

def _pi(js, ts):
    eta = jx.posterior_max_mean(js)
    return (js, eta), lambda x: lfi(ts, torch.tensor(float(eta)), x)


def test_uniform_pipeline_matches_jax(carried):
    js, ts = carried
    jpi, tpi = _pi(js, ts)
    jprior = _jax_uniform()
    want = jfs.fused_candidates_cont_uniform(
        jpi, jprior.bounds, jprior._sobol, 0, *_jax_keys(), n_rec=N_REC,
        n_nys=N_NYS, thresh=5, n_kde=N_REC, qmc=True)
    tprior = _port(jprior)
    got = _candidates(tpi, tprior, 0)
    assert tprior._offset == N_REC                 # the one Sobol draw
    assert got.moved == bool(want[4]) is True
    _check_pool(got.x, got.x_nys, got.w, BOX)
    _same_distribution(got, want)
    assert got.reads == 2                          # the branch, one refill count
    bw, jbw = float(got.prior.bw), float(want[3]["bw"])
    assert abs(bw - jbw) < 0.2 * jbw


def test_wkde_pipeline_matches_jax(carried):
    """From one carried WKDE: the refit replaces it on both sides."""
    js, ts = carried
    jpi, tpi = _pi(js, ts)
    jprior = _jax_uniform()
    params = jfs.fused_candidates_cont_uniform(
        jpi, jprior.bounds, jprior._sobol, 0, *_jax_keys(), n_rec=N_REC,
        n_nys=N_NYS, thresh=5, n_kde=N_REC, qmc=True)[3]
    jwkde = JaxWKDE.from_params(params, 2, jprior.bounds, N_REC)
    want = jfs.fused_candidates_cont_wkde(
        jpi, params, jprior.bounds, *_jax_keys(7), n_rec=N_REC, n_nys=N_NYS,
        thresh=5, n_kde=N_REC)
    got = _candidates(tpi, _port(jwkde), 7)
    assert got.moved
    _check_pool(got.x, got.x_nys, got.w, BOX)
    _same_distribution(got, want)


def test_gaussian_pipeline_matches_jax(carried):
    """A Gaussian proposal moves on to a WKDE without bounds."""
    js, ts = carried
    jpi, tpi = _pi(js, ts)
    jprior = jc.Gaussian(jnp.zeros(2), jnp.asarray(COV))
    want = jfs.fused_candidates_cont_gauss(
        jpi, jprior.mu, jprior.chol, *_jax_keys(), n_rec=N_REC, n_nys=N_NYS,
        thresh=5, n_kde=N_REC)
    got = _candidates(tpi, _port(jprior), 0)
    assert got.moved == bool(want[4]) is True
    _check_pool(got.x, got.x_nys, got.w, None)
    _same_distribution(got, want)


def test_pi_keeps_the_lower_tail():
    """Phi down to z = -13 agrees with jax.scipy.stats.norm.cdf to 1e-5
    relative wherever that is a normal float: a float32 Phi that underflows
    below z ~ -5.5 (torch.special.ndtr does) zeroes most of a wide pool's
    weights and starves the proposal refit."""
    z = np.linspace(-13, 4, 3001).astype(np.float32)
    want = np.asarray(jax.scipy.stats.norm.cdf(jnp.asarray(z)))
    got = normal_cdf(torch.as_tensor(z)).numpy()
    normal = want > 1e-30
    assert normal[z < -8].any()
    np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5)


# ----------------------------------------------------------------------------
# the degenerate branches
# ----------------------------------------------------------------------------

CORNER = np.array([[0.95, 0.95], [1.0, 1.0]], np.float32)   # 1/1600 of the box


def _corner_pi(tree, x):
    """pi = 1 in a corner of the box, 0 elsewhere: about 1.3 of a pool of
    2048 is accepted per draw."""
    lo, hi = tree
    return jnp.all((x > lo) & (x < hi), axis=1).astype(jnp.float32)


def test_degenerate_branch_matches_jax():
    """The first draw has under 5 distinct weights: the Uniform is refilled
    (pseudo-random draws), the WKDE fit on the few accepted rows, and its
    pool refilled; both packages end with a WKDE inside the corner's
    neighbourhood."""
    jprior = _jax_uniform()
    tree = (jnp.asarray(CORNER[0]), jnp.asarray(CORNER[1]))
    want = jfs.fused_candidates_cont_uniform(
        tree, jprior.bounds, jprior._sobol, 0, *_jax_keys(), n_rec=N_REC,
        n_nys=N_NYS, thresh=5, n_kde=N_REC, qmc=True, pi_apply=_corner_pi)
    lo, hi = torch.as_tensor(CORNER[0]), torch.as_tensor(CORNER[1])
    tpi = lambda x: torch.all((x > lo) & (x < hi), dim=1).to(torch.float32)
    tprior = _port(jprior)
    first = tpi(torch.as_tensor(np.asarray(_jax_uniform().sample(None, N_REC))))
    assert 0 < int(first.sum()) < 4                # the branch is degenerate
    got = _candidates(tpi, tprior, 0)
    assert got.moved == bool(want[4]) is True
    assert got.reads > 2                           # refill rounds were read
    _check_pool(got.x, got.x_nys, got.w, BOX)
    for x, w in ((got.x, got.w), (want[0], want[2])):
        mean, _ = _stats(x, w)
        assert (mean > 0.9).all()


def test_total_degeneracy_matches_jax(carried):
    """pi is 0 everywhere (an unreachable incumbent). The cleansed weights
    of an all-zero draw are uniform (cleansing_weights), so the first draw
    is degenerate (one distinct weight), the refill stops at once, and the
    WKDE is fit on the uniform-weight pool's first n_kde rows: in both
    packages the proposal moves on and the pool spreads over the box. The
    branch that keeps the proposal needs a pool with no positive weight,
    which cleansed weights never are; `refill` is held to it directly."""
    js, ts = carried
    jprior = _jax_uniform()
    want = jfs.fused_candidates_cont_uniform(
        (js, jnp.float32(1e9)), jprior.bounds, jprior._sobol, 0, *_jax_keys(),
        n_rec=N_REC, n_nys=N_NYS, thresh=5, n_kde=N_REC, qmc=True)
    got = _candidates(lambda x: lfi(ts, torch.tensor(1e9), x),
                                   _port(jprior), 0)
    assert got.moved == bool(want[4]) is True
    assert torch.allclose(got.w, torch.full((N_REC,), 1.0 / N_REC))
    assert got.reads == 3                          # the branch, two counts
    _check_pool(got.x, got.x_nys, got.w, BOX)
    _same_distribution(got, want)
    x0 = torch.zeros((N_REC, 2))
    draw = lambda: (x0 + 1.0, torch.zeros(N_REC))
    x, w, none, reads = fs.refill(draw, x0, torch.zeros(N_REC), 5, 5)
    assert none and reads == 5 and torch.equal(x, x0)
    assert torch.allclose(w, torch.full((N_REC,), 1.0 / N_REC))


def test_staged_pieces(carried):
    """sampling, recursive_sampling, update_prior and _select_nys: the
    pieces next_batch's pipeline is built from."""
    _, ts = carried
    sober = Sober(Uniform(BOX, seed=3, device="cpu"), ts, seed=2)
    x, w = sober.sampling(512)
    assert x.shape == (512, 2) and abs(float(w.sum()) - 1.0) < 1e-5
    offset = sober.prior._offset
    x, w = sober.recursive_sampling(512)
    assert not sober.flag and int((w > 0).sum()) > sober.thresh
    assert sober.prior._offset == offset       # redraws are pseudo-random
    sober.update_prior(x, w)
    assert isinstance(sober.prior, WeightedKernelDensityEstimation)
    assert torch.equal(sober.prior.bounds, torch.as_tensor(BOX))
    assert sober._select_nys(x, w, 16).shape == (16, 2)
    # all-zero pi: the cleansed weights are uniform, all accepted
    sober.pi = lambda x: torch.zeros(x.shape[0])
    x, w = sober.recursive_sampling(512)
    assert not sober.flag and torch.allclose(w, torch.full((512,), 1 / 512))


# ----------------------------------------------------------------------------
# next_batch
# ----------------------------------------------------------------------------

def _moment_error(kernel, x_cand, x_nys, w_pool, idx, w):
    k_nys = symmetrize(torch.nan_to_num(kernel(x_nys, x_nys)))
    u = tr.nystrom_basis(k_nys, BATCH - 1)
    phi = u @ kernel(x_nys, x_cand)
    phi = phi / phi.abs().max()
    return float((phi[:, idx] @ w - phi @ (w_pool / w_pool.sum())).abs().max())


def _check_batch(w, xb, bounds):
    w, xb = np.asarray(w), np.asarray(xb)
    assert xb.shape == (BATCH, 2) and np.isfinite(xb).all()
    assert (w >= 0).all() and abs(w.sum() - 1.0) < 1e-4
    if bounds is not None:             # a WKDE clips onto the closed box
        assert ((xb >= bounds[0]) & (xb <= bounds[1])).all()


@pytest.mark.parametrize("family", ["uniform", "gaussian"])
def test_next_batch_matches_jax(carried, family):
    """Two next_batch calls from one carried GP and proposal: valid
    batches, the proposal moved on to a WKDE (bounded as the domain), and
    batch means that agree by distribution (8 points a batch, so to 0.5)."""
    js, ts = carried
    jprior = (_jax_uniform() if family == "uniform"
              else jc.Gaussian(jnp.zeros(2), jnp.asarray(COV)))
    bounds = BOX if family == "uniform" else None
    jsober, sober = JaxSober(jprior, js, seed=1), Sober(_port(jprior), ts, seed=1)
    for _ in range(2):
        jw, jxb = jsober.next_batch(N_REC, N_NYS, BATCH, return_weights=True)
        w, xb = sober.next_batch(N_REC, N_NYS, BATCH, return_weights=True)
        _check_batch(jw, jxb, bounds)
        _check_batch(w, xb, bounds)
        assert np.abs(np.asarray(w) @ np.asarray(xb)
                      - np.asarray(jw) @ np.asarray(jxb)).max() < 0.5
    assert isinstance(sober.prior, WeightedKernelDensityEstimation)
    assert isinstance(jsober.prior, JaxWKDE)
    assert (sober.prior.bounds is None) == (jsober.prior.bounds is None)
    assert sober.last_path == "fused" and int(sober.last_npos) > 0
    assert set(sober.last_timings) == {"candidates", "recombination", "total"}
    xb = sober.next_batch(N_REC, N_NYS, BATCH)
    assert isinstance(xb, torch.Tensor) and xb.shape == (BATCH, 2)


def test_next_batch_moment_error(carried):
    """The batch matches the pool's moments on the Nystrom features below
    5e-3 (tests/test_rchq.py's bound), from the pipeline's own pool."""
    _, ts = carried
    sober = Sober(Uniform(BOX, seed=3, device="cpu"), ts, seed=5)
    x, x_nys, w = sober.sampling_candidates(N_REC, N_NYS)
    idx, wr = sober.sampling_recombination(x, x_nys, w, BATCH)
    assert _moment_error(sober.kernel, x, x_nys, w, idx, wr) < 5e-3
    with pytest.raises(ValueError):
        sober.sampling_candidates(N_NYS, N_NYS)


# ----------------------------------------------------------------------------
# the proposal reset
# ----------------------------------------------------------------------------

def test_should_reset_prior_matches_jax_on_continuous_histories(carried):
    js, ts = carried
    jsober = JaxSober(_jax_uniform(), js)
    sober = Sober(_port(_jax_uniform()), ts)
    rng = np.random.default_rng(3)
    for n_extra in (0, 8, 16, 24, 40, 64):
        for recycle in (True, False):
            hist = rng.normal(size=40 + n_extra)
            if n_extra >= 24:                      # an early best: stagnation
                hist[41] = 10.0
            assert sober.should_reset_prior(8, recycle, targets=hist) == \
                jsober.should_reset_prior(8, recycle, targets=hist)
    assert sober.should_reset_prior(8, False) == jsober.should_reset_prior(8, False)


def test_mark_reset_restores_a_fresh_uniform(carried):
    """After the proposal became a WKDE, a reset brings back a Uniform over
    the original box whose Sobol sequence starts again at offset 0: the
    same points as JAX's fresh Uniform(bounds)."""
    js, ts = carried
    jsober = JaxSober(_jax_uniform(), js, seed=1)
    sober = Sober(_port(_jax_uniform()), ts, seed=1)
    for s in (sober, jsober):
        s.next_batch(N_REC, N_NYS, BATCH)
        assert not s.last_reset and s.reset_count == 0
        s._mark_reset()
        assert s.last_reset and s.reset_count == 1
    assert isinstance(sober.prior, Uniform) and sober.prior._offset == 0
    assert torch.equal(sober.prior.bounds, torch.as_tensor(BOX))
    got = sober.prior.sample(None, 256).numpy()
    want = np.asarray(jsober.prior.sample(None, 256))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_reset_restores_the_gaussian(carried):
    _, ts = carried
    prior0 = Gaussian(np.zeros(2), COV, device="cpu")
    sober = Sober(prior0, ts, seed=4)
    sober.next_batch(1024, 48, BATCH)
    assert isinstance(sober.prior, WeightedKernelDensityEstimation)
    sober.initialise_prior()
    assert sober.prior is prior0


def test_next_batch_resets_without_recycling():
    """recycle_prior=False resets the proposal at every call once the model
    holds new observations; the reset count grows as JAX's does."""
    rng = np.random.default_rng(4)
    x0 = rng.uniform(-1, 1, (30, 2)).astype(np.float32)
    y0 = _objective(x0)
    js = jx.fit_gp(jnp.asarray(x0), jnp.asarray(y0))
    jsober = JaxSober(_jax_uniform(), js, seed=2)
    sober = Sober(_port(_jax_uniform()), gp_state_from_numpy(
        gp_state_to_numpy(js), device="cpu"), seed=2)
    x1 = np.concatenate([x0, rng.uniform(-1, 1, (12, 2)).astype(np.float32)])
    js1 = jx.fit_gp(jnp.asarray(x1), jnp.asarray(_objective(x1)))
    jsober.update_model(js1)
    sober.update_model(gp_state_from_numpy(gp_state_to_numpy(js1), device="cpu"))
    for _ in range(2):
        sober.next_batch(1024, 32, BATCH, recycle_prior=False)
        jsober.next_batch(1024, 32, BATCH, recycle_prior=False)
        assert sober.last_reset and jsober.last_reset
    assert sober.reset_count == jsober.reset_count == 2


# ----------------------------------------------------------------------------
# step, the warm start and the polish
# ----------------------------------------------------------------------------

def test_step_with_warm_start(carried):
    _, ts = carried
    rng = np.random.default_rng(11)
    x0 = rng.uniform(-1, 1, (30, 2)).astype(np.float32)
    y0 = _objective(x0)
    sober = Sober(Uniform(BOX, device="cpu"), ts, seed=23)
    p0 = sober._warm_start_params(tx.GPConfig(), 2)
    want = tx.raw_params_from_state(ts)
    assert all(torch.equal(a, b) for a, b in zip(tx.param_tensors(p0),
                                                 tx.param_tensors(want)))
    assert sober._warm_start_params(tx.GPConfig(ard=True), 2) is None
    xb = sober.step(x0, y0, 1024, 32, BATCH, warm_start=True)
    assert xb.shape == (BATCH, 2) and bool(torch.isfinite(xb).all())
    assert int(sober.pi.model.mask.sum()) == 30 and sober.pi.model.x.shape[0] == 128
    assert isinstance(sober.prior, WeightedKernelDensityEstimation)
    x1 = np.concatenate([x0, xb.numpy()])
    w, xb2 = sober.step(x1, _objective(x1), 1024, 32, BATCH, warm_start=True,
                        return_weights=True)
    _check_batch(w, xb2, BOX)
    assert int(sober.pi.model.mask.sum()) == 38
    sober.fbgp = True
    with pytest.raises(TypeError):
        sober.step(x1, _objective(x1), 1024, 32, BATCH)


def test_step_on_a_dataset():
    rng = np.random.default_rng(5)
    feats = rng.integers(0, 2, (250, 16)).astype(np.float32)
    targets = rng.normal(size=250).astype(np.float32)
    obs = rng.permutation(250)[:24]
    prior = dataset_prior_from_numpy(feats, targets, device="cpu")
    state = tx.fit_gp(torch.as_tensor(feats[obs]), torch.as_tensor(targets[obs]))
    sober = Sober(prior, state, seed=4)
    idx, xb = sober.step(feats[obs], targets[obs], 128, 48, BATCH)
    assert xb.shape == (BATCH, 16) and torch.equal(xb, prior.features[idx])
    assert len(set(idx.tolist())) == BATCH


def test_exploit_polish_matches_jax(carried):
    """The polish of one batch from one state: the replaced point to 1e-4
    of JAX's, inside the box; a batch from next_batch(polish=True) keeps
    its other points and is valid."""
    js, ts = carried
    xb = np.random.default_rng(8).uniform(-1, 1, (BATCH, 2)).astype(np.float32)
    jsober = JaxSober(_jax_uniform(), js)
    sober = Sober(_port(_jax_uniform()), ts)
    want = np.asarray(jsober._exploit_polish(jnp.asarray(xb)))
    got = sober._exploit_polish(torch.as_tensor(xb)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.array_equal(got[:-1], xb[:-1]) and (np.abs(got[-1]) <= 1).all()
    xb = sober.next_batch(N_REC, N_NYS, BATCH, polish=True)
    assert "polish" in sober.last_timings
    assert bool(torch.isfinite(xb).all()) and bool((xb.abs() <= 1).all())
    mu = tx.posterior_mean(ts, xb)
    assert float(mu[-1]) >= float(tx.posterior_mean(ts, ts.x).max()) - 1e-4
    # not on a quadrature batch, nor without bounds
    assert not sober._polish_eligible(True, None, True)
    gsober = Sober(Gaussian(np.zeros(2), COV, device="cpu"), ts)
    gsober.next_batch(1024, 32, BATCH)
    assert not gsober._polish_eligible(True, None, False)


# ----------------------------------------------------------------------------
# the quick-start gate (tests/test_acceptance.py), slow
# ----------------------------------------------------------------------------

TARGET = 10.59       # truth 10.6043


def run_quickstart(seed: int, device="cpu", max_batches: int = 8):
    """tests/test_acceptance.py:_run_quickstart on the port: 10 Sobol
    points, then up to 8 batches of next_batch(20000, 500, 30)."""
    prior, objective = setup_branin(seed=seed, device=device)
    x = prior.sample(KeyRing(seed, device=device).next(), 10)
    y = objective(x)
    sober = Sober(prior, tx.fit_gp_padded(x, y), seed=seed)
    best = float(y.max())
    for _ in range(max_batches):
        sober.update_model(tx.fit_gp_padded(x, y))
        xb = sober.next_batch(20000, 500, 30)
        yb = objective(xb)
        x, y = torch.cat([x, xb]), torch.cat([y, yb])
        best = max(best, float(yb.max()))
        if best >= TARGET:
            break
    return best


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_branin_gate(seed):
    assert run_quickstart(seed) >= TARGET
    assert abs(float(branin_product(torch.tensor([[-1.0254, -1.0254]]))) - 10.6043) < 1e-3
