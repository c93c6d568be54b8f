"""The port's simulation-based-inference path against the JAX package's on
the CPU: the TruncatedGaussian proposal in the candidate pipeline, Sober on
the ECM prior, the ECM simulator, BOLFI's parabolic-mean GP, SOBERUCB and
the LCB polish, SoberWrapper (transforms, diagonalization, run_SOBER,
run_BASQ, run_SOBER_adaptively, checkpoints), and expectation propagation.

Deterministic stages are held tightly on the same numpy inputs (the
ECM simulator on JAX's observed spectrum, carried by interop); random
stages by distribution and by the properties tests/test_apps.py asserts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sober_tpu import Sober as JaxSober
from sober_tpu.apps import SOBERUCB as JaxUCB
from sober_tpu.apps import SoberWrapper as JaxWrapper
from sober_tpu.apps import make_bolfi_model as jax_bolfi
from sober_tpu.gp import exact as jx
from sober_tpu.priors.continuous import TruncatedGaussian as JaxTG
from sober_tpu.priors.wkde import WeightedKernelDensityEstimation as JaxWKDE
from sober_tpu.tasks.ecm import CanonicalECMTwoRCs as JaxECM
from sober_tpu.tasks.ecm import setup_ecm_two as jax_setup_ecm
from sober_tpu.utils import checkpoint as jck
from sober_tpu_torch import Sober
from sober_tpu_torch.apps import (SOBERUCB, BoTorchLCBSC, ExpectationPropagation,
                                  SoberWrapper, make_bolfi_model)
from sober_tpu_torch.apps.bolfi import bolfi_config
from sober_tpu_torch.core import rchq as tr
from sober_tpu_torch.gp import exact as tx
from sober_tpu_torch.gp.exact import fit_gp_padded
from sober_tpu_torch.interop import (ecm_from_numpy, ecm_to_numpy,
                                     gp_params_from_numpy, gp_state_from_numpy,
                                     gp_state_to_numpy, truncated_gaussian_from_numpy,
                                     truncated_gaussian_to_numpy)
from sober_tpu_torch.priors import WeightedKernelDensityEstimation
from sober_tpu_torch.tasks import setup_ecm_two
from sober_tpu_torch.utils import checkpoint as tck
from sober_tpu_torch.utils.linalg import symmetrize

UNIT = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
# tests/test_fused_sampling.py:841-856's two priors on the unit box
REGIMES = {"rejection": ([0.5, 0.5], 0.3 * np.eye(2)),
           "gibbs": ([3.0, 3.0], 0.25 * np.eye(2))}
N_REC, N_NYS, BATCH = 1024, 48, 8


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def carried():
    """A JAX GP on 40 points of the unit box (a bump at (0.3, 0.3)) and its
    copy in the port."""
    x = np.random.default_rng(10).uniform(0, 1, (40, 2)).astype(np.float32)
    y = np.exp(-np.sum((x - 0.3) ** 2, axis=1) / 0.1).astype(np.float32)
    js = jx.fit_gp(jnp.asarray(x), jnp.asarray(y))
    return js, gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")


def _jax_tg(regime):
    mu, cov = REGIMES[regime]
    return JaxTG(jnp.asarray(mu, jnp.float32), jnp.asarray(cov, jnp.float32),
                 jnp.asarray(UNIT))


def _stats(x, w):
    x, w = np.asarray(x, np.float64), np.asarray(w, np.float64)
    mean = w @ x
    r = x - mean
    return mean, (r.T * w) @ r


def _moment_error(kernel, x_cand, x_nys, w_pool, idx, w, batch):
    k_nys = symmetrize(torch.nan_to_num(kernel(x_nys, x_nys)))
    u = tr.nystrom_basis(k_nys, batch - 1)
    phi = u @ kernel(x_nys, x_cand)
    phi = phi / phi.abs().max()
    return float((phi[:, idx] @ w - phi @ (w_pool / w_pool.sum())).abs().max())


# -- the TruncatedGaussian proposal -----------------------------------------------

@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_pipeline_matches_jax(carried, regime):
    """The candidate pipeline from a TruncatedGaussian carried across, in
    the rejection and the Gibbs regime: legal pools inside the unit box,
    weighted moments within 0.1 of JAX's fused pipeline (its own bar
    between fused and staged pools), and the proposal refit as a WKDE
    bounded by the box on both sides."""
    js, ts = carried
    jprior = _jax_tg(regime)
    prior = truncated_gaussian_from_numpy(truncated_gaussian_to_numpy(jprior), device="cpu")
    assert prior._use_gibbs == (regime == "gibbs")
    jsober, sober = JaxSober(jprior, js, seed=37), Sober(prior, ts, seed=37)
    xj, _, wj = jsober.sampling_candidates(N_REC, N_NYS)
    x, x_nys, w = sober.sampling_candidates(N_REC, N_NYS)
    assert x.shape == (N_REC, 2) and x_nys.shape == (N_NYS, 2)
    assert torch.isfinite(x).all() and (w >= 0).all() and abs(float(w.sum()) - 1) < 1e-4
    assert ((x >= 0) & (x <= 1)).all()
    (m1, c1), (m2, c2) = _stats(x, w), _stats(xj, wj)
    assert np.abs(m1 - m2).max() < 0.1 and np.abs(c1 - c2).max() < 0.1
    assert isinstance(sober.prior, WeightedKernelDensityEstimation)
    assert isinstance(jsober.prior, JaxWKDE)
    np.testing.assert_array_equal(sober.prior.bounds.numpy(), UNIT)


def test_next_batch_on_the_ecm_prior():
    """Sober on tutorial 05's truncated-Gaussian prior at a small size: a
    batch inside the prior's box with legal weights, then, from the refit
    model and the learned proposal, the batch's moment error on the
    Nystrom features below 5e-3."""
    prior, sim = setup_ecm_two(device="cpu")
    x = prior.sample(_gen(0), 40)
    d, _ = sim(x)
    sober = Sober(prior, fit_gp_padded(x, d, bucket=64), seed=3)
    lo, hi = prior.bounds
    w, xb = sober.next_batch(2048, 64, BATCH, return_weights=True)
    assert xb.shape == (BATCH, 5) and torch.isfinite(xb).all()
    assert ((xb >= lo) & (xb <= hi)).all()
    assert (w >= 0).all() and abs(float(w.sum()) - 1) < 1e-4
    x, d = torch.cat([x, xb]), torch.cat([d, sim(xb)[0]])
    sober.update_model(fit_gp_padded(x, d, bucket=64))
    x_cand, x_nys, w_pool = sober.sampling_candidates(2048, 64)
    idx, wr = sober.sampling_recombination(x_cand, x_nys, w_pool, BATCH)
    assert ((x_cand >= lo) & (x_cand <= hi)).all()
    assert _moment_error(sober.kernel, x_cand, x_nys, w_pool, idx, wr, BATCH) < 5e-3


# -- the ECM task ----------------------------------------------------------------

def test_ecm_simulator_matches_jax():
    """The simulator on JAX's observed spectrum: discrepancy and
    log-likelihood of 64 parameter rows, and the circuit elements, within
    1e-5 relative; the port's own setup: the same frequencies' statistics
    (std with ddof 0), the prior's Genz constant and density within 1e-5,
    and its own noise at the model's level."""
    omega = (2 * np.pi * np.logspace(1, 10, 100)).astype(np.float32)
    jsim = JaxECM(2.0, -0.5, -1.0, 0.0, 0.5, sigma=1.0, omega=jnp.asarray(omega), seed=0)
    tsim = ecm_from_numpy(ecm_to_numpy(jsim), device="cpu")
    assert abs(float(tsim.sigma) - float(jsim.sigma)) <= 1e-6 * float(jsim.sigma)
    lo, hi = np.array([1.0, -2, -2, -2, -2]), np.array([3.0, 2, 2, 2, 2])
    theta = np.random.default_rng(0).uniform(lo, hi, (64, 5)).astype(np.float32)
    for got, want in zip(tsim(torch.as_tensor(theta)), jsim(jnp.asarray(theta))):
        want = np.asarray(want)
        assert np.all(np.abs(got.numpy() - want) <= 1e-5 * np.abs(want))
    for got, want in zip(tsim.convert_circuit_elements(theta[0]),
                         jsim.convert_circuit_elements(jnp.asarray(theta[0]))):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    jprior, _ = jax_setup_ecm()
    prior, sim = setup_ecm_two(device="cpu")
    assert abs(float(prior.constant) - float(jprior.constant)) <= 1e-5 * float(jprior.constant)
    assert prior._use_gibbs == jprior._use_gibbs is False
    want = np.asarray(jprior.pdf(jnp.asarray(theta)))
    assert np.all(np.abs(prior.pdf(torch.as_tensor(theta)).numpy() - want)
                  <= 1e-5 * np.abs(want))
    re, _ = sim._spectrum(sim.theta_true[None, :])
    noise_sd = float((sim.reZ - re[0]).std())
    assert 0.8 < noise_sd / np.sqrt(np.exp(-np.e)) < 1.2


# -- BOLFI -----------------------------------------------------------------------

def _bolfi_data(n=30, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (n, 2)).astype(np.float32)
    y = (10.0 * np.sum((x - 0.5) ** 2, axis=1)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("manual", [False, True])
def test_parabolic_neg_mll_and_grad_match_jax(manual):
    """The BOLFI config (its priors from the host parabola fit) equal to
    JAX's field for field, and neg_mll with its gradient in every
    parameter, the parabolic mean's included, at the same params: 1e-5
    relative (gradients to their largest entry)."""
    x, y = _bolfi_data()
    cfg = bolfi_config(x, y, UNIT, manual_kernel=manual)
    jcfg = jx.GPConfig(**dataclasses.asdict(cfg))
    d = x.shape[1]
    raw = {"raw_lengthscale": np.full(d if manual else (), -0.2, np.float32),
           "raw_outputscale": np.float32(0.4), "raw_noise": np.float32(0.3),
           "mean_params": {"raw_a": np.array([0.7, 1.1], np.float32),
                           "b": np.array([-0.3, 0.2], np.float32),
                           "c": np.float32(0.1)}}
    jp = jx.GPParams(**{k: (jnp.asarray(v) if k != "mean_params" else
                            {m: jnp.asarray(a) for m, a in v.items()})
                        for k, v in raw.items()})
    loss_j, grad_j = jax.value_and_grad(
        lambda p: jx.neg_mll(p, jnp.asarray(x), jnp.asarray(y), jcfg))(jp)
    params = tx.map_params(lambda p: p.requires_grad_(True), gp_params_from_numpy(raw, "cpu"))
    loss_t = tx.neg_mll(params, torch.as_tensor(x), torch.as_tensor(y), cfg)
    loss_t.backward()
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = [grad_j.raw_lengthscale, grad_j.raw_outputscale, grad_j.raw_noise,
            *(grad_j.mean_params[k] for k in sorted(grad_j.mean_params))]
    for p, g in zip(tx.param_tensors(params), want):
        g = np.asarray(g)
        assert np.abs(p.grad.numpy() - g).max() <= 1e-5 * max(np.abs(g).max(), 1e-6)


def test_make_bolfi_model_matches_jax_fit():
    """The port's L-BFGS fit ends at most 1e-3 |loss| above JAX's MAP loss
    (the line searches differ, as in test_torch_gp.py's zero-mean fit),
    better than its start; test_apps.py's properties: predictions follow
    the data (correlation > 0.95) and the parabola lifts the extrapolation
    above the data."""
    x, y = _bolfi_data()
    js = jax_bolfi(jnp.asarray(x), jnp.asarray(y), jnp.asarray(UNIT))
    ts = make_bolfi_model(torch.as_tensor(x), torch.as_tensor(y), UNIT)
    cfg = ts.config
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    jstate = gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")
    loss = lambda s: float(tx.neg_mll(tx.raw_params_from_state(s), xt, yt, cfg))
    assert loss(ts) <= loss(jstate) + 1e-3 * abs(loss(jstate))
    assert loss(ts) < float(tx.neg_mll(tx.init_params(cfg, 2, device="cpu"), xt, yt, cfg))
    mu, _ = tx.predict(ts, xt)
    assert np.corrcoef(mu.numpy(), y)[0, 1] > 0.95
    assert float(tx.predict(ts, torch.tensor([[3.0, 3.0]]))[0][0]) > float(y.max())


def test_manual_kernel_separates_lengthscales():
    """The ARD variant with one Gamma prior a lengthscale: on a target fast
    along dimension 0 and slow along 1, the fitted lengthscales separate
    (test_apps.py's bar), as JAX's do."""
    x = np.random.default_rng(3).uniform(0, 1, (40, 2)).astype(np.float32)
    y = (np.sin(12.0 * x[:, 0]) + 0.05 * x[:, 1]).astype(np.float32)
    ts = make_bolfi_model(torch.as_tensor(x), torch.as_tensor(y), UNIT, manual_kernel=True)
    ls = ts.kernel.params["lengthscale"].numpy()
    assert ls.shape == (2,) and ls[1] > 1.5 * ls[0]
    assert np.corrcoef(tx.predict(ts, torch.as_tensor(x))[0].numpy(), y)[0, 1] > 0.9


@pytest.fixture(scope="module")
def bolfi_state():
    x, y = _bolfi_data(25, seed=2)
    js = jax_bolfi(jnp.asarray(x), jnp.asarray(y), jnp.asarray(UNIT))
    return js, gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")


def test_soberucb_matches_jax(bolfi_state):
    """SOBERUCB on a carried BOLFI state: 1e-5 relative, and never below
    the posterior mean."""
    js, ts = bolfi_state
    xq = np.random.default_rng(5).uniform(0, 1, (64, 2)).astype(np.float32)
    want = np.asarray(JaxUCB(js, sample_size=20)(jnp.asarray(xq)))
    got = SOBERUCB(ts, sample_size=20)(torch.as_tensor(xq)).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want))
    mu, _ = tx.predict(ts, torch.as_tensor(xq), include_noise=False)
    assert (got >= mu.numpy() - 1e-5).all()


def test_lcb_polish_matches_jax(bolfi_state):
    """BoTorchLCBSC's projected Adam polish from the same 8 starts against
    the JAX package's polish loop (optax.adam, the same lcb and clip):
    1e-4; acquire's candidates are inside the box."""
    js, ts = bolfi_state
    x0 = np.random.default_rng(6).uniform(0, 1, (8, 2)).astype(np.float32)
    lcb_t = BoTorchLCBSC(ts, UNIT)
    beta, steps = lcb_t._beta(0), 10
    lo, hi = jnp.asarray(UNIT[0]), jnp.asarray(UNIT[1])

    def lcb(x):
        mu, var = jx.predict(js, x, include_noise=False)
        return mu - jnp.sqrt(beta * var)

    opt = optax.adam(0.05 * float(jnp.max(hi - lo)))
    x, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    for _ in range(steps):
        g = jax.grad(lambda xx: jnp.sum(lcb(xx)))(x)
        updates, state = opt.update(g, state, x)
        x = jnp.clip(optax.apply_updates(x, updates), lo[None, :], hi[None, :])
    got = lcb_t.polish(torch.as_tensor(x0), beta, steps).numpy()
    assert np.abs(got - np.asarray(x)).max() < 1e-4
    cands = lcb_t.acquire(4, t=0, num_restarts=8, polish_steps=10)
    assert cands.shape == (4, 2) and (cands >= 0).all() and (cands <= 1).all()


# -- SoberWrapper ----------------------------------------------------------------

def quad_model(x, **kwargs):
    """A module-level host model (rows or one row)."""
    x = np.atleast_2d(np.asarray(x))
    return (x**2).sum(axis=1)


def _make(**kw):
    defaults = dict(model=quad_model, data=np.zeros(1), model_initial_samples=20,
                    bounds=[[-2.0, -2.0], [2.0, 2.0]], parallelization=False, seed=0,
                    device="cpu")
    defaults.update(kw)
    return SoberWrapper(**defaults)


def test_wrapper_normalization_and_transforms():
    """normalize_input and denormalize_input invert each other (1e-5); a
    log transform moves the bound to log 0.1; the one-variable maps
    round-trip through the unit cube (test_apps.py's, within 1e-3)."""
    w = _make(transforms=[(np.log, np.exp), None],
              bounds=[[0.1, -2.0], [10.0, 2.0]], model_initial_samples=5)
    assert abs(float(w.bounds[0][0]) - np.log(0.1)) < 1e-5
    x = torch.rand((7, 2), generator=_gen(1))
    assert torch.allclose(w.normalize_input(w.denormalize_input(x)), x, atol=1e-5)
    v = SoberWrapper(model=quad_model, data=np.zeros(1), bounds=[[-2.0, 0.0], [3.0, 10.0]],
                     model_initial_samples=4, transforms=[None, (np.log1p, np.expm1)],
                     standalone=False, device="cpu")
    for idx, val in [(0, 1.5), (1, 4.0)]:
        z = v.apply_transform_and_normalize_one_variable(val, idx)
        assert 0.0 <= z <= 1.0
        assert abs(v.denormalize_and_reverse_transform_one_variable(z, idx) - val) < 1e-3


@pytest.mark.parametrize("bounds", [[[-2.0, -2.0], [2.0, 2.0]],
                                    [[-2.0, 0.0, -1.0], [3.0, 10.0, 1.0]]],
                         ids=["equal_widths", "distinct_widths"])
def test_diagonalization_matches_jax(bounds):
    """The chi2-default covariance's eigenbasis, the eigen-order map, the
    truncated-Gaussian prior's normalized mean and its regime, equal to
    JAX's at equal widths (a repeated eigenvalue) and at distinct ones
    (a permutation)."""
    kw = dict(model=quad_model, data=np.zeros(1), bounds=bounds, prior="TruncatedGaussian",
              model_initial_samples=4, standalone=False, parallelization=False)
    jw, tw = JaxWrapper(**kw), SoberWrapper(**kw, device="cpu")
    np.testing.assert_array_equal(tw.diagonalization.numpy(), np.asarray(jw.diagonalization))
    assert tw.diag_order == jw.diag_order
    assert np.abs(tw.prior.mu.numpy() - np.asarray(jw.prior.mu)).max() < 1e-6
    assert tw.prior._use_gibbs == jw.prior._use_gibbs


def test_run_sober_and_results():
    """test_apps.py's run_SOBER: two iterations of 8 model samples, 36 rows
    of results, objectives renormalized."""
    w = _make()
    assert w.X_all.shape == (20, 2) and abs(float(w.Y_all.mean())) < 1e-4
    w.run_SOBER(sober_iterations=2, model_samples_per_iteration=8, surrogate_samples=256,
                surrogate_effective_samples=32, verbose=False)
    assert len(w.results) == 2
    assert len(w.results_to_dict()["parameters evaluations"]) == 36
    assert abs(float(w.Y_all.mean())) < 1e-4


def test_run_basq_returns_tuple(capsys):
    """run_BASQ after a SOBER iteration: posterior samples, a MAP, a finite
    evidence, and the MAP-vs-best table printed."""
    w = _make()
    w.run_SOBER(sober_iterations=1, model_samples_per_iteration=8, surrogate_samples=256,
                surrogate_effective_samples=32, verbose=False)
    samples, map_est, best, elml, _ = w.run_BASQ(
        integration_nodes=16, basq_samples=256, basq_effective_samples=32, verbose=True)
    assert samples.shape == (16, 2) and map_est.shape == (2,) and np.isfinite(elml)
    out = capsys.readouterr().out
    assert "MAP" in out and "best observed" in out


def test_wrapper_bolfi_truncated_gaussian():
    """The SBI configuration: a TruncatedGaussian prior on the unit cube
    and the BOLFI surrogate (parabolic mean, SOBERUCB as calc_obj): the
    batch inside the unit cube, the surrogate parabolic."""
    w = _make(prior="TruncatedGaussian", use_bolfi=True)
    w.run_SOBER(sober_iterations=1, model_samples_per_iteration=8, surrogate_samples=256,
                surrogate_effective_samples=32, verbose=False)
    assert w.surrogate_model.config.mean == "parabolic"
    xb = w.X_all[20:]
    assert xb.shape == (8, 2) and ((xb >= 0) & (xb <= 1)).all()


def test_posterior_diagnostics_surface(capsys):
    """test_apps.py's diagnostics under matplotlib's Agg backend: the
    objective and log-likelihood histograms at initialize_sober, the
    MAP-vs-best table with finite posterior and log-likelihood values, and
    the posterior pairplot (d x d axes) with the eigen-order back-transform
    and the true optimum; visualize_prior and visualize_results draw too."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    w = _make(visualizations=True, true_optimum=[0.0, 0.0])
    assert len(plt.get_fignums()) >= 1
    w.run_SOBER(sober_iterations=1, model_samples_per_iteration=8, surrogate_samples=256,
                surrogate_effective_samples=32, verbose=False, visualizations=True)
    w.run_BASQ(integration_nodes=16, basq_samples=256, basq_effective_samples=32,
               verbose=True, visualizations=True)
    out = capsys.readouterr().out
    assert "MAP" in out and "best observed" in out and "Log-Likelihood" in out
    assert len(plt.figure(plt.get_fignums()[-1]).axes) == w.input_dim ** 2
    w.visualize_prior()
    plt.close("all")


def test_gaussian_prior_and_custom_objective():
    """test_apps.py's Gaussian prior mode (10 draws) and a custom
    (objective, log-likelihood) callable on a 1-d box (one iteration of 4)."""
    w = _make(prior="Gaussian", model_initial_samples=10)
    assert w.X_all.shape == (10, 2) and w.prior.mu.shape == (2,)

    def custom(batch):
        obj = -torch.sum(batch**2, dim=1)
        return obj, obj * 0.5

    c = SoberWrapper(custom_objective_and_loglikelihood=custom, bounds=[[-1.0], [1.0]],
                     model_initial_samples=10, parallelization=False, seed=0, device="cpu")
    c.run_SOBER(sober_iterations=1, model_samples_per_iteration=4, surrogate_samples=128,
                surrogate_effective_samples=16, verbose=False)
    assert len(c.X_all) == 14


def test_run_sober_adaptively_stops():
    w = _make()
    w.run_SOBER_adaptively(stopping_criterion_variance=1e10, maximum_number_of_batches=3,
                           model_samples_per_iteration=8, surrogate_samples=256,
                           surrogate_effective_samples=32, integration_nodes=16,
                           basq_samples=256, basq_effective_samples=32, verbose=False)
    assert w.total_sober_iterations == 1


def test_wrapper_checkpoint_round_trip(tmp_path):
    """save_state / load_state: the observations, the counters and the
    random state resume, and the resumed wrapper goes on."""
    w = _make()
    w.run_SOBER(sober_iterations=1, model_samples_per_iteration=8, surrogate_samples=256,
                surrogate_effective_samples=32, verbose=False)
    path = str(tmp_path / "ck")
    w.save_state(path)
    w2 = _make()
    w2.load_state(path)
    assert torch.equal(w2.X_all, w.X_all) and torch.equal(w2.Y_all, w.Y_all)
    assert w2.sober_iterations == w.sober_iterations
    assert w2.total_sober_iterations == w.total_sober_iterations
    assert w2.total_model_samples == w.total_model_samples
    assert torch.equal(w2.keys._gen.get_state(), w.keys._gen.get_state())
    w2.run_SOBER(sober_iterations=1, model_samples_per_iteration=8, surrogate_samples=256,
                 surrogate_effective_samples=32, verbose=False)
    assert len(w2.X_all) == len(w.X_all) + 8


def test_checkpoint_layout_matches_jax(tmp_path):
    """save_checkpoint writes the JAX package's .npz layout (the same
    __paths__ for a dict holding arrays and a GPParams NamedTuple), and
    load_checkpoint restores a structure like the one given."""
    rng = np.random.default_rng(0)
    arrays = {"x_all": rng.normal(size=(3, 2)).astype(np.float32),
              "y_all": rng.normal(size=3).astype(np.float32)}
    raw = {"raw_lengthscale": np.float32(0.1), "raw_outputscale": np.float32(0.2),
           "raw_noise": np.float32(0.3)}
    jck.save_checkpoint(str(tmp_path / "j.npz"),
                        {**arrays, "gp": jx.GPParams(**{k: jnp.asarray(v) for k, v in raw.items()})})
    tparams = gp_params_from_numpy(raw, "cpu")
    tck.save_checkpoint(str(tmp_path / "t.npz"), {**arrays, "gp": tparams}, metadata={"a": 1})
    paths = lambda name: list(np.load(tmp_path / name)["__paths__"].item().split('"')[1::2])
    assert paths("t.npz") == paths("j.npz")
    like = {**{k: torch.zeros(1) for k in arrays}, "gp": tparams}
    back, meta = tck.load_checkpoint(str(tmp_path / "t"), like)
    assert meta == {"a": 1} and torch.equal(back["x_all"], torch.as_tensor(arrays["x_all"]))
    assert isinstance(back["gp"], tx.GPParams) and float(back["gp"].raw_noise) == np.float32(0.3)


def test_parallel_evaluation_matches_rows():
    """evaluate_model in a process pool makes one model call a row:
    numpy's norm of each row."""
    w = _make(model=np.linalg.norm, model_initial_samples=4, standalone=False,
              parallelization=True)
    x = torch.rand((4, 2), generator=_gen(3))
    rows = w.reverse_transform(w.denormalize_input(x)).numpy()
    got = w.evaluate_model(x).numpy()
    assert got.shape == (4,) and np.allclose(got, np.linalg.norm(rows, axis=1), rtol=1e-6)


# -- expectation propagation -----------------------------------------------------

def sim_identity(x, **kwargs):
    x = np.atleast_2d(np.asarray(x))
    return np.stack([x[:, 0], x[:, 1]], axis=1)


def features(obs):
    obs = np.asarray(obs)
    return [obs[..., 0], obs[..., 1]]


def test_ep_site_structures():
    """The sites' natural parameters and the distance of the current
    feature only (test_apps.py's)."""
    ep = ExpectationPropagation(model=sim_identity, data=np.array([0.3, -0.2]),
                                feature_extractor=features, model_initial_samples=10,
                                bounds=[[-1.0, -1.0], [1.0, 1.0]], parallelization=False,
                                seed=0, device="cpu")
    assert ep.feature_dim == 2 and ep.Q.shape == (2, 2)
    assert torch.allclose(ep.Q @ ep.normalized_covariance, torch.eye(2), atol=1e-4)
    ep.current_feature = 0
    assert float(ep.distance_function(np.array([[0.3, 99.0]]))[0]) < 1e-6
    ep.current_feature = 1
    assert abs(float(ep.distance_function(torch.tensor([[0.3, 99.0]]))[0]) - 99.2) < 1e-4


@pytest.mark.slow
def test_ep_parameter_recovery():
    """test_apps.py's identity-simulator EP: after one sweep of 2 SOBER
    iterations per site the posterior mean is within 0.15 of theta*,
    closer than the prior's, and the posterior tighter than the prior."""
    theta_star = np.array([0.6, -0.4])
    ep = ExpectationPropagation(model=sim_identity, data=theta_star,
                                feature_extractor=features, model_initial_samples=20,
                                bounds=[[-1.0, -1.0], [1.0, 1.0]], parallelization=False,
                                seed=0, device="cpu")

    def to_original(m):
        return ep.reverse_transform(ep.denormalize_input(torch.atleast_2d(m)))[0].numpy()

    prior_err = np.abs(to_original(ep.normalized_mean) - theta_star).max()
    ep.run_Expectation_Propagation(
        ep_iterations=1, sober_iterations=2, model_samples_per_iteration=16,
        surrogate_samples=1024, surrogate_effective_samples=64, integration_nodes=32,
        basq_samples=1024, basq_effective_samples=64, verbose=False)
    post_cov = torch.linalg.inv(ep.Q)
    err = np.abs(to_original(post_cov @ ep.r) - theta_star).max()
    assert err < 0.15 and err < prior_err
    assert (torch.diag(post_cov) < torch.diag(ep.normalized_covariance)).all()
