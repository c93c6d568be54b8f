"""The port's main path against the JAX package's on the CPU: one exact-GP
batch-BO iteration as bench.py:bench_fused runs it (warm-started
fit_params -> build_state -> posterior_max_mean -> fused_acquisition) at a
small size, plus pi and weight cleansing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core import pi as jpi
from sober_tpu.core.fused import fused_acquisition as jax_fused
from sober_tpu.core.rchq import nystrom_basis as jax_nystrom_basis
from sober_tpu.gp import exact as jx
from sober_tpu.utils.weights import cleansing_weights as jax_cleansing
from sober_tpu_torch.core import pi as tpi
from sober_tpu_torch.core.fused import fused_acquisition
from sober_tpu_torch.gp import exact as tx
from sober_tpu_torch.interop import gp_state_from_numpy, gp_state_to_numpy
from sober_tpu_torch.utils.weights import cleansing_weights

N_OBS, D, N_CAND, N_NYS, BATCH = 40, 3, 2048, 64, 16


def _problem(seed=0):
    """bench.py:bench_fused's data at a small size."""
    rng = np.random.default_rng(seed)
    x_obs = rng.uniform(-1, 1, (N_OBS, D)).astype(np.float32)
    y_obs = (np.sin(3 * x_obs[:, 0]) * np.cos(2 * x_obs[:, 1])
             + 0.1 * rng.normal(size=N_OBS)).astype(np.float32)
    x_cand = rng.uniform(-1, 1, (N_CAND, D)).astype(np.float32)
    pdf = np.full((N_CAND,), 1.0 / 2.0 ** D, np.float32)
    return x_obs, y_obs, x_cand, pdf


def _std(y):
    sd = y.std() if isinstance(y, torch.Tensor) else y.std(ddof=1)
    return (y - y.mean()) / sd


def _jax_iteration(x_obs, y_obs, x_cand, pdf):
    cfg = jx.GPConfig(fit_iters=100)
    x, y = jnp.asarray(x_obs), jnp.asarray(y_obs)
    p_prev = jx.fit_params(x[:N_OBS - BATCH], _std(y[:N_OBS - BATCH]), cfg)
    params = jx.fit_params(x, _std(y), cfg, params0=p_prev)
    state = jx.build_state(params, x, y, cfg)
    eta = jx.posterior_max_mean(state)
    idx, w, weights = jax_fused(state, eta, jnp.asarray(x_cand),
                                jnp.asarray(x_cand[:N_NYS]), jnp.asarray(pdf),
                                BATCH)
    return state, float(eta), np.asarray(idx), np.asarray(w), np.asarray(weights)


def _jax_phi(state, x_cand):
    """JAX's normalized feature strip, as its recombination builds it."""
    kern = lambda a, b: jx.predictive_covariance(state, a, b)
    xn, xc = jnp.asarray(x_cand[:N_NYS]), jnp.asarray(x_cand)
    k_nys = kern(xn, xn)
    u = jax_nystrom_basis(0.5 * (k_nys + k_nys.T), BATCH - 1)
    phi = np.asarray(u @ kern(xn, xc))
    return phi / np.abs(phi).max()


def _check_batch(idx, w, weights, phi):
    idx, w, weights = idx.numpy(), w.numpy(), weights.numpy()
    assert idx.shape == (BATCH,) and (w >= 0).all()
    assert abs(w.sum() - 1.0) < 1e-4
    assert len(set(idx.tolist())) == BATCH
    assert idx.min() >= 0 and idx.max() < N_CAND
    err = np.abs(phi[:, idx] @ w - phi @ (weights / weights.sum())).max()
    assert err < 5e-3


def test_iteration_matches_jax():
    """Both packages fit their own hypers. The fits stop at slightly
    different points (optax's zoom line search vs torch's strong-Wolfe),
    so the cleansed weights are held to 1e-4, not 1e-6; the port's fit
    must reach the JAX fit's loss."""
    x_obs, y_obs, x_cand, pdf = _problem()
    jstate, jeta, _, _, jweights = _jax_iteration(x_obs, y_obs, x_cand, pdf)
    cfg = tx.GPConfig(fit_iters=100)
    x, y, xc = map(torch.as_tensor, (x_obs, y_obs, x_cand))
    p_prev = tx.fit_params(x[:N_OBS - BATCH], _std(y[:N_OBS - BATCH]), cfg)
    params = tx.fit_params(x, _std(y), cfg, params0=p_prev)
    state = tx.build_state(params, x, y, cfg)
    eta = tx.posterior_max_mean(state)
    idx, w, weights = fused_acquisition(state, eta, xc, xc[:N_NYS],
                                        torch.as_tensor(pdf), BATCH)
    loss = lambda p, mod, arr: float(mod.neg_mll(p, arr(x_obs), arr(_std(y_obs)),
                                                 mod.GPConfig()))
    jparams = jx.raw_params_from_state(jstate)
    loss_j = loss(jparams, jx, jnp.asarray)
    assert loss(params, tx, torch.as_tensor) <= loss_j + 1e-3 * abs(loss_j)
    assert abs(float(eta) - jeta) <= 1e-4 * abs(jeta)
    assert np.abs(weights.numpy() - jweights).max() <= 1e-4
    _check_batch(idx, w, weights, _jax_phi(jstate, x_cand))


def test_iteration_from_carried_state_matches_jax(record_property):
    """Both packages start from the same JAX-fitted GPState, carried across
    through interop.py."""
    x_obs, y_obs, x_cand, pdf = _problem(seed=1)
    jstate, jeta, jidx, jw, jweights = _jax_iteration(x_obs, y_obs, x_cand, pdf)
    state = gp_state_from_numpy(gp_state_to_numpy(jstate), device="cpu")
    eta = tx.posterior_max_mean(state)
    xc = torch.as_tensor(x_cand)
    idx, w, weights = fused_acquisition(state, eta, xc, xc[:N_NYS],
                                        torch.as_tensor(pdf), BATCH)
    assert abs(float(eta) - jeta) <= 1e-4 * abs(jeta)
    assert np.abs(weights.numpy() - jweights).max() <= 1e-6
    _check_batch(idx, w, weights, _jax_phi(jstate, x_cand))
    record_property("support_overlap",
                    len(set(idx.tolist()) & set(jidx[jw > 0].tolist())))


@pytest.mark.parametrize("log", [False, True])
def test_lfi_and_pi_match_jax(log):
    x_obs, y_obs, x_cand, _ = _problem(seed=2)
    jstate = jx.fit_gp(jnp.asarray(x_obs), jnp.asarray(y_obs),
                       jx.GPConfig(fit_iters=20), optimiser="adam")
    state = gp_state_from_numpy(gp_state_to_numpy(jstate), device="cpu")
    jp, tp = jpi.PI(jstate), tpi.PI(state)
    assert abs(float(tp.eta) - float(jp.eta)) <= 1e-4 * abs(float(jp.eta))
    want = np.asarray(jp(jnp.asarray(x_cand), log=log))
    got = tp(torch.as_tensor(x_cand), log=log).numpy()
    if log:   # log(pi + eps): compare pi + eps, where the values live
        got, want = np.exp(got), np.exp(want)
    assert np.abs(got - want).max() <= 1e-5
    with pytest.raises(NotImplementedError):
        tpi.PI(state, label="ts")


@pytest.mark.parametrize("case", ["plain", "anomalies", "all_small", "tiny"])
def test_cleansing_weights_match_jax(case):
    """The reference's ordering quirks: w < eps -> 0 first (negatives,
    -inf), then +inf -> eps and NaN -> eps, then normalize or go uniform."""
    rng = np.random.default_rng(4)
    w = rng.uniform(0, 2, 50).astype(np.float32)
    if case == "anomalies":
        w[[1, 5, 9, 13, 17]] = [np.nan, np.inf, -np.inf, -3.0, 1e-9]
    elif case == "all_small":
        w[:] = -1.0
        w[3] = np.nan
    elif case == "tiny":
        w *= 1e-6
    want = np.asarray(jax_cleansing(jnp.asarray(w)))
    got = cleansing_weights(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
