"""Parity of the port's exact GP (sober_tpu_torch.gp.exact) with the JAX
package on the CPU: the MAP objective and its gradient, the rescued
Cholesky, the posterior cache, prediction and the fits."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.gp import exact as jx
from sober_tpu.utils.linalg import jitter_cholesky as jax_jitter_cholesky
from sober_tpu_torch.gp import exact as tx
from sober_tpu_torch.interop import (gp_params_from_numpy, gp_state_from_numpy,
                                     gp_state_to_numpy)
from sober_tpu_torch.utils.linalg import jitter_cholesky


def _close(got, want, rtol):
    """max |got - want| <= rtol * max |want| (plus a 1e-12 floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rtol * scale + 1e-12, (err, scale)


def _data(n=30, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _standardize(y, mask=None):
    if mask is None:
        return ((y - y.mean()) / y.std(ddof=1)).astype(np.float32)
    n = mask.sum()
    mu = (y * mask).sum() / n
    sd = np.sqrt((((y - mu) * mask) ** 2).sum() / (n - 1))
    return ((y - mu) / sd * mask).astype(np.float32)


def _raw(ard, d):
    ls = np.array([-0.3, 0.2, 0.1][:d], np.float32) if ard else np.float32(-0.2)
    return {"raw_lengthscale": ls, "raw_outputscale": np.float32(0.4),
            "raw_noise": np.float32(0.3)}


def _jax_params(raw):
    return jx.GPParams(**{k: jnp.asarray(v) for k, v in raw.items()})


def _torch_leaves(raw):
    return tx.GPParams(*(torch.tensor(raw[k], requires_grad=True)
                         for k in tx.GPParams._fields))


def _params_to_numpy(p):
    return {k: np.asarray(getattr(p, k)) for k in tx.GPParams._fields}


@pytest.mark.parametrize("masked,ard,priors", [(False, False, False),
                                               (True, False, False),
                                               (False, True, True),
                                               (True, True, False)])
def test_neg_mll_and_grad_match_jax(masked, ard, priors):
    x, y = _data()
    mask = None
    if masked:
        xp, yp, mask = (np.array(a) for a in jx.pad_observations(
            jnp.asarray(x), jnp.asarray(y), 16))
        x, y = xp, yp
    ys = _standardize(y, mask)
    raw = _raw(ard, x.shape[1])
    jcfg = jx.GPConfig(ard=ard, use_priors=priors)
    tcfg = tx.GPConfig(ard=ard, use_priors=priors)
    jmask = None if mask is None else jnp.asarray(mask)
    loss_j, grad_j = jax.value_and_grad(
        lambda p: jx.neg_mll(p, jnp.asarray(x), jnp.asarray(ys), jcfg, jmask)
    )(_jax_params(raw))
    params = _torch_leaves(raw)
    loss_t = tx.neg_mll(params, torch.as_tensor(x), torch.as_tensor(ys), tcfg,
                        None if mask is None else torch.as_tensor(mask))
    loss_t.backward()
    _close(float(loss_t.detach()), float(loss_j), 1e-4)
    for name, p in zip(tx.GPParams._fields, params):
        _close(p.grad.numpy(), np.asarray(getattr(grad_j, name)), 1e-4)


def _sym_with_spectrum(lam, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(len(lam), len(lam))))
    return ((q * lam) @ q.T).astype(np.float32)


@pytest.mark.parametrize("lam_min,retries", [(-1e-3, True), (0.5, False)])
def test_rescued_cholesky_matches_jax(lam_min, retries):
    """Forward factor and the backward a_bar / extra_bar against jax.grad
    through the JAX _rescued_cholesky; with the smallest eigenvalue at
    -1e-3 the retry at `extra` fires on both sides."""
    a = _sym_with_spectrum(np.linspace(lam_min, 2.0, 8), seed=1)
    extra = np.float32(1e-2)
    w = np.random.default_rng(2).normal(size=a.shape).astype(np.float32)
    assert bool(np.isnan(np.asarray(jnp.linalg.cholesky(a))).any()) == retries

    f = lambda a_, e_: jnp.sum(jnp.asarray(w) * jx._rescued_cholesky(a_, e_))
    chol_j = np.asarray(jx._rescued_cholesky(jnp.asarray(a), jnp.asarray(extra)))
    a_bar_j, e_bar_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(a),
                                                    jnp.asarray(extra))

    a_t = torch.tensor(a, requires_grad=True)
    e_t = torch.tensor(extra, requires_grad=True)
    chol_t = tx._rescued_cholesky(a_t, e_t)
    torch.sum(torch.as_tensor(w) * chol_t).backward()
    assert np.isfinite(chol_t.detach().numpy()).all()
    _close(chol_t.detach().numpy(), chol_j, 1e-4)
    _close(a_t.grad.numpy(), np.asarray(a_bar_j), 1e-4)
    _close(float(e_t.grad), float(e_bar_j), 1e-4)
    assert (float(e_t.grad) != 0.0) == retries


def test_rescued_cholesky_gradients_finite_on_indefinite_gram():
    """The rosenbrock seed-1 buffer at pad 1664 (tests/test_gp.py): the loss
    and every gradient are finite and the lengthscale gradient informative.
    Whether fp32 potrf fails here can differ between LAPACK builds, so the
    JAX result is not required."""
    d = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "rosenbrock_s1_it3.npz"))
    x, y = torch.as_tensor(d["x"]), torch.as_tensor(d["y"])
    xp, yp, mask = tx.pad_observations(x, y, 1664)
    mu = (yp * mask).sum() / mask.sum()
    var = ((yp - mu) ** 2 * mask).sum() / (mask.sum() - 1)
    ys = (yp - mu) / torch.sqrt(var) * mask
    cfg = tx.GPConfig()
    params = tx.GPParams(*(p.requires_grad_(True)
                           for p in tx.init_params(cfg, x.shape[1], device="cpu")))
    loss = tx.neg_mll(params, xp, ys, cfg, mask)
    loss.backward()
    assert np.isfinite(float(loss))
    for p in params:
        assert torch.isfinite(p.grad).all()
    assert float(params.raw_lengthscale.grad.abs().max()) > 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_build_state_matches_jax(masked):
    x, y = _data()
    mask = None
    if masked:
        x, y, mask = (np.array(a) for a in jx.pad_observations(
            jnp.asarray(x), jnp.asarray(y), 16))
    raw = _raw(False, x.shape[1])
    js = jx.build_state(_jax_params(raw), jnp.asarray(x), jnp.asarray(y),
                        jx.GPConfig(), None if mask is None else jnp.asarray(mask))
    ts = tx.build_state(gp_params_from_numpy(raw, device="cpu"), torch.as_tensor(x),
                        torch.as_tensor(y), tx.GPConfig(),
                        None if mask is None else torch.as_tensor(mask))
    for name in ("chol", "alpha", "linv", "y", "y_mean", "y_std", "noise"):
        _close(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), 1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_prediction_on_carried_state_matches_jax(masked):
    x, y = _data(seed=1)
    if masked:
        js = jx.fit_gp_padded(jnp.asarray(x), jnp.asarray(y), bucket=16,
                              cfg=jx.GPConfig(fit_iters=30))
    else:
        js = jx.fit_gp(jnp.asarray(x), jnp.asarray(y), jx.GPConfig(fit_iters=30))
    ts = gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")
    rng = np.random.default_rng(5)
    xq = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    xr = rng.uniform(-1, 1, (45, 3)).astype(np.float32)
    mean_j, var_j = jx.predict(js, jnp.asarray(xq))
    mean_t, var_t = tx.predict(ts, torch.as_tensor(xq))
    _close(mean_t.numpy(), np.asarray(mean_j), 1e-4)
    _close(var_t.numpy(), np.asarray(var_j), 1e-4)
    cov_j = jx.predictive_covariance(js, jnp.asarray(xq), jnp.asarray(xr))
    cov_t = tx.predictive_covariance(ts, torch.as_tensor(xq), torch.as_tensor(xr))
    _close(cov_t.numpy(), np.asarray(cov_j), 1e-4)
    _close(float(tx.posterior_max_mean(ts)), float(jx.posterior_max_mean(js)),
           1e-4)


def test_fit_adam_matches_jax():
    x, y = _data()
    ys = _standardize(y)
    cfg_j, cfg_t = jx.GPConfig(fit_iters=60), tx.GPConfig(fit_iters=60)
    p_j = jx._fit_adam(jx.init_params(cfg_j, 3), jnp.asarray(x),
                       jnp.asarray(ys), cfg_j)
    p_t = tx._fit_adam(tx.init_params(cfg_t, 3, device="cpu"), torch.as_tensor(x),
                       torch.as_tensor(ys), cfg_t)
    loss_j = float(jx.neg_mll(p_j, jnp.asarray(x), jnp.asarray(ys), cfg_j))
    loss_t = float(tx.neg_mll(p_t, torch.as_tensor(x), torch.as_tensor(ys), cfg_t))
    assert abs(loss_t - loss_j) <= 1e-3 * abs(loss_j)


@pytest.mark.parametrize("masked", [False, True])
def test_fit_params_not_worse_than_jax(masked):
    """The L-BFGS ladder: the port's final loss is at most JAX's plus
    1e-3 |loss|. optax's zoom line search and torch's strong-Wolfe search
    take different steps, so only the end point is compared."""
    x, y = _data(seed=2)
    mask = None
    if masked:
        x, y, mask = (np.array(a) for a in jx.pad_observations(
            jnp.asarray(x), jnp.asarray(y), 16))
    ys = _standardize(y, mask)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    cfg_j, cfg_t = jx.GPConfig(), tx.GPConfig()
    p_j = jx.fit_params(jnp.asarray(x), jnp.asarray(ys), cfg_j, mask=jm)
    p_t = tx.fit_params(torch.as_tensor(x), torch.as_tensor(ys), cfg_t, mask=tm)
    loss_j = float(jx.neg_mll(p_j, jnp.asarray(x), jnp.asarray(ys), cfg_j, jm))
    loss_t = float(tx.neg_mll(p_t, torch.as_tensor(x), torch.as_tensor(ys),
                              cfg_t, tm))
    assert loss_t <= loss_j + 1e-3 * abs(loss_j)
    init = tx.init_params(cfg_t, 3, device="cpu")
    assert loss_t < float(tx.neg_mll(init, torch.as_tensor(x),
                                     torch.as_tensor(ys), cfg_t, tm))


def test_fit_gp_padded_matches_unpadded_fit():
    """Padding rows carry no weight: the padded fit predicts like the fit on
    the real rows alone, from the same hypers."""
    x, y = _data(n=21)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    padded = tx.fit_gp_padded(xt, yt, cfg=tx.GPConfig(fit_iters=20), bucket=16)
    assert padded.x.shape[0] == 32 and float(padded.mask.sum()) == 21
    raw = tx.GPParams(tx._inv_softplus(padded.kernel.params["lengthscale"]),
                      tx._inv_softplus(padded.kernel.params["outputscale"]),
                      tx._inv_interval(padded.noise, 1e-8, 1e-3))
    plain = tx.build_state(raw, xt, yt, tx.GPConfig())
    xq = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (10, 3)),
                         dtype=torch.float32)
    for a, b in zip(tx.predict(padded, xq), tx.predict(plain, xq)):
        _close(a.numpy(), b.numpy(), 1e-4)


@pytest.mark.parametrize("shift,max_tries", [(0.05, None), (-1e-2, None),
                                             (-1.0, 2)])
def test_jitter_cholesky_matches_jax(shift, max_tries):
    """Healthy, escalated (negative eigenvalue) and fallen-back-to-diagonal
    factorizations, with the same jitter on both sides."""
    a = _sym_with_spectrum(np.linspace(0.0, 1.0, 12) + shift, seed=4)
    l_j, jit_j = jax_jitter_cholesky(jnp.asarray(a), max_tries=max_tries)
    l_t, jit_t = jitter_cholesky(torch.as_tensor(a), max_tries=max_tries)
    _close(float(jit_t), float(jit_j), 1e-5)
    _close(l_t.numpy(), np.asarray(l_j), 1e-4)


def test_interop_round_trip_and_refusals():
    x, y = _data()
    js = jx.fit_gp(jnp.asarray(x), jnp.asarray(y), jx.GPConfig(fit_iters=5),
                   optimiser="adam")
    d = gp_state_to_numpy(js)
    ts = gp_state_from_numpy(d, device="cpu")
    assert ts.config == tx.GPConfig(fit_iters=5)
    np.testing.assert_array_equal(ts.linv.numpy(), d["linv"])
    assert ts.mask is None and ts.kernel.name == "rbf"
    p = gp_params_from_numpy(_params_to_numpy(jx.init_params(js.config, 3)),
                             device="cpu")
    assert p.raw_lengthscale.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        gp_state_from_numpy({**d, "mean_params": {"c": np.zeros(())}},
                            device="cpu")
    with pytest.raises(NotImplementedError):
        gp_state_from_numpy({**d, "config": {**d["config"],
                                             "mean_priors": (1.0,)}},
                            device="cpu")
