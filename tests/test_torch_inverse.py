"""Parity of the port's multitask GPs (gp/multitask.py) and InverseModel
(apps/inverse.py) with the JAX package, on the CPU: the same seeded numpy
inputs, fitted states carried across by interop, and the fit held by its
loss and its predictions, since float32 Adam trajectories part ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.gp import multitask as jmt
from sober_tpu.gp.exact import GPConfig as JGPConfig
from sober_tpu_torch import interop
from sober_tpu_torch.apps.inverse import InverseModel
from sober_tpu_torch.gp import multitask as tmt
from sober_tpu_torch.gp.exact import GPConfig

KERNELS = {"rbf": 0, "matern52": 1}


def _icm_truth(n=40, d=2, seed=3, noise=0.03, ls=0.5):
    """Exact-ICM data (tests/test_multitask.py:_icm_truth at a smaller n):
    three latents of one RBF GP mixed by chol(B)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = np.exp(-0.5 * d2 / ls ** 2) + 1e-6 * np.eye(n)
    b = np.array([[1.0, 0.8, 0.0], [0.8, 1.0, -0.5], [0.0, -0.5, 1.0]]) + 0.05 * np.eye(3)
    z = rng.normal(size=(n, 3))
    y = np.linalg.cholesky(k) @ z @ np.linalg.cholesky(b).T + noise * rng.normal(size=(n, 3))
    return x, y.astype(np.float32)


def _raw(d=2, t=3, ard=False, seed=0):
    """Raw ICM parameters away from the init, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return {"raw_ls": rng.normal(0.3, 0.2, (d,) if ard else ()).astype(np.float32),
            "raw_noise": np.float32(-2.5),
            "l_f": (0.3 * rng.normal(size=(t, t))).astype(np.float32),
            "raw_v": np.linspace(-0.5, 0.3, t).astype(np.float32)}


def _state_loss(st) -> float:
    """-log p(vec(Y)) of a fitted ICM state (either package), from its
    eigen-caches."""
    yt, lx, lb = (np.asarray(a, np.float64) for a in (st.yt, st.lx, st.lb))
    d = lx[:, None] * lb[None, :] + float(st.noise)
    return 0.5 * float(np.sum(yt * yt / d) + np.sum(np.log(d)) + yt.size * np.log(2 * np.pi))


def _carried_icm(kernel="rbf", ard=False, fit_iters=60):
    x, y = _icm_truth()
    jst = jmt.fit_icm_gp(jnp.asarray(x), jnp.asarray(y), fit_iters=fit_iters, ard=ard,
                         kernel=kernel)
    return x, y, jst, interop.icm_state_from_numpy(interop.icm_state_to_numpy(jst), "cpu")


@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_icm_kx_matches_jax(kernel, ard):
    rng = np.random.default_rng(1)
    x1 = rng.uniform(-1, 1, (17, 3)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (11, 3)).astype(np.float32)
    x2[0] = x1[0]                                  # r = 0, the sqrt floor
    ls = rng.uniform(0.3, 1.2, 3).astype(np.float32) if ard else np.float32(0.6)
    want = np.asarray(jmt._icm_kx(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                                  jnp.asarray(KERNELS[kernel])))
    got = tmt._icm_kx(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(ls),
                      KERNELS[kernel]).numpy()
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_icm_neg_mll_and_gradient_match_jax(kernel, ard):
    """The loss and its gradient through both eighs, at carried raw
    parameters: 1e-4 relative."""
    x, y = _icm_truth(n=24)
    ys = (y - y.mean(0)) / y.std(0, ddof=1)
    raw = _raw(ard=ard)
    kid = KERNELS[kernel]
    jloss, jgrad = jax.value_and_grad(jmt._icm_neg_mll)(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(x), jnp.asarray(ys),
        jnp.asarray(kid))
    traw = {k: torch.tensor(v, requires_grad=True) for k, v in raw.items()}
    tloss = tmt._icm_neg_mll(traw, torch.as_tensor(x), torch.as_tensor(ys), kid)
    tloss.backward()
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    for k in raw:
        want, got = np.asarray(jgrad[k]), traw[k].grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max()), k


@pytest.mark.parametrize("kernel,ard", [("rbf", False), ("matern52", True)])
def test_fit_icm_loss_no_worse_than_jax(kernel, ard):
    """200 Adam steps (the default): the trajectories agree to ~1e-5 for
    ~60 steps, then part; near the end Adam's steps at lr 0.05 move the
    loss by ~0.1% a step, so the best iterates differ by that much."""
    x, y = _icm_truth()
    jst = jmt.fit_icm_gp(jnp.asarray(x), jnp.asarray(y), ard=ard, kernel=kernel)
    tst = tmt.fit_icm_gp(torch.as_tensor(x), torch.as_tensor(y), ard=ard, kernel=kernel)
    j_loss, t_loss = _state_loss(jst), _state_loss(tst)
    assert t_loss <= j_loss + 1e-3 * abs(j_loss), (t_loss, j_loss)
    assert tst.lengthscale.shape == ((2,) if ard else ())


def test_eigh_backward_is_torchs_without_ties():
    """_Eigh's gradient equals torch.linalg.eigh's where no eigenvalues tie."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(12, 12))
    a = torch.tensor(a + a.T, dtype=torch.float64)
    w = torch.tensor(rng.normal(size=(12, 12)))
    grads = []
    for eigh in (tmt._Eigh.apply, torch.linalg.eigh):
        x = a.clone().requires_grad_(True)
        lam, v = eigh(x)
        (torch.sum(lam ** 3) + torch.sum((v * w) ** 2)).backward()
        grads.append(0.5 * (x.grad + x.grad.T))
    assert torch.allclose(grads[0], grads[1], rtol=1e-9, atol=1e-9)


def test_icm_fit_survives_tied_eigenvalues():
    """Inputs so far apart that k_x is I in float32: every eigenvalue of
    k_x ties. JAX's eigh backward gives NaN at the first step and its fit
    keeps the init (lengthscale 1); the port's leaves the tied pairs out and
    fits, to a lower loss."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(30, 50)).astype(np.float32)
    y = np.stack([x[:, 0], x[:, 1] + x[:, 0]], 1).astype(np.float32)
    jst = jmt.fit_icm_gp(jnp.asarray(x), jnp.asarray(y), fit_iters=60)
    tst = tmt.fit_icm_gp(torch.as_tensor(x), torch.as_tensor(y), fit_iters=60)
    assert float(jst.lengthscale) == pytest.approx(1.0)
    assert all(bool(torch.isfinite(t).all()) for t in tst if isinstance(t, torch.Tensor))
    assert _state_loss(tst) < _state_loss(jst)


def test_icm_predictions_match_jax():
    """predict_icm, task_posterior_cov_icm and task_correlation on a carried
    ICMState: 1e-5 (relative to the largest value)."""
    x, _, jst, tst = _carried_icm()
    xq = np.random.default_rng(2).uniform(-1, 1, (9, 2)).astype(np.float32)
    close = lambda got, want: np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())
    for noise in (True, False):
        jm, jv = jmt.predict_icm(jst, jnp.asarray(xq), include_noise=noise)
        tm, tv = tmt.predict_icm(tst, torch.as_tensor(xq), include_noise=noise)
        assert close(tm.numpy(), np.asarray(jm)) and close(tv.numpy(), np.asarray(jv))
        jc = jmt.task_posterior_cov_icm(jst, jnp.asarray(xq), include_noise=noise)
        tc = tmt.task_posterior_cov_icm(tst, torch.as_tensor(xq), include_noise=noise)
        assert close(tc.numpy(), np.asarray(jc))
    assert close(tst.task_correlation.numpy(), np.asarray(jst.task_correlation))
    assert tst.n_tasks == 3


def test_sample_icm_statistics():
    """sample_icm's draws by mean and covariance against predict_icm and
    task_posterior_cov_icm."""
    _, _, _, tst = _carried_icm()
    xq = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, (5, 2)).astype(np.float32))
    s = tmt.sample_icm(tst, torch.Generator().manual_seed(0), xq, 4000)
    assert s.shape == (4000, 5, 3)
    mu, _ = tmt.predict_icm(tst, xq)
    cov = tmt.task_posterior_cov_icm(tst, xq).numpy()
    sd = np.sqrt(np.einsum("mtt->mt", cov))
    assert (np.abs(s.mean(0).numpy() - mu.numpy()) <= 0.1 * sd).all()
    emp = np.stack([np.cov(s[:, m].numpy().T) for m in range(5)])
    assert np.abs(emp - cov).max() < 0.1 * np.abs(cov).max()


def test_fit_multitask_gp_matches_jax_per_task():
    """Each column's Adam MAP fit against JAX's vmapped one, by predictions
    (tests/test_multitask.py's tolerances for the batched fit)."""
    x, y = _icm_truth()
    cfg = dict(ard=False, noise_lo=1e-6, noise_hi=1.0, standardize_y=True,
               use_priors=False, fit_iters=100)
    jm = jmt.fit_multitask_gp(jnp.asarray(x), jnp.asarray(y), JGPConfig(**cfg))
    tm = tmt.fit_multitask_gp(torch.as_tensor(x), torch.as_tensor(y), GPConfig(**cfg))
    assert tm.n_tasks == jm.n_tasks == 3
    for t, st in enumerate(tm.states):                 # each task's hypers
        got = [float(st.kernel.params[k]) for k in ("outputscale", "lengthscale")]
        want = [float(np.asarray(jm.states.kernel.params[k])[t])
                for k in ("outputscale", "lengthscale")]
        got.append(float(st.noise))
        want.append(float(np.asarray(jm.states.noise)[t]))
        assert np.allclose(got, want, rtol=1e-3), (t, got, want)
    xq = x[:16]
    jmu, jvar = jmt.predict_multitask(jm, jnp.asarray(xq))
    tmu, tvar = tmt.predict_multitask(tm, torch.as_tensor(xq))
    assert np.allclose(tmu.numpy(), np.asarray(jmu), atol=5e-3)
    assert np.allclose(tvar.numpy(), np.asarray(jvar), rtol=0.05, atol=1e-5)
    carried = interop.multitask_gp_from_numpy(interop.multitask_gp_to_numpy(jm), "cpu")
    cmu, cvar = tmt.predict_multitask(carried, torch.as_tensor(xq))
    assert np.abs(cmu.numpy() - np.asarray(jmu)).max() <= 1e-5 * max(1.0, np.abs(jmu).max())
    assert np.abs(cvar.numpy() - np.asarray(jvar)).max() <= 1e-5
    s = tmt.sample_multitask(tm, torch.Generator().manual_seed(0), torch.as_tensor(xq), 2000)
    assert s.shape == (2000, 16, 3)
    assert (np.abs(s.mean(0).numpy() - tmu.numpy()) <= 0.15 * np.sqrt(tvar.numpy())).all()


def _aniso(n=96, seed=7, ls=(0.3, 1.5)):
    """tests/test_multitask.py:_icm_truth_aniso."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    d2 = (((x[:, None, :] - x[None, :, :]) / np.asarray(ls)) ** 2).sum(-1)
    k = np.exp(-0.5 * d2) + 1e-6 * np.eye(n)
    b = np.array([[1.0, 0.7], [0.7, 1.0]]) + 0.05 * np.eye(2)
    z = rng.normal(size=(n, 2)).astype(np.float32)
    y = np.linalg.cholesky(k) @ z @ np.linalg.cholesky(b).T + 0.03 * rng.normal(size=(n, 2))
    return torch.as_tensor(x), torch.as_tensor(y.astype(np.float32)), np.asarray(ls)


def test_icm_ard_recovers_per_dim_lengthscales():
    """tests/test_multitask.py's ARD properties on the port: one lengthscale
    a dimension, ordered and near the truth, and a held-out fit no worse
    than the isotropic one's."""
    x, y, true_ls = _aniso()
    ls = tmt.fit_icm_gp(x, y, fit_iters=300, ard=True).lengthscale.numpy()
    assert ls.shape == (2,) and ls[0] < ls[1]
    assert abs(ls[0] - true_ls[0]) < 0.15 and ls[1] > 0.8
    ard = tmt.fit_icm_gp(x[:72], y[:72], fit_iters=300, ard=True)
    iso = tmt.fit_icm_gp(x[:72], y[:72], fit_iters=300)
    rmse = lambda st: float(torch.sqrt(torch.mean((tmt.predict_icm(st, x[72:])[0] - y[72:]) ** 2)))
    assert rmse(ard) <= rmse(iso) * 1.05


def test_icm_matern52_fits_and_predicts():
    """tests/test_multitask.py's Matern-5/2 properties on the port."""
    x, y = (torch.as_tensor(a) for a in _icm_truth(n=80, seed=8))
    st = tmt.fit_icm_gp(x, y, fit_iters=200, ard=True, kernel="matern52")
    mu, var = tmt.predict_icm(st, x)
    assert mu.shape == y.shape and bool((var > 0).all())
    assert float((mu - y).abs().mean()) < 0.2
    cov = tmt.task_posterior_cov_icm(st, x[:4]).numpy()
    assert (np.linalg.eigvalsh(cov) > -1e-5).all()


def test_fit_icm_rejects_unknown_kernel():
    with pytest.raises(ValueError, match="kernel must be one of"):
        tmt.fit_icm_gp(torch.zeros((4, 2)), torch.zeros((4, 2)), kernel="linear")


def _sim(x, **kw):
    x = np.atleast_2d(np.asarray(x))
    return np.stack([x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]], axis=1)


def _rough_sim(x, **kw):
    """_sim with a deterministic high-frequency term the inverse GP reads
    as observation noise: on _sim itself the fitted noise is ~5e-6 and the
    posterior variances ~1e-6 are float32 cancellation of the unit prior
    variance in either package."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    return _sim(x) + 0.05 * np.sin(997.0 * x[:, :1] + 113.0 * x[:, 1:] * np.array([1.0, -1.0]))


@pytest.mark.parametrize("task_covariance", ["icm", "independent"])
def test_inverse_model_flow(task_covariance):
    """tests/test_apps.py::TestInverseModel.test_flow's properties, for both
    task covariances."""
    inv = InverseModel(model=_sim, model_initial_samples=24,
                       bounds=[[-1.0, -1.0], [1.0, 1.0]], parallelization=False, seed=0,
                       task_covariance=task_covariance, device="cpu")
    assert inv.inverse_model is not None
    mean, cov, (lo, hi) = inv.evaluate(np.array([[0.5, 0.1]]))
    assert mean.shape == (1, 2) and cov.shape == (1, 2, 2)
    assert bool((lo <= hi).all())
    s = inv.sample(np.array([[0.5, 0.1]]), 16)
    assert s.shape == (16, 1, 2) and bool(torch.isfinite(s).all())


def test_inverse_model_rejects_unknown_task_covariance():
    with pytest.raises(ValueError, match="task_covariance"):
        InverseModel(model=_sim, model_initial_samples=4, bounds=[[-1.0], [1.0]],
                     task_covariance="full", device="cpu")


def test_evaluate_matches_jax_on_carried_model():
    """evaluate on the same inverse model: JAX's ICMState and observation
    normalization carried into the port's InverseModel (whose Sobol
    initial design is JAX's bit for bit), then the mean, covariance and chi2
    bounds in both spaces."""
    from sober_tpu.apps.inverse import InverseModel as JInverseModel

    bounds = [[-1.0, -1.0], [1.0, 1.0]]
    kw = dict(model=_rough_sim, model_initial_samples=24, parallelization=False, seed=0)
    jinv = JInverseModel(bounds=jnp.asarray(bounds), **kw)
    tinv = InverseModel(bounds=bounds, device="cpu", **kw)
    assert np.array_equal(tinv.X_all.numpy(), np.asarray(jinv.X_all))
    tinv.inverse_model = interop.icm_state_from_numpy(
        interop.icm_state_to_numpy(jinv.inverse_model), "cpu")
    tinv.observations_all_mean = torch.tensor(np.asarray(jinv.observations_all_mean))
    tinv.observations_all_std = torch.tensor(np.asarray(jinv.observations_all_std))
    obs = np.array([[0.5, 0.1], [-0.3, 0.4]], np.float32)
    # 1e-5 in the unit cube; the parameter space stretches it by the span 2
    for normalized, tol in ((True, 1e-5), (False, 2e-5)):
        jm, jc, (jl, jh) = jinv.evaluate(obs, normalized_space=normalized)
        tm, tc, (tl, th) = tinv.evaluate(obs, normalized_space=normalized)
        for got, want in ((tm, jm), (tc, jc), (tl, jl), (th, jh)):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())
