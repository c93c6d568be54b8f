"""The port's migration surface (compat.py, the package exports,
set_settings), its Tracer (utils/timing.py) and the SVM task
(tasks/svm.py), on the CPU, beside the JAX package's."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sober_tpu_torch
from sober_tpu import compat as jcompat
from sober_tpu_torch import compat
from sober_tpu_torch.utils.timing import PHASES, Tracer

CPU = "cpu"


@pytest.mark.parametrize("name", jcompat.__all__)
def test_every_jax_compat_name_resolves(name):
    """Every name of sober_tpu.compat.__all__, in the port's compat."""
    assert name in compat.__all__
    assert getattr(compat, name) is not None


def test_package_exports():
    for name in ("Settings", "settings", "set_settings", "setting_parameters", "Sober",
                 "SoberWrapper", "KeyRing", "__version__"):
        assert getattr(sober_tpu_torch, name) is not None, name
    assert sober_tpu_torch.setting_parameters is sober_tpu_torch.set_settings
    from sober_tpu_torch.apps.wrapper import SoberWrapper

    assert sober_tpu_torch.SoberWrapper is SoberWrapper is compat.SoberWrapper


def test_set_settings_takes_only_the_ports_fields_in_float32():
    before = sober_tpu_torch.settings()
    try:
        assert sober_tpu_torch.set_settings(max_psd_iter=3).max_psd_iter == 3
        sober_tpu_torch.set_settings(compute_dtype=torch.float32, solve_dtype="float32")
        with pytest.raises(ValueError, match="float32"):
            sober_tpu_torch.set_settings(compute_dtype=torch.float64)
        with pytest.raises(ValueError, match="float32"):
            sober_tpu_torch.setting_parameters(solve_dtype=np.float16)
        with pytest.raises(TypeError, match="chunk_limit"):
            sober_tpu_torch.set_settings(chunk_limit=10)
    finally:
        sober_tpu_torch.set_settings(**{k: getattr(before, k)
                                        for k in ("eps_weights", "max_psd_iter")})


def test_tensor_manager():
    tm = compat.TensorManager(seed=3, device=CPU)
    assert tm.ones(4, 2).shape == (4, 2) and tm.zeros(4).shape == (4,)
    r = tm.rand(3, 16)
    assert r.shape == (16, 3) and float(r.min()) >= 0 and float(r.max()) < 1
    assert tm.rand(2, 8, qmc=False).shape == (8, 2)
    assert sorted(tm.randperm(7).tolist()) == list(range(7))
    idx = tm.multinomial([0.0, 0.0, 1.0, 1.0], 2)
    assert set(idx.tolist()) == {2, 3}
    assert tm.numpy(tm.tensor([1.0, 2.0])).tolist() == [1.0, 2.0]
    assert tm.null().shape == (0,) and tm.arange(3).tolist() == [0, 1, 2]


def test_is_cuda_false_on_the_cpu():
    assert not compat.TensorManager(device=CPU).is_cuda()
    assert compat.device_manager(CPU) == torch.device(CPU)
    assert compat.device_manager() == torch.device("cuda")
    assert compat.dtype_manager() is torch.float32


def test_safe_tensor_operator():
    op = compat.Utils(device=CPU)
    assert bool(torch.isfinite(op.remove_anomalies([1.0, np.nan, np.inf])).all())
    bad = [[1.0, 2.0], [2.0, 1.0]]                    # indefinite
    assert not op.is_psd(bad)
    assert op.is_psd(op.make_cov_psd(bad))
    p = op.safe_mvn_prob(np.zeros(2), np.eye(2), np.zeros((3, 2)))
    assert np.allclose(p.numpy(), 1 / (2 * np.pi), atol=1e-5)


def test_weights_stabiliser():
    ws = compat.WeightsStabiliser(thresh=2, seed=1, device=CPU)
    w = ws.cleansing_weights([1.0, -2.0, np.nan, 3.0])
    assert abs(float(w.sum()) - 1.0) < 1e-6 and bool((w >= 0).all())
    assert ws.check_weights([0.2, 0.8]) and not ws.check_weights([0.0, 0.0])
    x = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    assert ws.kmeans_resampling(x, n_clusters=4).shape == (4, 2)
    assert len(set(ws.weighted_resampling([0.1, 0.2, 0.3, 0.4], 3).tolist())) == 3
    assert ws.deweighted_resampling([0.1, 0.2, 0.3, 0.4], 2).shape == (2,)


def test_mle_adapters_match_jax():
    rng = np.random.default_rng(0)
    xb = (rng.random((256, 3)) < [0.2, 0.5, 0.9]).astype(np.float32)
    w = np.full(256, 1 / 256, np.float32)
    p = compat.BernoulliMLE(w, xb, device=CPU).optimize()
    want = np.asarray(jcompat.BernoulliMLE(jnp.asarray(w), jnp.asarray(xb)).optimize())
    assert np.abs(p.numpy() - want).max() <= 1e-6
    idx = rng.integers(0, 3, (256, 2))
    pc = compat.CategoricalMLE(w, idx, 2, 4, device=CPU).train()
    want = np.asarray(jcompat.CategoricalMLE(jnp.asarray(w), jnp.asarray(idx), 2, 4).train())
    assert pc.shape == (2, 4) and np.abs(pc.numpy() - want).max() <= 1e-6


def test_gp_aliases_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (32, 2)).astype(np.float32))
    y = torch.sin(3 * x[:, 0]) + 0.1 * torch.as_tensor(rng.normal(size=32).astype(np.float32))
    mu0, _ = compat.predict(compat.set_gp(x, y, fit_iters=5), x[:4])
    state = compat.train_GP_with_Adam(x, y, fit_iters=5)
    cache, kxx = compat.get_cov_cache(state)
    assert cache.shape == kxx.shape == (32, 32)
    mu, var = compat.predict(state, x[:4])
    assert mu.shape == mu0.shape == (4,) and bool((var > 0).all())
    assert compat.train_GP_with_BFGS(x, y, fit_iters=8).x.shape == (32, 2)


def _kern(a, b):
    return torch.exp(-0.5 * ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1))


def test_ker_svd_sparsify():
    pt = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (24, 2)).astype(np.float32))
    s_vals, u = compat.ker_svd_sparsify(pt, 5, _kern)
    assert s_vals.shape == (5,) and u.shape == (5, 24)
    assert bool((s_vals[:-1] >= s_vals[1:]).all())
    assert np.allclose((u @ u.T).numpy(), np.eye(5), atol=1e-4)


def test_ln_normal_prob_matches_scipy_and_jax():
    from scipy.stats import norm

    for a, b in [(-1.0, 1.0), (3.0, 5.0), (-6.0, -4.0), (8.0, 12.0), (-0.5, 9.0)]:
        want = np.log(norm.sf(a) - norm.sf(b))
        got = float(compat.lnNormalProb(torch.tensor(a), torch.tensor(b)))
        assert abs(got - want) < 5e-4, (a, b, got, want)
        assert abs(got - float(jcompat.lnNormalProb(a, b))) < 5e-4
    assert abs(float(compat.lnPhi(torch.tensor(2.0))) - norm.logsf(2.0)) < 1e-5


def test_tchernychova_lyons_car():
    """One CAR pass: at most n_feat + 1 points, the augmented moments kept."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 3))
    mu = rng.uniform(0.1, 1, 40)
    mu /= mu.sum()
    mu_new = compat.Tchernychova_Lyons_CAR(x, mu, device=CPU).double().numpy()
    assert (mu_new >= 0).all() and np.count_nonzero(mu_new > 1e-10) <= 4
    assert abs(mu_new.sum() - 1.0) < 1e-4
    assert np.abs(mu_new @ x - mu @ x).max() < 1e-3


def test_mod_tchernychova_lyons_precomputed_basis():
    rng = np.random.default_rng(3)
    tm = compat.TensorManager(device=CPU)
    x = tm.tensor(rng.uniform(-1, 1, (400, 2)))
    pt = x[:32]
    mu = tm.tensor(rng.uniform(0.1, 1, 400))
    mu = mu / mu.sum()
    _, u = compat.ker_svd_sparsify(pt, 7, _kern)
    w, idx = compat.Mod_Tchernychova_Lyons(x, u, pt, _kern, tm=tm, mu=mu)
    w = w.double().numpy()
    assert len(w) <= 8 and (w > 0).all() and abs(w.sum() - 1.0) < 1e-3
    phi = (u @ _kern(pt, x)).double().numpy()
    assert np.abs(phi[:, idx.numpy()] @ w - phi @ mu.double().numpy()).max() < 5e-3


def test_rc_kernel_svd_and_log_marginal_likelihood():
    x = torch.as_tensor(np.random.default_rng(2).uniform(-1, 1, (512, 2)).astype(np.float32))
    idx, w = compat.rc_kernel_svd(x, x[:32], 8, _kern)
    assert idx.shape == (8,) and bool((w >= 0).all()) and abs(float(w.sum()) - 1) < 1e-3
    theta = torch.tensor([0.0, -4.0, -0.5, 0.0])
    fobs = torch.exp(-(x[:16] ** 2).sum(1))
    lml = compat.LogMarginalLikelihood(theta, x[:16], fobs, fobs.max())
    want = float(jcompat.LogMarginalLikelihood(jnp.asarray(theta.numpy()),
                                               jnp.asarray(x[:16].numpy()),
                                               jnp.asarray(fobs.numpy()),
                                               jnp.asarray(float(fobs.max()))))
    assert abs(float(lml) - want) <= 1e-4 * max(1.0, abs(want))


def test_bolfi_kernel_and_parabolic_mean():
    k = compat.BOLFIKernel(2, ard=True, device=CPU)
    assert k.params["lengthscale"].shape == (2,)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (20, 2))
    y = (x ** 2) @ [1.0, 2.0] + x @ [0.5, -0.5] + 3.0
    a, b, c = compat.ParabolicMean(torch.as_tensor(x), y)
    assert np.allclose(a, [1.0, 2.0], atol=1e-6) and np.allclose(b, [0.5, -0.5], atol=1e-6)
    assert abs(float(c) - 3.0) < 1e-6


def test_tracer_spans_summary_and_profile(tmp_path):
    tr = Tracer(profile_dir=str(tmp_path / "trace"), device=CPU)
    # the spans the program records, and none it never records
    assert {"fit", "next_batch", "recombination", "sampler.nystrom"} <= set(PHASES)
    assert "objective_eval" not in PHASES
    tr.start_profile()
    for _ in range(2):
        with tr.span("fit", block=True):
            torch.ones(8).sum()
    with tr.span("sampler.nystrom"):
        pass
    path = tr.stop_profile()
    assert path is not None and (tmp_path / "trace" / "trace.json").exists()
    assert tr.stop_profile() is None
    s = tr.summary()
    assert s["fit"]["count"] == 2 and s["sampler.nystrom"]["count"] == 1
    assert s["fit"]["total_s"] >= s["fit"]["max_s"] > 0
    assert "fit" in tr.report() and "sampler.nystrom" in tr.report()
    # the spans run under the profiler, so its trace holds them
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert "sober.sampler.nystrom" in {e.get("name") for e in events}


def test_svm_setup_matches_jax():
    """setup_svm's prior layout and objective against the JAX package's on
    the same rows (the synthetic stand-in data, seed 0)."""
    pytest.importorskip("sklearn")
    from sober_tpu.tasks.svm import setup_svm as jsetup
    from sober_tpu_torch.tasks.svm import setup_svm

    jprior, jf = jsetup()
    prior, f = setup_svm(device=CPU)
    assert (prior.n_dims_cont, prior.n_dims_binary) == (3, 20)
    assert not prior.continous_first
    assert np.array_equal(prior.bounds.numpy(), np.asarray(jprior.bounds))
    x = prior.sample(torch.Generator().manual_seed(0), 6)
    assert x.shape == (6, 23) and bool(((x[:, :20] == 0) | (x[:, :20] == 1)).all())
    assert bool(((x[:, 20:] >= 0) & (x[:, 20:] <= 1)).all())
    got = f(x)
    want = np.asarray(jf(jnp.asarray(x.numpy())))
    assert got.dtype == torch.float32 and got.shape == (6,)
    assert np.abs(got.numpy() - want).max() <= 1e-6
