"""The port's device default: a constructor that is not handed tensors puts
its own on CUDA unless the caller names a device (`config.resolve_device`),
and never falls back to the CPU. Runs without a card: the constructors'
calls to `resolve_device` are recorded and answered with the CPU."""
import numpy as np
import pytest
import torch

from sober_tpu_torch import Sober, config, interop
from sober_tpu_torch.apps import bolfi, wrapper
from sober_tpu_torch.core.sampler import RecombinationSampler
from sober_tpu_torch.gp import exact, fbgp, warped
from sober_tpu_torch.ops import kernels
from sober_tpu_torch.priors import continuous, dataset, discrete, tmvn, wkde
from sober_tpu_torch.tasks import discrete as discrete_tasks
from sober_tpu_torch.tasks import ecm, synthetic
from sober_tpu_torch.tasks.drug import setup_malaria, setup_solvent
from sober_tpu_torch.utils import prng, sobol


def test_resolve_device_defaults_to_cuda():
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")
    assert config.resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_no_cpu_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises((RuntimeError, AssertionError)):
        kernels.make_kernel("rbf")


def _raw_params():
    return {"raw_lengthscale": np.zeros(3), "raw_outputscale": np.zeros(()),
            "raw_noise": np.zeros(())}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, prng.KeyRing):
        return [torch.empty(0, device=obj.device)]
    if isinstance(obj, RecombinationSampler):
        return _tensors(obj.keys)
    if isinstance(obj, kernels.Kernel):
        return list(obj.params.values())
    if isinstance(obj, exact.GPState):
        return [obj.x, obj.y, obj.alpha, obj.chol, obj.linv, *_tensors(obj.kernel),
                *obj.mean_params.values()]
    if isinstance(obj, tuple):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    if isinstance(obj, continuous.TruncatedGaussian):
        return [obj.mu, obj.cov, obj.bounds, obj.chol, obj.constant, *_tensors(obj.tmvn)]
    if isinstance(obj, tmvn.TruncatedMVN):
        tilt = getattr(obj, "_tilt", ())
        return [obj.mu, obj.cov, obj.lb, obj.ub, obj.prec, obj.cond_sd,
                *(t for t in tilt if isinstance(t, torch.Tensor))]
    if isinstance(obj, ecm.CanonicalECMTwoRCs):
        return [obj.omega, obj.theta_true, obj.reZ, obj.imZ, obj.mu, obj.sigma]
    if isinstance(obj, wrapper.SoberWrapper):
        return [obj.bounds, obj.diagonalization, obj.X_all, obj.mean,
                *_tensors(obj.prior), *_tensors(obj.keys)]
    if isinstance(obj, continuous.Uniform):
        return [obj.bounds, *obj._sobol[:2]]
    if isinstance(obj, continuous.Gaussian):
        return [obj.mu, obj.cov, obj.chol]
    if isinstance(obj, wkde.WeightedKernelDensityEstimation):
        return [obj.bounds, *obj._params.values()]
    if isinstance(obj, discrete.BinaryPrior):
        return [obj.probs]
    if isinstance(obj, discrete.CategoricalPrior):
        return [obj.n_categories, obj.value_table, obj.valid_mask, obj.weights]
    if isinstance(obj, discrete._MixedPrior):
        return [obj.bounds, *_tensors(obj.prior_cont), *_tensors(obj.prior_disc)]
    if isinstance(obj, discrete_tasks.Ising):
        return [obj.h, obj.v, obj.h_ind, obj.v_ind, obj._pairs_h, obj._pairs_v,
                obj._cov_h, obj._cov_v, obj.log_partition_original]
    if isinstance(obj, discrete_tasks.MaxSAT):
        return [obj.weights, obj.idx, obj.sign]
    if isinstance(obj, fbgp.RBFHyperPrior):
        return [obj.hypermu, obj.hyperstd]
    if isinstance(obj, fbgp.FitboGP):
        return [obj.alpha, obj.Y_unwarp, obj.fobs_padded, obj.model.x, obj.model.alpha]
    if isinstance(obj, fbgp.FullyBayesianGP):
        return [obj.Xobs, obj.fobs, obj.mask, obj.eta, obj.w_qd, obj.Theta_qd,
                *obj._cache]
    if isinstance(obj, warped.ScaleMmltGP):
        return [obj.beta, obj.y_log, obj.model.x, obj.model.alpha]
    if callable(obj):                          # a task's objective
        return []
    return [obj.features, obj.true_targets, obj.available]


def _cpu_state():
    x = torch.rand((8, 2))
    return exact.fit_gp(x, x.sum(1), exact.GPConfig(fit_iters=2))


def _state_dict(n=4):
    """A GP state as interop's dicts hold one."""
    import dataclasses

    eye = np.eye(n)
    return {"config": dataclasses.asdict(exact.GPConfig(standardize_y=False)),
            "kernel_name": "rbf",
            "kernel_params": {"lengthscale": np.ones(()), "outputscale": np.ones(())},
            "noise": np.full((), 1e-4), "x": np.zeros((n, 1)), "y": np.zeros(n),
            "y_mean": np.zeros(()), "y_std": np.ones(()), "chol": eye,
            "alpha": np.zeros(n), "mask": None, "linv": eye}


def _loglik(n=6):
    x = np.linspace(-1.0, 1.0, n).reshape(-1, 1)
    return x, -0.5 * x[:, 0] ** 2


# (module whose resolve_device the constructor calls, the call)
CONSTRUCTORS = {
    "KeyRing": (prng, lambda: prng.KeyRing(0)),
    "RecombinationSampler": (prng, lambda: RecombinationSampler(None)),
    "DatasetPrior": (dataset, lambda: dataset.DatasetPrior(np.zeros((4, 3)),
                                                           np.zeros(4))),
    "dataset_prior_from_numpy": (dataset, lambda: interop.dataset_prior_from_numpy(
        np.zeros((4, 3)), np.zeros(4))),
    "setup_malaria": (dataset, lambda: setup_malaria(n_pool=8)),
    "setup_solvent": (dataset, lambda: setup_solvent(n_pool=8)),
    "gp_params_from_numpy": (interop, lambda: interop.gp_params_from_numpy(
        _raw_params())),
    "init_params": (exact, lambda: exact.init_params(exact.GPConfig(), 3)),
    "make_kernel": (kernels, lambda: kernels.make_kernel("rbf", n_dims=3, ard=True)),
    "sobol_engine": (sobol, lambda: sobol.sobol_engine(3)[:2]),
    "Uniform": (continuous, lambda: continuous.Uniform([[0.0, 0.0], [1.0, 1.0]])),
    "Gaussian": (continuous, lambda: continuous.Gaussian([0.0, 0.0], np.eye(2))),
    "WeightedKernelDensityEstimation": (wkde, lambda: wkde.WeightedKernelDensityEstimation(
        np.random.default_rng(0).uniform(size=(20, 2)), np.ones(20), 2,
        bounds=[[0.0, 0.0], [1.0, 1.0]])),
    "continuous_prior_from_numpy": (interop, lambda: interop.continuous_prior_from_numpy(
        {"family": "gaussian", "mu": np.zeros(2), "cov": np.eye(2)})),
    "setup_shekel": (continuous, lambda: synthetic.setup_shekel()),
    "TruncatedGaussian": (continuous, lambda: continuous.TruncatedGaussian(
        [0.0, 0.0], np.eye(2), [[-1.0, -1.0], [1.0, 1.0]])),
    "TruncatedMVN": (tmvn, lambda: tmvn.TruncatedMVN(
        np.zeros(2), np.eye(2), np.array([[2.0, 2.0], [4.0, 4.0]]), method="tilting")),
    "truncated_gaussian_from_numpy": (interop, lambda: interop.truncated_gaussian_from_numpy(
        {"mu": np.zeros(2), "cov": np.eye(2), "bounds": np.array([[-1.0, -1.0], [1.0, 1.0]]),
         "n_rounds": 10, "gibbs_threshold": 0.05})),
    "setup_ecm_two": (ecm, lambda: ecm.setup_ecm_two()),
    "ecm_from_numpy": (interop, lambda: interop.ecm_from_numpy(
        {"theta_true": np.zeros(5), "sigma": 1.0, "omega": np.logspace(1, 3, 4),
         "reZ": np.zeros(4), "imZ": np.zeros(4)})),
    "make_bolfi_model": (fbgp, lambda: bolfi.make_bolfi_model(
        *_loglik(8), [[-1.0], [1.0]], fit_iters=4)),
    "SoberWrapper": (wrapper, lambda: wrapper.SoberWrapper(
        model=np.linalg.norm, data=np.zeros(1), bounds=[[0.0, 0.0], [1.0, 1.0]],
        prior="TruncatedGaussian", model_initial_samples=4, standalone=False,
        parallelization=False)),
    "Sober (continuous)": (continuous, lambda: Sober(
        continuous.Uniform([[0.0, 0.0], [1.0, 1.0]]), _cpu_state())),
    "BinaryPrior": (discrete, lambda: discrete.BinaryPrior(3)),
    "CategoricalPrior": (discrete, lambda: discrete.CategoricalPrior([[0.0, 1.0], [2.0]])),
    "MixedBinaryPrior": (discrete, lambda: discrete.MixedBinaryPrior(
        2, 3, [[0.0, 0.0], [1.0, 1.0]])),
    "MixedCategoricalPrior": (discrete, lambda: discrete.MixedCategoricalPrior(
        1, 2, [[0.0, 1.0], [2.0]], [[0.0], [1.0]])),
    "discrete_prior_from_numpy": (interop, lambda: interop.discrete_prior_from_numpy(
        {"family": "binary", "probs": np.full(3, 0.5)})),
    "Ising": (discrete_tasks, lambda: discrete_tasks.Ising(1e-4)),
    "MaxSAT": (discrete_tasks, lambda: discrete_tasks.MaxSAT(
        discrete_tasks.DATA_DIR / "maxcut-johnson8-2-4.clq.wcnf")),
    "setup_ackley": (discrete, lambda: synthetic.setup_ackley()),
    "Sober (binary)": (discrete, lambda: Sober(discrete.BinaryPrior(2), _cpu_state())),
    "RBFHyperPrior": (fbgp, lambda: fbgp.RBFHyperPrior(n_ls=2)),
    "FitboGP": (fbgp, lambda: fbgp.FitboGP(*_loglik(), fit_iters=2, bucket=8)),
    "ScaleMmltGP": (fbgp, lambda: warped.ScaleMmltGP(*_loglik(), fit_iters=2)),
    "hyperprior_from_numpy": (interop, lambda: interop.hyperprior_from_numpy(
        {"n_ls": 1, "hypermu": np.zeros(4), "hyperstd": np.ones(4)})),
    "fitbo_gp_from_numpy": (interop, lambda: interop.fitbo_gp_from_numpy(
        {"state": _state_dict(), "alpha": np.ones(()), "Y_unwarp": np.zeros(4),
         "x_obs_raw": np.zeros((4, 1)), "fobs_padded": np.zeros(4), "label": "wsabim",
         "alpha_factor": 1.0, "bucket": 4, "optimiser": "lbfgs"})),
    "fbgp_from_numpy": (interop, lambda: interop.fbgp_from_numpy(
        {"Xobs": np.zeros((4, 1)), "fobs": np.zeros(4), "mask": np.ones(4),
         "eta": np.ones(()), "w_qd": np.full(2, 0.5), "Theta_qd": np.ones((2, 4)),
         "linv": np.stack([np.eye(4)] * 2), "alpha": np.zeros((2, 4))})),
    "scale_mmlt_from_numpy": (interop, lambda: interop.scale_mmlt_from_numpy(
        {"state": _state_dict(), "beta": np.zeros(()), "y_log": np.zeros(4),
         "kernel_name": "rbf", "optimiser": "lbfgs"})),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_cuda(monkeypatch, name):
    """Each constructor hands an unset device to resolve_device and puts its
    tensors where that sends them."""
    module, make = CONSTRUCTORS[name]
    seen = []

    def spy(device=None):
        seen.append(device)
        return torch.device("cpu")

    monkeypatch.setattr(module, "resolve_device", spy)
    made = make()
    assert seen and seen[0] is None
    assert all(t.device == torch.device("cpu") for t in _tensors(made))
