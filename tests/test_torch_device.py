"""The port's device default: a constructor that is not handed tensors puts
its own on CUDA unless the caller names a device (`config.resolve_device`),
and never falls back to the CPU. Runs without a card: the constructors'
calls to `resolve_device` are recorded and answered with the CPU."""
import numpy as np
import pytest
import torch

from sober_tpu_torch import Sober, config, interop
from sober_tpu_torch.core.sampler import RecombinationSampler
from sober_tpu_torch.gp import exact
from sober_tpu_torch.ops import kernels
from sober_tpu_torch.priors import continuous, dataset, wkde
from sober_tpu_torch.tasks import synthetic
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
    if isinstance(obj, tuple):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, continuous.Uniform):
        return [obj.bounds, *obj._sobol[:2]]
    if isinstance(obj, continuous.Gaussian):
        return [obj.mu, obj.cov, obj.chol]
    if isinstance(obj, wkde.WeightedKernelDensityEstimation):
        return [obj.bounds, *obj._params.values()]
    if callable(obj):                          # a task's objective
        return []
    return [obj.features, obj.true_targets, obj.available]


def _cpu_state():
    x = torch.rand((8, 2))
    return exact.fit_gp(x, x.sum(1), exact.GPConfig(fit_iters=2))


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
    "Sober (continuous)": (continuous, lambda: Sober(
        continuous.Uniform([[0.0, 0.0], [1.0, 1.0]]), _cpu_state())),
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
