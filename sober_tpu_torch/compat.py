"""Reference-name compatibility layer (port of sober_tpu/compat.py).

Every name of `sober_tpu.compat.__all__` resolves here to the port's
counterpart, so code written against the reference's `SOBER.<module>`
names moves over by import. Three kinds of mapping:

1. **Same name, same role**, re-exported (`Sober`, `BASQ`,
   `recombination`, the priors, `TruncatedMVN`, ...).
2. **Renamed**, aliased (`PI_BQ` -> `PIBQ`, `TanimotoGP` ->
   `fit_tanimoto_gp`, `update_gp` -> `fit_gp`, `BOLFIModel` ->
   `make_bolfi_model`, `setting_parameters` -> `set_settings`).
3. **The reference's object surface over the port's functions**: thin
   adapters (`TensorManager`, `SafeTensorOperator`/`Utils`,
   `WeightsStabiliser`, `BernoulliMLE`, `CategoricalMLE`) with the
   reference's method names (SOBER/_utils.py:20-199, _weights.py:4-97,
   _prior_update.py:33-229). Each holds a device (CUDA unless given,
   `config.resolve_device`); the ones that draw hold a `KeyRing` where the
   reference relied on torch's global seed.
"""
from __future__ import annotations

import numpy as np
import torch

# 1. same-name re-exports -----------------------------------------------------
from . import set_settings, setting_parameters, settings, Sober  # noqa: F401
from .apps.basq import BASQ  # noqa: F401
from .apps.bolfi import SOBERUCB, BoTorchLCBSC, make_bolfi_model  # noqa: F401
from .apps.ep import ExpectationPropagation  # noqa: F401
from .apps.inverse import InverseModel  # noqa: F401
from .config import resolve_device
from .core.pi import PI  # noqa: F401
from .core.prior_update import (  # noqa: F401
    bernoulli_mle,
    categorical_mle,
    update_binary_prior,
    update_categorical_prior,
    update_continuous_prior,
    update_mixed_prior,
)
from .core.rchq import _caratheodory, local_reduce, recombination  # noqa: F401
from .core.rckernel import RecombinationKernel as Kernel  # noqa: F401
from .core.sampler import (  # noqa: F401
    EmpiricalSampler,
    MixtureSampler,
    RecombinationSampler,
)
from .gp.exact import (  # noqa: F401
    GPConfig,
    GPState,
    build_state,
    fit_gp,
    fit_gp_padded,
    init_params,
    predict,
    predict_mean,
    predictive_covariance,
)
from .gp.fbgp import (  # noqa: F401
    FBGPAcquisitionFunction,
    FitboGP,
    FullyBayesianGP,
    RBFHyperPrior,
    ScaleVanillaGP,
    fitbo_mll_batch,
    quadrature_distillation,
    sampling_hypers,
)
from .gp.tanimoto import batch_tanimoto_sim, fit_tanimoto_gp  # noqa: F401
from .gp.warped import ScaleMmltGP  # noqa: F401
from .ops.kernels import make_kernel, tanimoto_gram  # noqa: F401
from .ops.kmeans import kmeans, kmeans_resampling
from .priors.base import BasePrior  # noqa: F401
from .priors.continuous import Gaussian, TruncatedGaussian, Uniform  # noqa: F401
from .priors.dataset import DatasetPrior  # noqa: F401
from .priors.discrete import (  # noqa: F401
    BinaryPrior,
    CategoricalPrior,
    MixedBinaryPrior,
    MixedCategoricalPrior,
)
from .priors.mvn_cdf import multivariate_normal_cdf, mvn_box_prob  # noqa: F401
from .priors.tmvn import TruncatedMVN  # noqa: F401
from .priors.wkde import WeightedKernelDensityEstimation  # noqa: F401
from .utils.linalg import make_psd, remove_anomalies, safe_mvn_prob
from .utils.prng import KeyRing
from .utils.sobol import sobol_engine, sobol_sample
from .utils.weights import (
    check_weights,
    cleansing_weights,
    deweighted_resampling,
    weighted_resampling,
)

# 2. renamed aliases ----------------------------------------------------------
from .gp.warped import PIBQ as PI_BQ  # noqa: F401,E402  (SOBER/_pi.py:109)
from .gp.fbgp import PIFBGP as PI_FBGP  # noqa: F401,E402  (SOBER/_pi.py:58)

#: reference update_gp / train_GP (SOBER/_gp.py:128-209): the one-call MAP
#: fit; ``optimiser`` selects the ladder rung
update_gp = fit_gp
train_GP = fit_gp


def _f32(a, device=None) -> torch.Tensor:
    """`a` as float32: a tensor stays on its device unless one is named; an
    array goes to `device` (CUDA unless given)."""
    if isinstance(a, torch.Tensor) and device is None:
        return a.to(torch.float32)
    return torch.as_tensor(a, dtype=torch.float32, device=resolve_device(device))


def train_GP_with_Adam(x, y, cfg=None, **kw):
    """SOBER/_gp.py:128-155, the Adam rung."""
    return fit_gp(x, y, cfg, optimiser="adam", **kw)


def train_GP_with_BFGS(x, y, cfg=None, **kw):
    """SOBER/_gp.py:96-126, the L-BFGS rung (with best-iterate tracking)."""
    return fit_gp(x, y, cfg, optimiser="lbfgs", **kw)


def set_gp(x, y, cfg=None, **cfg_kwargs):
    """SOBER/_gp.py:34-70: a GP around the data at the initial hypers
    (unfitted; `fit_gp` / `update_gp` fit it), on x's device."""
    if cfg is None:
        cfg = GPConfig(**cfg_kwargs)
    return build_state(init_params(cfg, x.shape[1], x.dtype, x.device), x, y, cfg)


def get_cov_cache(state: GPState):
    """SOBER/_gp.py:255-278, the covariance cache: the Cholesky factor the
    state holds, with Kxx, in the reference's order."""
    return state.chol, state.kernel.gram(state.x, state.x)


#: reference TanimotoGP (SOBER/_drug_modelling.py:103-113): the fit itself
TanimotoGP = fit_tanimoto_gp
#: reference TanimotoKernel.forward (SOBER/_drug_modelling.py:86-101)
TanimotoKernel = tanimoto_gram
BitKernel = tanimoto_gram
#: reference BOLFIModel (SOBER/BOLFI/_gpytorch_bolfi_model.py:341-460)
BOLFIModel = make_bolfi_model


def ParabolicMean(x, y):
    """SOBER/BOLFI/_gpytorch_bolfi_model.py:16-165: the per-dimension
    quadratic mean's least-squares seed, the (a, b, c) coefficients
    make_bolfi_model starts from."""
    from .apps.bolfi import _parabolic_fit

    as_np = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return _parabolic_fit(as_np(x), as_np(y))


def ker_svd_sparsify(pt, s, kernel):
    """SOBER/_rchq.py:34-39, the Nystrom spectral basis: the top `s`
    eigenpairs of the PSD-repaired Gram over the Nystrom points, as
    (eigenvalues descending, U with the test functions in rows)."""
    eigvals, eigvecs = torch.linalg.eigh(make_psd(kernel(pt, pt)))
    return eigvals[-s:].flip(0), eigvecs[:, -s:].flip(1).T


def KMeans(x, K: int = 10, Niter: int = 10):
    """SOBER/_weights.py:100-125, Lloyd's algorithm: (labels, centroids)."""
    return kmeans(x, K, Niter)


# 3. adapter classes ----------------------------------------------------------
class TensorManager:
    """SOBER/_utils.py:20-78: a float32 tensor factory on one device (CUDA
    unless given) with QMC `rand`, drawing from a KeyRing."""

    def __init__(self, seed: int = 0, dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.keys = KeyRing(seed, device=self.device)

    def tensor(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    standardise_tensor = tensor
    standardise_device = tensor

    def ones(self, n_samples, n_dims=None):
        shape = (n_samples,) if n_dims is None else (n_samples, n_dims)
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, n_samples, n_dims=None):
        shape = (n_samples,) if n_dims is None else (n_samples, n_dims)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def rand(self, n_dims, n_samples, qmc: bool = True):
        gen = self.keys.next()
        if qmc:
            seed = int(torch.randint(0, 2**32, (), generator=gen, device=self.device))
            state = sobol_engine(n_dims, seed, device=self.device)
            return sobol_sample(state, 0, n_samples).to(self.dtype)
        return torch.rand((n_samples, n_dims), generator=gen, dtype=self.dtype,
                          device=self.device)

    def arange(self, length):
        return torch.arange(length, device=self.device)

    def null(self):
        return torch.zeros((0,), dtype=self.dtype, device=self.device)

    def randperm(self, length):
        return torch.randperm(length, generator=self.keys.next(), device=self.device)

    def multinomial(self, weights, n):
        return weighted_resampling(self.keys.next(), self.tensor(weights), n)

    def numpy(self, x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def is_cuda(self):
        return self.device.type == "cuda"


class SafeTensorOperator(TensorManager):
    """SOBER/_utils.py:81-194: anomaly scrubbing, PSD repair, the MVN pdf."""

    def remove_anomalies(self, y):
        return remove_anomalies(self.tensor(y))

    def is_psd(self, mat):
        _, info = torch.linalg.cholesky_ex(self.tensor(mat))
        return bool(info == 0)

    def make_cov_psd(self, mat):
        return make_psd(self.tensor(mat))

    def safe_mvn_prob(self, mean, cov, x):
        return safe_mvn_prob(self.tensor(mean), self.tensor(cov), self.tensor(x))


class Utils(SafeTensorOperator):
    """SOBER/_utils.py:197-199, an alias of SafeTensorOperator."""


class WeightsStabiliser(TensorManager):
    """SOBER/_weights.py:4-97 over the port's weights functions."""

    def __init__(self, eps: float | None = None, thresh: int = 5, seed: int = 0,
                 device=None):
        super().__init__(seed, device=device)
        self.eps = eps
        self.thresh = thresh

    def cleansing_weights(self, weights):
        return cleansing_weights(self.tensor(weights), eps=self.eps)

    def check_weights(self, weights):
        return bool(check_weights(self.tensor(weights), thresh=self.thresh))

    def weighted_resampling(self, weights, n):
        return weighted_resampling(self.keys.next(), self.tensor(weights), n)

    def deweighted_resampling(self, weights, n):
        return deweighted_resampling(self.keys.next(), self.tensor(weights), n)

    def kmeans_resampling(self, x, n_clusters: int = 100):
        return kmeans_resampling(self.tensor(x), n_clusters)


class BernoulliMLE:
    """SOBER/_prior_update.py:33-122. The reference runs 5 x 4 L-BFGS steps
    on a sigmoid-transformed likelihood; the weighted Bernoulli MLE has the
    closed form p_d = sum w_i x_id / sum w_i, which this computes
    (core/prior_update.py) on `device` (CUDA unless given). Nothing is
    drawn, so it holds no KeyRing."""

    def __init__(self, weights, x_binary, device=None):
        self.device = resolve_device(device)
        self.weights = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        self.x = torch.as_tensor(x_binary, dtype=torch.float32, device=self.device)

    def optimize(self):
        return bernoulli_mle(self.weights, self.x)

    train = optimize


class CategoricalMLE:
    """SOBER/_prior_update.py:124-229: the closed-form weighted categorical
    MLE (see BernoulliMLE)."""

    def __init__(self, weights, idx, n_dims: int, c_max: int, device=None):
        self.device = resolve_device(device)
        self.weights = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        self.idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        self.n_dims = int(n_dims)
        self.c_max = int(c_max)

    def optimize(self):
        return categorical_mle(self.weights, self.idx, self.n_dims, self.c_max)

    train = optimize


# second-tier reference names -------------------------------------------------
#: SOBER/mvnorm/Phi.py:82: Phi(value, loc, cov), the MVN CDF
Phi = multivariate_normal_cdf
#: SOBER/mvnorm/integration.py:37: box probabilities P(lb < X < ub)
hyperrectangle_integration = mvn_box_prob


def LogMarginalLikelihood(theta_log, x, fobs, eta, mask=None):
    """SOBER/FBGP/_fully_Bayesian_gp.py:93, the FITBO marginal log
    likelihood of one log-space hypersample: fitbo_mll_batch of one theta."""
    return fitbo_mll_batch(theta_log[None], x, fobs, eta, mask)[0]


def lnPhi(x):
    """SOBER/_tmvn.py:426: log of the N(0, 1) upper tail, accurate in it."""
    return torch.special.log_ndtr(-_f32(x))


def lnNormalProb(a, b):
    """SOBER/_tmvn.py:402: ln P(a < Z < b) for Z ~ N(0, 1), accurate in both
    tails."""
    a, b = _f32(a), _f32(b, a.device)
    pa_hi, pb_hi = lnPhi(a), lnPhi(b)                 # upper tails (a > 0)
    hi = pa_hi + torch.log1p(-torch.exp(pb_hi - pa_hi))
    pa_lo, pb_lo = lnPhi(-a), lnPhi(-b)               # lower tails (b < 0)
    lo = pb_lo + torch.log1p(-torch.exp(pa_lo - pb_lo))
    mid = torch.log1p(-torch.exp(pa_lo) - torch.exp(pb_hi))   # straddling 0
    return torch.where(a > 0, hi, torch.where(b < 0, lo, mid))


def device_manager(device=None) -> torch.device:
    """SOBER/_settings.py's device choice: the port's default, CUDA unless
    a device is named (no fallback to the CPU)."""
    return resolve_device(device)


def dtype_manager(dtype=None):
    """The compute dtype: float32, the port's policy in place of the
    reference's float64."""
    return torch.float32 if dtype is None else dtype


def default_postprocess_script(values):
    """SOBER/_drug_modelling.py:12, the identity postprocess hook."""
    return values


def BOLFIKernel(n_dims: int | None = None, ard: bool = False, device=None):
    """SOBER/BOLFI/_gpytorch_bolfi_model.py:167-176, the RBF kernel spec
    (its Gamma hyperpriors apply at fit time through GPConfig)."""
    return make_kernel("rbf", n_dims=n_dims, ard=ard, device=device)


def rc_kernel_svd(samp, pt, s, kernel, mu=None, calc_obj=None):
    """SOBER/_rchq.py:42-48: the Nystrom basis and the reduction, (idx, w)."""
    return recombination(samp, pt, s, kernel, init_weights=mu, calc_obj=calc_obj)


def Mod_Tchernychova_Lyons(samp, U_svd, pt_nys, kernel, tm=None, mu=None,
                           calc_obj=None, DEBUG=False):
    """SOBER/_rchq.py:51-221, the recombination halving tree on a
    precomputed spectral basis: reduce the weighted pool `samp` to at most
    n + 1 points matching the n test functions U_svd @ k(pt_nys, .).
    Returns (w_star, idx_star), positive weights only. The tensors go to
    `tm`'s device when a TensorManager is given; DEBUG is ignored."""
    device = None if tm is None else tm.device
    samp = _f32(samp, device)
    u = _f32(U_svd, samp.device)
    n_pool = samp.shape[0]
    w0 = (torch.full((n_pool,), 1.0 / n_pool, device=samp.device) if mu is None
          else _f32(mu, samp.device))
    phi = u @ kernel(_f32(pt_nys, samp.device), samp)
    obj = None if calc_obj is None else -_f32(calc_obj(samp), samp.device)
    res = local_reduce(phi, w0, u.shape[0] + 1, obj=obj)
    keep = res.w > 0
    return res.w[keep], res.idx[keep]


def Tchernychova_Lyons_CAR(x, mu, device=None):
    """SOBER/_rchq.py:224-270, one Caratheodory elimination pass: reduce
    the weighted configuration (x (N, n), mu (N,)) to <= n + 1 support
    points preserving the moments [1 | x]^T mu. Returns the new weights."""
    x = _f32(x, device)
    mu = _f32(mu, x.device)
    n_pts, n_feat = x.shape
    ones = torch.ones((n_pts, 1), dtype=x.dtype, device=x.device)
    x_car = torch.cat([x, ones], dim=1)                  # with the mass column
    n_elim = max(n_pts - (n_feat + 1), 0)
    return _caratheodory(x_car, mu, n_elim, ones[:, 0])


__all__ = [
    # same-name
    "set_settings", "setting_parameters", "settings", "Sober", "BASQ",
    "SOBERUCB", "BoTorchLCBSC", "make_bolfi_model", "ExpectationPropagation",
    "InverseModel", "PI", "bernoulli_mle", "categorical_mle",
    "update_binary_prior", "update_categorical_prior",
    "update_continuous_prior", "update_mixed_prior", "recombination",
    "local_reduce", "Kernel", "EmpiricalSampler", "MixtureSampler",
    "RecombinationSampler", "GPConfig", "GPState", "build_state", "fit_gp",
    "fit_gp_padded", "predict", "predict_mean", "predictive_covariance",
    "FBGPAcquisitionFunction", "FitboGP", "FullyBayesianGP", "RBFHyperPrior",
    "ScaleVanillaGP", "quadrature_distillation", "sampling_hypers",
    "batch_tanimoto_sim", "fit_tanimoto_gp", "ScaleMmltGP", "tanimoto_gram",
    "Gaussian", "TruncatedGaussian", "Uniform", "DatasetPrior", "BinaryPrior",
    "CategoricalPrior", "MixedBinaryPrior", "MixedCategoricalPrior",
    "multivariate_normal_cdf", "TruncatedMVN",
    "WeightedKernelDensityEstimation", "SoberWrapper",
    # renamed
    "PI_BQ", "PI_FBGP", "update_gp", "train_GP", "train_GP_with_Adam",
    "train_GP_with_BFGS", "set_gp", "get_cov_cache", "TanimotoGP",
    "TanimotoKernel", "BitKernel", "BOLFIModel", "ParabolicMean",
    "ker_svd_sparsify", "KMeans",
    # adapters
    "TensorManager", "SafeTensorOperator", "Utils", "WeightsStabiliser",
    "BernoulliMLE", "CategoricalMLE",
    # second-tier helpers
    "BasePrior", "mvn_box_prob", "Phi", "hyperrectangle_integration",
    "LogMarginalLikelihood", "lnPhi", "lnNormalProb", "device_manager",
    "dtype_manager", "default_postprocess_script", "BOLFIKernel",
    "rc_kernel_svd", "Tchernychova_Lyons_CAR", "Mod_Tchernychova_Lyons",
]


def __getattr__(name):
    if name == "SoberWrapper":
        from .apps.wrapper import SoberWrapper

        return SoberWrapper
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
