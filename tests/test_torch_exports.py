"""The port's subpackages export the JAX package's names: every name of
each sober_tpu subpackage's __all__ resolves on its sober_tpu_torch twin,
as an object of the same kind; and the functions that the export brought
in are held to the JAX package's on the CPU: fitbo_mll at one theta,
FullyBayesianGP.fitbo_predict against batch_predict and JAX's, mean_value
in JAX's argument order, kmeans_resampling, the two Pallas names (the CUDA
wrappers' plain versions here) and the sampler's verbose keyword."""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.gp import exact as jx
from sober_tpu.gp import fbgp as jf
from sober_tpu.ops import kmeans_resampling as jax_kmeans_resampling
from sober_tpu.ops import rbf_gram_pallas as jax_rbf_gram_pallas
from sober_tpu.ops import tanimoto_gram_pallas as jax_tanimoto_gram_pallas
import sober_tpu_torch.core as tcore
import sober_tpu_torch.gp as tgp
import sober_tpu_torch.ops as tops
import sober_tpu_torch.utils as tutils
from sober_tpu_torch.gp import fbgp as tf
from sober_tpu_torch.interop import fbgp_from_numpy, fbgp_to_numpy

SUBPACKAGES = ("", ".core", ".gp", ".ops", ".priors", ".utils", ".apps",
               ".tasks", ".benchmarks", ".parallel")
NAMES = [(sub, name) for sub in SUBPACKAGES
         for name in importlib.import_module("sober_tpu" + sub).__all__]
t = lambda a: torch.as_tensor(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("sub,name", NAMES, ids=[f"sober_tpu{s}.{n}" for s, n in NAMES])
def test_every_jax_name_resolves(sub, name):
    """The port's subpackage has the name in its __all__, and the object is
    a class, or callable, exactly where JAX's is (never a submodule)."""
    want = getattr(importlib.import_module("sober_tpu" + sub), name)
    port = importlib.import_module("sober_tpu_torch" + sub)
    assert name in port.__all__
    got = getattr(port, name)
    assert not inspect.ismodule(got)
    assert inspect.isclass(got) == inspect.isclass(want)
    assert callable(got) == callable(want)


def test_ops_functions_shadow_their_submodules_as_in_jax():
    """ops.kmeans and ops.tanimoto_gram are the functions, as JAX's are; the
    submodules stay importable by their full path."""
    from sober_tpu_torch.ops.kernels import tanimoto_gram
    from sober_tpu_torch.ops.kmeans import kmeans

    assert tops.kmeans is kmeans and tops.tanimoto_gram is tanimoto_gram
    assert inspect.ismodule(importlib.import_module("sober_tpu_torch.ops.tanimoto_gram"))
    assert tcore.PI is importlib.import_module("sober_tpu_torch.core.pi").PI
    assert tutils.cleansing_weights is importlib.import_module(
        "sober_tpu_torch.utils.weights").cleansing_weights


# ----------------------------------------------------------------------------
# fitbo_mll and fitbo_predict
# ----------------------------------------------------------------------------

def _sweep_inputs(seed=0):
    """tests/test_torch_fbgp.py's sweep inputs: 2-d observations (24 of 32
    rows real), their targets and eta, and three hyperprior draws."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    mask = np.r_[np.ones(24), np.zeros(8)].astype(np.float32)
    fobs = (np.exp(-np.sum(x ** 2, axis=1)) * mask).astype(np.float32)
    eta = np.float32(fobs.max())
    th = np.asarray(jf.RBFHyperPrior().sample(jax.random.key(0), 3), np.float32)
    return th, x, fobs, eta, mask


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("lane", [0, 1, 2])
def test_fitbo_mll_matches_jax(masked, lane):
    """One theta's FITBO LML against JAX's fitbo_mll, within
    tests/test_torch_fbgp.py's 2e-3, and its lane of the sweep within 1e-6
    (the batched products add in another order at a batch of one)."""
    th, x, fobs, eta, mask = _sweep_inputs()
    m = mask if masked else None
    want = float(jf.fitbo_mll(jnp.asarray(th[lane]), jnp.asarray(x), jnp.asarray(fobs),
                              jnp.asarray(eta), None if m is None else jnp.asarray(m)))
    args = (t(x), t(fobs), t(eta), None if m is None else t(m))
    got = tgp.fitbo_mll(t(th[lane]), *args)
    assert got.shape == ()
    assert want != jf.EPS_LML
    np.testing.assert_allclose(float(got), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(got), float(tf.fitbo_mll_batch(t(th), *args)[lane]),
                               rtol=1e-6)


@pytest.fixture(scope="module")
def carried():
    """A JAX FullyBayesianGP on 25 points of a 1-d Gaussian likelihood
    (bucket 32), distilled to 12 chains, and its copy in the port
    (tests/test_torch_fbgp.py's fixtures)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, (25, 1)).astype(np.float32)
    y = np.exp(-0.5 * (x[:, 0] / 0.7) ** 2).astype(np.float32)
    gp = jf.FitboGP(jnp.asarray(x), jnp.asarray(y), bucket=32)
    hy, lmls = jf.sampling_hypers(gp, jf.RBFHyperPrior(), n_hypers=100,
                                  key=jax.random.key(0))
    w_qd, theta_qd = jf.quadrature_distillation(hy, lmls, n_nys=32, n_qd=12)
    jm = jf.FullyBayesianGP(gp, w_qd, theta_qd)
    return jm, fbgp_from_numpy(fbgp_to_numpy(jm), "cpu")


@pytest.mark.parametrize("chain", [0, 5, 11])
def test_fitbo_predict_is_a_row_of_batch_predict(carried, chain):
    """One chain's posterior equals its row of batch_predict, and JAX's
    fitbo_predict of the same chain within 1e-5 of its scale."""
    jm, pm = carried
    xq = np.linspace(-4, 4, 41).reshape(-1, 1).astype(np.float32)
    cache = pm._cache
    mu, var = pm.fitbo_predict(t(xq), pm.Theta_qd[chain], cache.linv[chain],
                               cache.alpha[chain])
    mu_b, var_b = pm.batch_predict(t(xq))
    assert mu.shape == var.shape == (41,)
    torch.testing.assert_close(mu, mu_b[chain], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, var_b[chain], rtol=1e-6, atol=1e-6)
    jc = jm._cache
    want = jm.fitbo_predict(jnp.asarray(xq), jm.Theta_qd[chain], jc.linv[chain],
                            jc.alpha[chain])
    for g, w in zip((mu, var), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


# ----------------------------------------------------------------------------
# mean_value, kmeans_resampling, the Pallas names, the sampler's verbose
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("mean", ["zero", "parabolic"])
def test_mean_value_takes_jax_argument_order(mean):
    """mean_value(cfg, mean_params, x) against JAX's, 1e-6 of the scale: the
    zero (constant) mean and a parabola."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (17, 3)).astype(np.float32)
    params = {} if mean == "zero" else {
        "raw_a": rng.normal(size=3).astype(np.float32),
        "b": rng.normal(size=3).astype(np.float32), "c": np.float32(0.7)}
    want = np.asarray(jx.mean_value(jx.GPConfig(mean=mean),
                                    {k: jnp.asarray(v) for k, v in params.items()},
                                    jnp.asarray(x)))
    got = tgp.mean_value(tgp.GPConfig(mean=mean), {k: t(v) for k, v in params.items()},
                         t(x)).numpy()
    assert got.shape == (17,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * max(np.abs(want).max(), 1))


def test_kmeans_resampling_matches_jax():
    """tests/test_torch_continuous.py's KMeans invariants: on separated
    clusters the centroids within 1e-5 of JAX's from the same first-K
    start; a duplicate start keeps its centroid."""
    rng = np.random.default_rng(0)
    centres = rng.uniform(-10, 10, (6, 3))
    x = np.concatenate([c + 0.3 * rng.normal(size=(80, 3)) for c in centres])
    x = x[rng.permutation(len(x))].astype(np.float32)
    want = np.asarray(jax_kmeans_resampling(jnp.asarray(x), 6))
    got = tops.kmeans_resampling(t(x), 6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    dup = np.array([[0.0, 0.0], [0.0, 0.0], [5.0, 5.0], [5.1, 5.0]], np.float32)
    np.testing.assert_array_equal(tops.kmeans_resampling(t(dup), 3, 5).numpy(),
                                  np.asarray(jax_kmeans_resampling(jnp.asarray(dup), 3, 5)))


@pytest.mark.parametrize("ard", [False, True])
def test_rbf_gram_pallas_name_matches_jax(ard):
    """ops.rbf_gram_pallas (the CUDA wrapper, its plain version on the CPU)
    against JAX's Pallas kernel in interpret mode, 1e-5 of the scale."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (40, 5)).astype(np.float32)
    y = rng.uniform(-1, 1, (24, 5)).astype(np.float32)
    ls = rng.uniform(0.5, 1.5, 5).astype(np.float32) if ard else np.float32(0.8)
    params = {"lengthscale": ls, "outputscale": np.float32(1.7)}
    want = np.asarray(jax_rbf_gram_pallas({k: jnp.asarray(v) for k, v in params.items()},
                                          jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = tops.rbf_gram_pallas({k: t(v) for k, v in params.items()}, t(x), t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 1.7)


def test_tanimoto_gram_pallas_name_matches_jax():
    """ops.tanimoto_gram_pallas on 0/1 fingerprints against JAX's Pallas
    kernel in interpret mode, 1e-6."""
    rng = np.random.default_rng(4)
    x = (rng.uniform(size=(30, 256)) < 0.1).astype(np.float32)
    y = (rng.uniform(size=(20, 256)) < 0.1).astype(np.float32)
    want = np.asarray(jax_tanimoto_gram_pallas(jnp.asarray(x), jnp.asarray(y),
                                               interpret=True))
    got = tops.tanimoto_gram_pallas(t(x), t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_sampler_takes_jax_verbose_keyword():
    """update_prior, recursive_sampling and sampling_candidates accept
    JAX's verbose= and return what they return without it."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp import fit_gp_padded
    from sober_tpu_torch.tasks import setup_branin
    from sober_tpu_torch.utils import KeyRing

    prior, f = setup_branin(device="cpu")
    x = prior.sample(KeyRing(0, device="cpu").next(), 12)
    sober = Sober(prior, fit_gp_padded(x, f(x)))
    x_cand, x_nys, w = sober.sampling_candidates(256, 16, verbose=True)
    assert x_cand.shape == (256, 2) and x_nys.shape == (16, 2) and w.shape == (256,)
    xs, ws = sober.recursive_sampling(256, 2, verbose=True)
    assert xs.shape == (256, 2) and ws.shape == (256,)
    sober.update_prior(x_cand, w, verbose=True)
    assert type(sober.prior).__name__ == "WeightedKernelDensityEstimation"
