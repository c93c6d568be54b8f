"""The port's discrete and mixed Sober loop against the JAX package's on the
CPU: the candidate pipeline of each family (Bernoulli, categorical, and a
Uniform block that becomes a WKDE beside either) on its healthy,
degenerate and totally degenerate branches, category indices through the
refill, next_batch and step per label, the proposal reset, and the mixed
Ackley and Rosenbrock loops' improvement bars. Both packages start from one
carried proposal and the same pi; their random streams differ, so pools
and updated proposals are compared by distribution."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core import fused_sampling as jfs
from sober_tpu.core.sampler import EmpiricalSampler as JaxSampler
from sober_tpu.priors import discrete as jd
from sober_tpu_torch import Sober
from sober_tpu_torch.core.sampler import EmpiricalSampler
from sober_tpu_torch.gp.exact import GPConfig, fit_gp, fit_gp_padded
from sober_tpu_torch.interop import (discrete_prior_from_numpy,
                                     discrete_prior_to_numpy)
from sober_tpu_torch.priors import (BinaryPrior, CategoricalPrior, Uniform,
                                    WeightedKernelDensityEstimation)
from sober_tpu_torch.tasks.synthetic import setup_ackley, setup_rosenbrock
from sober_tpu_torch.utils.prng import KeyRing

N_REC, N_NYS, BATCH = 2048, 64, 8
# a short fit where the test checks the acquisition, not the model
FIT = GPConfig(fit_iters=30)
CATS = [[0.0, 1.0, 2.0], [10.0, 20.0], [-1.0, 0.0, 1.0, 2.5]]
BOX = np.array([[-1.0, -1.0], [1.0, 1.0]], np.float32)
# the target of pi's bump, per block: a binary and a categorical row
T_BIN = np.array([1, 0, 1, 1, 0, 0], np.float32)
T_CAT = np.array([2.0, 10.0, 1.0], np.float32)
T_CONT = np.array([0.3, -0.2], np.float32)


def _jax_prior(label):
    return {"binary": lambda: jd.BinaryPrior(6),
            "categorical": lambda: jd.CategoricalPrior(CATS),
            "mixedbinary": lambda: jd.MixedBinaryPrior(2, 6, BOX, seed=3),
            "mixedcategorical": lambda: jd.MixedCategoricalPrior(2, 3, CATS, BOX,
                                                                 seed=3)}[label]()


def _target(label):
    disc = T_CAT if label.endswith("categorical") else T_BIN
    return np.concatenate([T_CONT, disc]) if label.startswith("mixed") else disc


def _bump_pi(tree, x):
    """pi = exp(-|x - target|^2 / 2): a bump at the target row."""
    target, = tree
    return jnp.exp(-0.5 * jnp.sum((x - target[None]) ** 2, axis=1))


def _port_bump(target):
    t = torch.as_tensor(target)
    return lambda x: torch.exp(-0.5 * torch.sum((x - t[None]) ** 2, dim=1))


def _keys(seed=0):
    return [jax.random.key(seed + i) for i in range(4)]


def _jax_candidates(label, jprior, pi_tree, pi_apply):
    """JAX's fused candidate program of the label from `jprior`: (x, w, the
    updated discrete block's probs, did)."""
    if label == "binary":
        x, _, w, probs = jfs.fused_candidates_binary(
            pi_tree, jprior.probs, *_keys(), n_rec=N_REC, n_nys=N_NYS, thresh=5,
            pi_apply=pi_apply)
        return x, w, probs, True
    disc = jprior if label == "categorical" else jprior.prior_disc
    cat = label.endswith("categorical")
    disc_tree = (disc.weights, disc.valid_mask, disc.value_table) if cat else disc.probs
    if label == "categorical":
        spec = jfs.DomainSpec(label, True, 0, disc.n_dims, disc.c_max)
        cont, sob, entry = (), (jnp.zeros((), jnp.uint32), 0, False), "none"
    else:
        spec = jfs.DomainSpec(label, True, 2, disc.n_dims, disc.c_max if cat else 0)
        cont, entry = jprior.bounds, "uniform"
        sob = (jprior.prior_cont._sobol, jprior.prior_cont._offset, True)
    x, _, w, (_, dout), did = jfs.fused_candidates_discrete(
        pi_tree, cont, disc_tree, sob[0], sob[1], *_keys(), spec=spec, n_rec=N_REC,
        n_nys=N_NYS, thresh=5, n_kde=N_REC, qmc=sob[2], entry=entry, pi_apply=pi_apply)
    if cat:
        new = jd.CategoricalPrior(CATS)
        new.weights = dout[0]
        return x, w, new.probs, bool(did)
    return x, w, dout, bool(did)


def _candidates(label, prior, pi, seed=0):
    s = EmpiricalSampler(prior, pi, None, label=label, seed=seed)
    x, x_nys, w = s.sampling_candidates(N_REC, N_NYS)
    return SimpleNamespace(x=x, x_nys=x_nys, w=w, prior=s.prior, reads=s.last_reads,
                           sampler=s)


def _disc(prior):
    return getattr(prior, "prior_disc", prior)


def _probs(prior):
    return np.asarray(_disc(prior).probs)


def _legal(x, label):
    """Every discrete value is a legal one of its dimension."""
    x = np.asarray(x)
    xd = x[:, 2:] if label.startswith("mixed") else x
    if label.endswith("binary"):
        return bool(((xd == 0) | (xd == 1)).all())
    return all(np.isin(xd[:, d], np.asarray(c, np.float32)).all()
               for d, c in enumerate(CATS))


def _weighted_mean(x, w):
    return np.asarray(w, np.float64) @ np.asarray(x, np.float64)


# ----------------------------------------------------------------------------
# the candidate pipeline of each family
# ----------------------------------------------------------------------------

LABELS = ["binary", "categorical", "mixedbinary", "mixedcategorical"]


@pytest.mark.parametrize("label", LABELS)
def test_pipeline_matches_jax(label):
    """From one carried proposal and the same pi: the healthy branch
    updates the proposal in both packages; the updated Bernoulli or
    categorical probabilities agree to 0.1 (resampling noise of weighted
    frequencies over pools of 2048 draws, the JAX package's own bar between
    its fused and staged pools, tests/test_fused_sampling.py:366-389), and
    so do the pools' weighted means; a mixed prior's Uniform block becomes
    a WKDE bounded by the box; pools are legal; two host reads."""
    jprior = _jax_prior(label)
    target = _target(label)
    x, w, jprobs, did = _jax_candidates(label, jprior, (jnp.asarray(target),), _bump_pi)
    prior = discrete_prior_from_numpy(discrete_prior_to_numpy(jprior), "cpu")
    got = _candidates(label, prior, _port_bump(target))
    assert did and got.reads == 2
    assert got.x.shape == (N_REC, len(target)) and got.x_nys.shape == (N_NYS, len(target))
    assert got.x.is_contiguous()                   # the RBF kernel's operand
    assert bool((got.w >= 0).all()) and abs(float(got.w.sum()) - 1) < 1e-4
    assert _legal(got.x, label) and _legal(got.x_nys, label) and _legal(x, label)
    assert np.abs(_probs(got.prior) - np.asarray(jprobs)).max() < 0.1
    assert np.abs(_weighted_mean(got.x, got.w) - _weighted_mean(x, w)).max() < 0.1
    # the update moved the discrete block towards the target
    assert not np.allclose(_probs(got.prior), _probs(prior))
    if label.startswith("mixed"):
        cont = got.prior.prior_cont
        assert isinstance(cont, WeightedKernelDensityEstimation)
        assert torch.equal(cont.bounds, torch.as_tensor(BOX))
        assert isinstance(prior.prior_cont, Uniform) and prior.prior_cont._offset == N_REC
        assert bool(((got.x[:, :2] >= -1) & (got.x[:, :2] <= 1)).all())
    else:
        assert type(got.prior) is type(prior)


def _indicator_pi(tree, x):
    """pi = 1 on the target row, 0 elsewhere."""
    target, = tree
    return jnp.all(x == target[None], axis=1).astype(jnp.float32)


def test_degenerate_branch_matches_jax():
    """pi is 1 on one of 64 binary rows: the first draw has two distinct
    weights, so the old proposal is refilled, and the MLE of the accepted
    rows (all the target) is the target clamped to [1e-3, 1 - 1e-3] in both
    packages, to 1e-6. The second pool then holds the target with
    probability 0.994."""
    x, w, jprobs, _ = _jax_candidates("binary", jd.BinaryPrior(6),
                                      (jnp.asarray(T_BIN),), _indicator_pi)
    t = torch.as_tensor(T_BIN)
    pi = lambda x: torch.all(x == t[None], dim=1).to(torch.float32)
    got = _candidates("binary", BinaryPrior(6, device="cpu"), pi)
    want = np.clip(T_BIN, 1e-3, 1 - 1e-3)
    np.testing.assert_allclose(_probs(got.prior), want, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jprobs), want, atol=1e-6)
    assert got.reads == 3                          # the branch and two counts
    assert float((got.w > 0).float().mean()) > 0.9


def test_category_indices_ride_the_refill():
    """A categorical pool refilled over several rounds: every row's values
    are its index rows' table entries, filled rows included, so the MLE
    reads the indices of the values pi weighted (the JAX package's staged
    recursive_sampling fills both, sober_tpu/core/sampler.py:265-268)."""
    prior = CategoricalPrior(CATS, device="cpu")
    t = torch.as_tensor(T_CAT)
    pi = lambda x: torch.all(x == t[None], dim=1).to(torch.float32)
    s = EmpiricalSampler(prior, pi, None, label="categorical", seed=3)
    x, xi, w = s.recursive_sampling(256, 6, need=200)
    assert s.last_reads == 6 and not s.flag        # 5 refill rounds, all read
    table = prior.value_table
    assert torch.equal(x, table[torch.arange(3)[None], xi.long()])
    assert int((w > 0).sum()) > 40                 # ~1/24 of each round kept
    out = s.sampling_candidates(N_REC, N_NYS)
    assert _legal(out[0], "categorical")
    # the accepted rows are all the target: masses 1 there, 1e-3 elsewhere
    n_cats = np.array([len(c) for c in CATS])
    np.testing.assert_allclose(np.asarray(s.prior.probs)[[0, 1, 2], [2, 0, 2]],
                               1.0 / (1.0 + 1e-3 * (n_cats - 1)), atol=1e-6)


@pytest.mark.parametrize("label", ["binary", "mixedcategorical"])
def test_total_failure_keeps_the_proposal(label):
    """A pool with no positive weight after every refill round (cleansed
    weights never are, so the draw is replaced): the uniform-weight pool and
    its first n_nys rows come back and the proposal is the same object."""
    prior = discrete_prior_from_numpy(discrete_prior_to_numpy(_jax_prior(label)), "cpu")
    s = EmpiricalSampler(prior, lambda x: torch.ones(x.shape[0]), None, label=label)
    inner = s._draw
    s._draw = lambda n, redraw=False: (inner(n, redraw)[0], torch.zeros(n))
    x, x_nys, w = s.sampling_candidates(512, 32)
    assert s.flag and s.prior is prior
    assert torch.equal(x_nys, x[:32]) and x.shape == (512, prior.n_dims)
    assert torch.allclose(w, torch.full((512,), 1 / 512))
    assert s.last_reads == 1 + 5                   # the branch, five counts


# ----------------------------------------------------------------------------
# next_batch and step per label
# ----------------------------------------------------------------------------

def _problem(label, n=30, seed=0):
    """A port prior, n observations drawn from it, their objective (pi's
    bump), and a GP fit on them."""
    prior = discrete_prior_from_numpy(discrete_prior_to_numpy(_jax_prior(label)), "cpu")
    x = prior.sample(KeyRing(seed, device="cpu").next(), n)
    y = _port_bump(_target(label))(x)
    return prior, x, y


def _check_batch(w, xb, label, d):
    assert xb.shape == (BATCH, d) and bool(torch.isfinite(xb).all())
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-4
    assert _legal(xb, label)
    if label.startswith("mixed"):          # a WKDE clips onto the closed box
        assert bool(((xb[:, :2] >= -1) & (xb[:, :2] <= 1)).all())


@pytest.mark.parametrize("label", LABELS)
def test_next_batch_per_label(label):
    """Two next_batch calls: legal batches with weights >= 0 summing to 1,
    the proposal advanced (a mixed prior's continuous block a WKDE), the
    stage timings, and no polish off the continuous label."""
    prior, x, y = _problem(label)
    sober = Sober(prior, fit_gp(x, y, FIT), seed=1)
    p0 = _probs(prior)
    for _ in range(2):
        w, xb = sober.next_batch(N_REC, N_NYS, BATCH, return_weights=True)
        _check_batch(w, xb, label, prior.n_dims)
    assert not np.allclose(_probs(sober.prior), p0)
    if label.startswith("mixed"):
        assert isinstance(sober.prior.prior_cont, WeightedKernelDensityEstimation)
    assert set(sober.last_timings) == {"candidates", "recombination", "total"}
    assert sober.last_path == "fused" and int(sober.last_npos) > 0
    xb = sober.next_batch(N_REC, N_NYS, BATCH, polish=True)
    assert "polish" not in sober.last_timings and _legal(xb, label)


@pytest.mark.parametrize("label", LABELS)
def test_step_per_label(label):
    """step refits a bucket-padded GP on the observations and acquires a
    legal batch; a second step with a warm start on the grown data."""
    prior, x, y = _problem(label, seed=2)
    sober = Sober(prior, fit_gp(x, y, FIT), seed=4)
    xb = sober.step(x, y, N_REC, N_NYS, BATCH, cfg=FIT)
    assert xb.shape == (BATCH, prior.n_dims) and _legal(xb, label)
    assert sober.pi.model.x.shape[0] == 128 and int(sober.pi.model.mask.sum()) == 30
    x1 = torch.cat([x, xb])
    w, xb = sober.step(x1, _port_bump(_target(label))(x1), N_REC, N_NYS, BATCH,
                       cfg=FIT, warm_start=True, return_weights=True)
    _check_batch(w, xb, label, prior.n_dims)
    assert int(sober.pi.model.mask.sum()) == 38


# ----------------------------------------------------------------------------
# the proposal reset
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("label", LABELS)
def test_reset_restores_a_fresh_prior(label):
    """After the proposal moved, a reset rebuilds the label's original
    prior as JAX's initialise_prior does: 0.5 Bernoulli or categorical
    masses, and a mixed prior's Uniform block from Sobol offset 0 (the same
    points as JAX's, bit for bit)."""
    prior, x, y = _problem(label)
    sober = Sober(prior, fit_gp(x, y, FIT), seed=1)
    sober.next_batch(1024, 32, BATCH)
    sober._mark_reset()
    assert sober.last_reset and sober.reset_count == 1
    js = JaxSampler(_jax_prior(label), None, None, label=label)
    js.initialise_prior()
    got, want = sober.prior, js.prior
    assert type(got).__name__ == type(want).__name__ and got is not prior
    assert np.array_equal(_probs(got), np.asarray(_disc(want).probs))
    if label.startswith("mixed"):
        assert isinstance(got.prior_cont, Uniform) and got.prior_cont._offset == 0
        a = got.sample(torch.Generator(), 64).numpy()
        b = np.asarray(want.sample(jax.random.key(0), 64))
        assert np.array_equal(a[:, :2].view(np.uint32), b[:, :2].view(np.uint32))


# ----------------------------------------------------------------------------
# the mixed loops' bars
# ----------------------------------------------------------------------------

def test_ackley_mixed_loop_improves():
    """tests/test_sober_e2e.py:76-95 on the port: 50 points of the mixed
    Ackley (3 continuous, 20 binary), five next_batch(2048, 64, 24); the
    binary block stays binary and the best value rises by more than 0.4."""
    prior, f = setup_ackley(device="cpu")
    x = prior.sample(KeyRing(1, device="cpu").next(), 50)
    y = f(x)
    best0 = float(y.max())
    sober = Sober(prior, fit_gp(x, y))
    for _ in range(5):
        sober.update_model(fit_gp(x, y))
        xb = sober.next_batch(2048, 64, 24)
        assert xb.shape == (24, 23)
        assert set(np.unique(xb[:, 3:].numpy())) <= {0.0, 1.0}
        x, y = torch.cat([x, xb]), torch.cat([y, f(xb)])
    assert isinstance(sober.prior.prior_cont, WeightedKernelDensityEstimation)
    assert float(y.max()) > best0 + 0.4


@pytest.mark.parametrize("seed", [0, 1])
def test_rosenbrock_mixed_loop_improves(seed):
    """tests/test_sober_e2e.py:188-209 on the port: 40 points of the mixed
    Rosenbrock (1 continuous, 6 categorical of 4 values), three batches of
    next_batch(512, 64, 16) through fit_gp_padded; only the four category
    values appear and the best value strictly rises."""
    prior, f = setup_rosenbrock(device="cpu")
    x = prior.sample(KeyRing(seed, device="cpu").next(), 40)
    y = f(x)
    best0 = float(y.max())
    sober = Sober(prior, fit_gp_padded(x, y), seed=seed)
    for _ in range(3):
        sober.update_model(fit_gp_padded(x, y))
        xb = sober.next_batch(512, 64, 16)
        assert xb.shape == (16, 7)
        assert set(np.unique(xb[:, 1:].numpy())) <= {-2.0, -1.0, 1.0, 2.0}
        x, y = torch.cat([x, xb]), torch.cat([y, f(xb)])
    assert float(y.max()) > best0
