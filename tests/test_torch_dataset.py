"""The port's dataset-domain screening iteration against the JAX package's on
the CPU: the resampling utilities, the dataset prior, pruning,
recombination with the weighted predictive covariance, Sober.next_batch
from a carried GP state, and the fingerprint featurizer. Random stages are
compared by distribution, since the two packages' random streams differ."""
import csv
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu import Sober as JaxSober
from sober_tpu.core import rchq as jr
from sober_tpu.core.rckernel import RecombinationKernel as JaxRCKernel
from sober_tpu.core.sampler import EmpiricalSampler as JaxSampler
from sober_tpu.gp.tanimoto import fit_tanimoto_gp as jax_fit_tanimoto_gp
from sober_tpu.priors.dataset import DatasetPrior as JaxDatasetPrior
from sober_tpu.tasks import drug as jdrug
from sober_tpu.utils import weights as jw
from sober_tpu_torch import DatasetPrior, Sober
from sober_tpu_torch.core import rchq as tr
from sober_tpu_torch.core.fused_sampling import adaptive_pruning
from sober_tpu_torch.core.rckernel import RecombinationKernel
from sober_tpu_torch.core.sampler import PRUNE_THRESH
from sober_tpu_torch.interop import (dataset_prior_from_numpy,
                                     gp_state_from_numpy, gp_state_to_numpy)
from sober_tpu_torch.tasks import drug as tdrug
from sober_tpu_torch.utils import weights as tw
from sober_tpu_torch.utils.linalg import symmetrize
from sober_tpu_torch.utils.prng import KeyRing

N_POOL, N_BITS, N_OBS, N_REC, N_NYS, BATCH = 3000, 256, 64, 512, 64, 16


def _screening_problem(seed=0):
    """bench.py:bench_dataset's data at a small size: a pool of fingerprints,
    a smooth target, and the first N_OBS rows of a seeded permutation
    observed (and so no longer available)."""
    rng = np.random.default_rng(seed)
    feats = (rng.random((N_POOL, N_BITS)) < 0.05).astype(np.float32)
    w = rng.normal(size=N_BITS).astype(np.float32)
    targets = (feats @ w / np.sqrt(feats.sum(1) + 1.0)
               + 0.1 * rng.normal(size=N_POOL)).astype(np.float32)
    obs = rng.permutation(N_POOL)[:N_OBS]
    available = np.ones(N_POOL, bool)
    available[obs] = False
    return feats, targets, obs, available


def _moment_error(kernel, x_cand, x_nys, w_pool, idx, w):
    """Moment error of a batch on the normalized feature strip, as the
    port's recombination builds it."""
    k_nys = symmetrize(torch.nan_to_num(kernel(x_nys, x_nys)))
    u = tr.nystrom_basis(k_nys, BATCH - 1)
    phi = u @ kernel(x_nys, x_cand)
    phi = phi / phi.abs().max()
    return float((phi[:, idx] @ w - phi @ (w_pool / w_pool.sum())).abs().max())


def _check_batch(idx, w, n, available=None):
    idx = np.asarray(idx)
    assert idx.shape == (BATCH,) and len(set(idx.tolist())) == BATCH
    assert idx.min() >= 0 and idx.max() < n
    if available is not None:
        assert available[idx].all()
    if w is not None:
        w = np.asarray(w)
        assert (w >= 0).all() and abs(w.sum() - 1.0) < 1e-4


# ----------------------------------------------------------------------------
# weights and random streams
# ----------------------------------------------------------------------------

def test_keyring_generators_are_independent_and_reproducible():
    a, b = KeyRing(7, device="cpu"), KeyRing(7, device="cpu")
    ga, gb = a.next(), b.next()
    assert torch.equal(torch.rand(5, generator=ga), torch.rand(5, generator=gb))
    g1, g2 = a.split(2)
    assert not torch.equal(torch.rand(5, generator=g1), torch.rand(5, generator=g2))
    assert a.next().device == torch.device("cpu")


@pytest.mark.parametrize("case", ["plain", "few_unique", "zero"])
def test_check_weights_matches_jax(case):
    w = np.random.default_rng(0).uniform(0, 1, 40).astype(np.float32)
    if case == "few_unique":
        w = np.repeat(w[:3], [10, 10, 20])
    elif case == "zero":
        w[:] = 0.0
    assert bool(tw.check_weights(torch.as_tensor(w))) == bool(
        jw.check_weights(jnp.asarray(w)))


def _inclusion(draws, n):
    freq = np.zeros(n)
    for idx in draws:
        freq[np.asarray(idx)] += 1
    return freq / len(draws)


@pytest.mark.parametrize("kind", ["weighted", "deweighted"])
def test_resampling_inclusion_frequencies_match_jax(kind):
    """Over 3000 draws of 5 from 20 weights, each index's inclusion
    frequency agrees with JAX's to 0.05 (binomial noise of the difference
    is at most 0.013), and every draw is 5 distinct indices."""
    n_draw, n, k = 3000, 20, 5
    w = np.random.default_rng(1).uniform(0.05, 1.0, n).astype(np.float32)
    w /= w.sum()
    tfn = getattr(tw, f"{kind}_resampling")
    jfn = getattr(jw, f"{kind}_resampling")
    ring = KeyRing(0, device="cpu")
    wt = torch.as_tensor(w)
    mine = [tfn(ring.next(), wt, k).numpy() for _ in range(n_draw)]
    keys = jax.random.split(jax.random.key(0), n_draw)
    theirs = np.asarray(jax.vmap(lambda kk: jfn(kk, jnp.asarray(w), k))(keys))
    assert all(len(set(d.tolist())) == k for d in mine)
    assert np.abs(_inclusion(mine, n) - _inclusion(theirs, n)).max() < 0.05


def test_weighted_resampling_takes_positive_weights_first():
    """Zero weights come in only when fewer than n weights are positive;
    then, as in JAX, they tie and the lower indices are taken."""
    w = torch.zeros(12)
    w[[2, 7, 9]] = torch.tensor([0.5, 0.3, 0.2])
    ring = KeyRing(3, device="cpu")
    for _ in range(20):
        idx = tw.weighted_resampling(ring.next(), w, 5)
        assert set(idx[:3].tolist()) == {2, 7, 9}
        assert idx[3:].tolist() == [0, 1]
    want = np.asarray(jw.weighted_resampling(jax.random.key(0),
                                             jnp.asarray(w.numpy()), 5))
    assert want[3:].tolist() == [0, 1]


# ----------------------------------------------------------------------------
# the dataset prior and pruning
# ----------------------------------------------------------------------------

def test_dataset_prior_consumption_matches_jax():
    """sample consumes what it draws, sample_feature does not, query
    returns the targets and consumes; pdf is uniform over what is left.
    The same sequence of queries leaves the same pool in both packages."""
    feats, targets, _, _ = _screening_problem()
    prior = DatasetPrior(feats, targets, device="cpu")
    jprior = JaxDatasetPrior(feats, targets)
    ring = KeyRing(0, device="cpu")
    x, y = prior.sample(ring.next(), 10)
    assert x.shape == (10, N_BITS) and prior.n_available == N_POOL - 10
    chosen = np.flatnonzero(~prior.available.numpy())
    jprior.remove_sampled_index(chosen)
    np.testing.assert_array_equal(np.sort(y.numpy()), np.sort(targets[chosen]))
    idx, xf = prior.sample_feature(ring.next(), 7)
    assert prior.n_available == N_POOL - 10
    assert prior.available[idx].all() and torch.equal(xf, prior.features[idx])
    q = [3, 5, 11]
    np.testing.assert_array_equal(prior.query(torch.as_tensor(q)).numpy(),
                                  np.asarray(jprior.query(np.asarray(q))))
    np.testing.assert_array_equal(prior.available.numpy(), jprior.available)
    assert prior.n_available == jprior.n_available
    np.testing.assert_allclose(prior.pdf(x).numpy(),
                               np.asarray(jprior.pdf(jnp.asarray(x.numpy()))))
    assert torch.allclose(prior.logpdf(x), torch.log(prior.pdf(x)))
    carried = dataset_prior_from_numpy(feats, targets, jprior.available,
                                       device="cpu")
    np.testing.assert_array_equal(carried.available.numpy(), jprior.available)
    # a draw larger than the pool gives the whole pool
    small = DatasetPrior(feats[:4], targets[:4], device="cpu")
    assert sorted(small.sample(ring.next(), 9)[1].tolist()) == sorted(
        targets[:4].tolist())
    assert small.n_available == 0


@pytest.mark.parametrize("ties", [False, True])
def test_adaptive_pruning_matches_jax(ties):
    """The same top-k indices in the same order (ties to the lower index)
    and the same keep mask."""
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 0.01, 400).astype(np.float32)
    if ties:
        w[rng.choice(400, 150, replace=False)] = 0.0
        w[rng.choice(400, 30, replace=False)] = 5e-3
    idx_t, keep_t = adaptive_pruning(torch.as_tensor(w), 200, 40, PRUNE_THRESH)
    idx_j, keep_j = JaxSampler.adaptive_pruning(None, jnp.asarray(w), 200, 40)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


# ----------------------------------------------------------------------------
# recombination and the whole iteration
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """The screening problem with a JAX-fitted Tanimoto GP on the observed
    rows, carried across to the port."""
    feats, targets, obs, available = _screening_problem()
    js = jax_fit_tanimoto_gp(jnp.asarray(feats[obs]), jnp.asarray(targets[obs]))
    ts = gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")
    return feats, targets, available, js, ts


def test_recombination_weighted_covariance_matches_jax(carried):
    """Identical pool, Nystrom subset and weights through both packages'
    recombination with the weighted predictive covariance: both batches
    meet the invariants and match the moments to 5e-3 on the port's
    features; their supports overlap in at least half the points (low-bit
    differences rotate supports between equally valid answers, ROADMAP.md
    queue 3)."""
    feats, _, _, js, ts = carried
    rng = np.random.default_rng(5)
    pool = feats[rng.choice(N_POOL, N_REC, replace=False)]
    w_pool = rng.uniform(0, 1, N_REC).astype(np.float32)
    w_pool /= w_pool.sum()
    x_nys = pool[:N_NYS]
    jkern = JaxRCKernel(js, "weighted_predictive_covariance")
    tkern = RecombinationKernel(ts, "weighted_predictive_covariance")
    jidx, jwr = jr.recombination(jnp.asarray(pool), jnp.asarray(x_nys), BATCH,
                                 jkern, init_weights=jnp.asarray(w_pool))
    tp, tn, twp = map(torch.as_tensor, (pool, x_nys, w_pool))
    idx, wr = tr.recombination(tp, tn, BATCH, tkern, init_weights=twp)
    _check_batch(idx, wr, N_REC)
    _check_batch(jidx, jwr, N_REC)
    for i, w in ((idx, wr), (torch.as_tensor(np.array(jidx)),
                             torch.as_tensor(np.array(jwr)))):
        assert _moment_error(tkern, tp, tn, twp, i, w) < 5e-3
    support = set(idx[wr > 0].tolist())
    jsupport = set(np.asarray(jidx)[np.asarray(jwr) > 0].tolist())
    assert len(support & jsupport) >= len(jsupport) // 2


def test_next_batch_matches_jax(carried):
    """Sober.next_batch from the same carried state and pool: pi weights
    over the pool to 1e-5, the same pruned pool (the data is tie-free),
    and batches that meet the invariants and the moment bound."""
    feats, targets, available, js, ts = carried
    jprior = JaxDatasetPrior(feats, targets)
    jprior.remove_sampled_index(np.flatnonzero(~available))
    jsober = JaxSober(jprior, js, kernel_type="weighted_predictive_covariance")
    prior = dataset_prior_from_numpy(feats, targets, available, device="cpu")
    sober = Sober(prior, ts, kernel_type="weighted_predictive_covariance")

    w_t = torch.where(prior.available, sober.pi(prior.features), 0.0).numpy()
    w_j = np.where(available, np.asarray(jsober.pi(jnp.asarray(feats))), 0.0)
    err = np.abs(w_t - w_j).max()
    assert err <= 1e-5
    # tie-free: the cut's gap exceeds what the two packages differ by
    top = np.sort(w_j)[::-1]
    assert top[N_REC - 1] - top[N_REC] > 2 * err

    idx_s, x_cand, x_nys, w = sober.sampling_datasets(N_REC, N_NYS)
    jidx_s = np.asarray(jsober.sampling_datasets(N_REC, N_NYS)[0])
    assert set(idx_s.tolist()) == set(jidx_s.tolist())
    assert torch.equal(x_cand, prior.features[idx_s])
    idx, wr = sober.sampling_recombination(x_cand, x_nys, w, BATCH)
    _check_batch(idx, wr, N_REC)
    assert _moment_error(sober.kernel, x_cand, x_nys, w, idx, wr) < 5e-3

    idx_g, x_batch = sober.next_batch(N_REC, N_NYS, BATCH)
    _check_batch(idx_g, None, N_POOL, available)
    assert torch.equal(x_batch, prior.features[idx_g])
    assert sober.last_path == "fused" and int(sober.last_npos) > 0
    jidx_g, jx_batch = jsober.next_batch(N_REC, N_NYS, BATCH)
    _check_batch(jidx_g, None, N_POOL, available)
    w_b, _ = sober.next_batch(N_REC, N_NYS, BATCH, return_weights=True)
    assert (w_b >= 0).all() and abs(float(w_b.sum()) - 1.0) < 1e-4


def test_sober_rejects_what_is_not_ported(carried):
    """What is still to port raises and names its ROADMAP.md item: the
    TruncatedGaussian proposal (item 13); a domain label that no package
    has raises ValueError. step_fbgp (item 12) is ported: on a dataset
    domain it refits an FBGP on the observed rows and returns a legal
    screening batch."""
    from sober_tpu.priors.continuous import TruncatedGaussian
    from sober_tpu_torch.gp.fbgp import FullyBayesianGP, RBFHyperPrior

    feats, targets, available, _, ts = carried
    prior = dataset_prior_from_numpy(feats, targets, available, device="cpu")
    sober = Sober(prior, ts)
    obs = np.flatnonzero(~available)
    idx_g, x_batch = sober.step_fbgp(
        feats[obs], targets[obs], RBFHyperPrior(device="cpu"), N_REC, N_NYS, BATCH,
        n_hypers=20, n_nys_qd=16, n_qd=8, bucket=N_OBS)
    _check_batch(idx_g, None, N_POOL, available)
    assert torch.equal(x_batch, prior.features[idx_g])
    assert sober.fbgp and isinstance(sober.pi.model, FullyBayesianGP)

    class Ordinal:
        type, device = "ordinal", torch.device("cpu")

    with pytest.raises(ValueError, match="ordinal"):
        Sober(Ordinal(), ts)
    tgauss = TruncatedGaussian(jnp.zeros(2), jnp.eye(2),
                               jnp.asarray([[-1.0, -1.0], [1.0, 1.0]]))
    with pytest.raises(NotImplementedError, match="item 13"):
        Sober(tgauss, ts)
    with pytest.raises(ValueError):
        sober.sampling_datasets(N_NYS, N_NYS)


def test_should_reset_prior_matches_jax(carried):
    """The host-side stagnation heuristic on the same target histories."""
    feats, targets, available, js, ts = carried
    jprior = JaxDatasetPrior(feats, targets)
    jsober = JaxSober(jprior, js)
    sober = Sober(dataset_prior_from_numpy(feats, targets, device="cpu"), ts)
    rng = np.random.default_rng(9)
    for n_extra, recycle in itertools.product((0, 16, 40, 90), (True, False)):
        hist = rng.normal(size=N_OBS + n_extra)
        assert sober.should_reset_prior(16, recycle, targets=hist) == \
            jsober.should_reset_prior(16, recycle, targets=hist)
    assert sober.should_reset_prior(16, True) == jsober.should_reset_prior(16, True)


# ----------------------------------------------------------------------------
# the featurizer
# ----------------------------------------------------------------------------

def test_featurizer_matches_jax():
    """The first 300 molecules of QM9_dipole.csv give bit-identical
    fingerprints in both packages."""
    with open(tdrug.DATA_DIR / "QM9_dipole.csv", encoding="utf-8-sig") as f:
        smiles = [row["smiles"] for row in itertools.islice(csv.DictReader(f), 300)]
    got = tdrug.featurise_smiles(smiles)
    want = jdrug.featurise_smiles(smiles)
    assert got.shape == (300, 2048) and got.sum() > 0
    np.testing.assert_array_equal(got, want)
