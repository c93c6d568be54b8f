"""The port's discrete and mixed priors, their MLE updates and the discrete
tasks against the JAX package's on the CPU, from the same numpy inputs.
Deterministic functions are held tightly (tolerances stated at each
check); draws are held by distribution, and a mixed prior's Sobol block bit
for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core import prior_update as jpu
from sober_tpu.priors import discrete as jd
from sober_tpu.tasks import discrete as jt
from sober_tpu.tasks import synthetic as jsyn
from sober_tpu_torch.core import prior_update as tpu
from sober_tpu_torch.interop import (discrete_prior_from_numpy,
                                     discrete_prior_to_numpy)
from sober_tpu_torch.priors import (BinaryPrior, CategoricalPrior,
                                    MixedBinaryPrior, MixedCategoricalPrior,
                                    Uniform, WeightedKernelDensityEstimation)
from sober_tpu_torch.tasks import discrete as tt
from sober_tpu_torch.tasks import synthetic as tsyn

CATS = [[0.0, 1.0, 2.0], [10.0, 20.0], [-1.0, 0.0, 1.0, 2.5]]
BOX = np.array([[-1.0, -2.0], [1.0, 0.5]], np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(a):
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _binary_rows(n, d, seed):
    return (np.random.default_rng(seed).random((n, d)) < 0.4).astype(np.float32)


def _category_indices(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, len(c), n) for c in CATS], axis=1)


def _category_values(idx):
    return np.stack([np.asarray(c, np.float32)[idx[:, i]]
                     for i, c in enumerate(CATS)], axis=1)


# ----------------------------------------------------------------------------
# the priors' deterministic functions
# ----------------------------------------------------------------------------

def test_binary_logpdf_and_pdf_match_jax():
    """At the same probs (the MLE's clamp edges among them) and rows: the
    log density to 1e-5 (float32 sums of up to 6 logs near -20, in another
    order), so the density to 1e-5 relative."""
    probs = np.array([0.5, 1e-3, 1 - 1e-3, 0.3, 0.9, 0.07], np.float32)
    x = _binary_rows(200, 6, 0)
    j, t = jd.BinaryPrior(6, probs=probs), BinaryPrior(6, probs=probs, device="cpu")
    np.testing.assert_allclose(_np(t.logpdf(_t(x))), _np(j.logpdf(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(_np(t.pdf(_t(x))), _np(j.pdf(jnp.asarray(x))), rtol=1e-5)
    assert t.type == "binary" and t.n_dims == 6


def test_binary_density_underflows_as_jax_does():
    """24 dimensions at the MLE's clamp: exp(sum log p) is 0 in float32 in
    both packages (no log-space repair)."""
    probs = np.full(24, 1e-3, np.float32)
    x = np.ones((3, 24), np.float32)
    t = BinaryPrior(24, probs=probs, device="cpu")
    assert np.array_equal(_np(t.pdf(_t(x))), _np(jd.BinaryPrior(24, probs).pdf(x)))
    assert float(t.pdf(_t(x)).max()) == 0.0


def test_categorical_tables_and_densities_match_jax():
    """The padded value table, mask, masses and probs exactly; the nearest-
    category lookup exactly (halfway values included); logpdf_indices and
    logpdf to 1e-6."""
    weights = [[0.2, 0.5, 0.3], [1.0, 3.0], [0.1, 0.2, 0.3, 0.4]]
    j = jd.CategoricalPrior(CATS, weights=weights)
    t = CategoricalPrior(CATS, weights=weights, device="cpu")
    for name in ("value_table", "valid_mask", "weights", "n_categories"):
        assert np.array_equal(_np(getattr(t, name)), _np(getattr(j, name))), name
    assert t.c_max == j.c_max == 4
    np.testing.assert_allclose(_np(t.probs), _np(j.probs), rtol=1e-6)
    idx = _category_indices(300, 1)
    np.testing.assert_allclose(_np(t.logpdf_indices(_t(idx))),
                               _np(j.logpdf_indices(jnp.asarray(idx))), rtol=1e-6)
    noisy = (_category_values(idx)
             + np.random.default_rng(2).uniform(-0.7, 0.7, (300, 3)).astype(np.float32))
    noisy[:3] = [[0.5, 15.0, 1.75], [1.5, 25.0, -0.5], [9.0, -9.0, 9.0]]
    assert np.array_equal(_np(t._values_to_indices(_t(noisy))),
                          _np(j._values_to_indices(jnp.asarray(noisy))))
    np.testing.assert_allclose(_np(t.logpdf(_t(noisy))), _np(j.logpdf(jnp.asarray(noisy))),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(t.pdf(_t(noisy))), _np(j.pdf(jnp.asarray(noisy))),
                               rtol=1e-6)


@pytest.mark.parametrize("cont_first", [True, False])
def test_mixed_densities_match_jax(cont_first):
    """Both mixed priors on the same rows (some outside the box): the block
    split, pdf, logpdf and pdf_indices to 1e-6 relative; 0 outside the open
    box in both."""
    rng = np.random.default_rng(3)
    xc = rng.uniform(-1.2, 1.2, (100, 2)).astype(np.float32)
    xb = _binary_rows(100, 5, 4)
    idx = _category_indices(100, 5)
    join = (lambda c, d: np.concatenate([c, d] if cont_first else [d, c], axis=1))
    jb = jd.MixedBinaryPrior(2, 5, BOX, continous_first=cont_first)
    jb.prior_disc = jb.prior_binary = jd.BinaryPrior(5, probs=rng.uniform(0.1, 0.9, 5))
    tb = discrete_prior_from_numpy(discrete_prior_to_numpy(jb), device="cpu")
    x = join(xc, xb)
    for a, b in zip(tb.separate_samples(_t(x)), jb.separate_samples(jnp.asarray(x))):
        assert np.array_equal(_np(a), _np(b))
    for fn in ("pdf", "logpdf"):
        np.testing.assert_allclose(_np(getattr(tb, fn)(_t(x))),
                                   _np(getattr(jb, fn)(jnp.asarray(x))), rtol=1e-6)
    assert (_np(tb.pdf(_t(x)))[np.abs(xc[:, 0]) > 1] == 0).all()
    jc = jd.MixedCategoricalPrior(2, 3, CATS, BOX, continous_first=cont_first)
    tc = discrete_prior_from_numpy(discrete_prior_to_numpy(jc), device="cpu")
    xi = join(xc, idx.astype(np.float32))
    np.testing.assert_allclose(_np(tc.pdf_indices(_t(xi))),
                               _np(jc.pdf_indices(jnp.asarray(xi))), rtol=1e-6)
    xv = join(xc, _category_values(idx))
    np.testing.assert_allclose(_np(tc.pdf(_t(xv))), _np(jc.pdf(jnp.asarray(xv))), rtol=1e-6)
    assert tc.type == "mixedcategorical" and tc.n_dims == 5
    assert tc.continous_first == cont_first


# ----------------------------------------------------------------------------
# draws, by distribution
# ----------------------------------------------------------------------------

def test_binary_draws_follow_probs():
    """Column means of 20,000 draws within 0.02 (4.5 standard errors at
    p = 0.5) of probs and of JAX's draws' means."""
    probs = np.array([0.5, 0.05, 0.95, 0.3], np.float32)
    x = _np(BinaryPrior(4, probs=probs, device="cpu").sample(_gen(0), 20000))
    want = _np(jd.BinaryPrior(4, probs=probs).sample(jax.random.key(0), 20000))
    assert set(np.unique(x)) <= {0.0, 1.0} and x.dtype == np.float32
    assert np.abs(x.mean(0) - probs).max() < 0.02
    assert np.abs(x.mean(0) - want.mean(0)).max() < 0.02


def test_categorical_draws_follow_probs():
    """sample_both: values are the indices' table entries; category
    frequencies of 20,000 Gumbel-argmax draws within 0.02 of probs and of
    JAX's draws; padding is never drawn."""
    weights = [[0.1, 0.6, 0.3], [0.9, 0.1], [0.25, 0.25, 0.05, 0.45]]
    t = CategoricalPrior(CATS, weights=weights, device="cpu")
    j = jd.CategoricalPrior(CATS, weights=weights)
    vals, idx = t.sample_both(_gen(1), 20000)
    jv, jidx = j.sample_both(jax.random.key(1), 20000)
    assert np.array_equal(_np(vals), _category_values(_np(idx)))
    probs = _np(t.probs)
    for d, c in enumerate(CATS):
        assert _np(idx)[:, d].max() < len(c)
        freq = np.bincount(_np(idx)[:, d], minlength=len(c)) / 20000
        jfreq = np.bincount(np.asarray(jidx)[:, d], minlength=len(c)) / 20000
        assert np.abs(freq - probs[d, :len(c)]).max() < 0.02
        assert np.abs(freq - jfreq).max() < 0.02
    assert np.array_equal(_np(t.sample(_gen(1), 50)), _np(vals[:50]))


def test_mixed_draws_keep_the_sobol_block():
    """A mixed prior's continuous block is its Uniform's scrambled Sobol
    sequence, equal to JAX's bit for bit and advancing across calls; the
    discrete block holds legal values; sample_both's index rows repeat the
    continuous block and index the values."""
    jb, tb = jd.MixedBinaryPrior(2, 5, BOX), MixedBinaryPrior(2, 5, BOX, device="cpu")
    for _ in range(2):
        got, want = _np(tb.sample(_gen(2), 64)), np.asarray(jb.sample(jax.random.key(2), 64))
        assert np.array_equal(got[:, :2].view(np.uint32), want[:, :2].view(np.uint32))
        assert set(np.unique(got[:, 2:])) <= {0.0, 1.0}
    assert tb.prior_binary is tb.prior_disc and tb.prior_cont._offset == 128
    jc = jd.MixedCategoricalPrior(1, 3, CATS, BOX[:, :1], continous_first=False)
    tc = MixedCategoricalPrior(1, 3, CATS, BOX[:, :1], continous_first=False,
                               device="cpu")
    vals, xi = tc.sample_both(_gen(3), 64)
    jvals, _ = jc.sample_both(jax.random.key(3), 64)
    assert np.array_equal(_np(vals[:, 3]), np.asarray(jvals)[:, 3])
    assert torch.equal(vals[:, 3], xi[:, 3])
    assert np.array_equal(_np(vals[:, :3]), _category_values(_np(xi[:, :3]).astype(int)))


# ----------------------------------------------------------------------------
# the MLE updates
# ----------------------------------------------------------------------------

def _pool_weights(n, seed):
    w = np.random.default_rng(seed).gamma(0.5, size=n).astype(np.float32)
    w[::7] = 0.0
    return w / w.sum()


def test_bernoulli_mle_matches_jax():
    """The weighted frequencies and their clamp to [1e-3, 1 - 1e-3], to
    1e-6; update_binary_prior carries them."""
    x = _binary_rows(500, 8, 6)
    x[:, 0], x[:, 1] = 0.0, 1.0                   # the clamp's two edges
    w = _pool_weights(500, 7)
    want = np.asarray(jpu.bernoulli_mle(jnp.asarray(w), jnp.asarray(x)))
    got = _np(tpu.bernoulli_mle(_t(w), _t(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == np.float32(1e-3) and got[1] == np.float32(1 - 1e-3)
    new = tpu.update_binary_prior(_t(w), _t(x), BinaryPrior(8, device="cpu"))
    assert isinstance(new, BinaryPrior) and torch.equal(new.probs, torch.as_tensor(got))


def test_categorical_mle_matches_jax():
    """Per-dimension weighted category frequencies, clamped below at 1e-3,
    0 on padding, to 1e-6; the prior passed in is unchanged."""
    idx = _category_indices(400, 8)
    idx[:, 2] = np.where(idx[:, 2] == 3, 1, idx[:, 2])      # category 3 unused
    w = _pool_weights(400, 9)
    want = np.asarray(jpu.categorical_mle(jnp.asarray(w), jnp.asarray(idx), 3, 4))
    np.testing.assert_allclose(_np(tpu.categorical_mle(_t(w), _t(idx), 3, 4)), want,
                               atol=1e-6)
    jprior, tprior = jd.CategoricalPrior(CATS), CategoricalPrior(CATS, device="cpu")
    jnew = jpu.update_categorical_prior(jnp.asarray(w), jnp.asarray(idx), jprior)
    tnew = tpu.update_categorical_prior(_t(w), _t(idx.astype(np.float32)), tprior)
    np.testing.assert_allclose(_np(tnew.weights), np.asarray(jnew.weights), atol=1e-6)
    np.testing.assert_allclose(_np(tnew.probs), np.asarray(jnew.probs), atol=1e-6)
    assert _np(tnew.weights)[2, 3] == np.float32(1e-3) and _np(tnew.weights)[1, 2] == 0
    assert torch.equal(tprior.weights, CategoricalPrior(CATS, device="cpu").weights)


@pytest.mark.parametrize("label", ["binary", "categorical"])
def test_update_mixed_prior_matches_jax(label):
    """Both blocks refit from one weighted pool: the discrete block to 1e-6;
    the continuous block becomes a WKDE bounded by the box whose bandwidth,
    effective size and covariance agree to 1e-6 relative (its components
    are the pool's rows in another order: n_kde exceeds the pool)."""
    rng = np.random.default_rng(10)
    n = 300
    xc = rng.uniform(BOX[0], BOX[1], (n, 2)).astype(np.float32)
    if label == "binary":
        jprior = jd.MixedBinaryPrior(2, 5, BOX)
        xd = _binary_rows(n, 5, 11)
    else:
        jprior = jd.MixedCategoricalPrior(2, 3, CATS, BOX)
        xd = _category_indices(n, 11).astype(np.float32)
    tprior = discrete_prior_from_numpy(discrete_prior_to_numpy(jprior), device="cpu")
    x, w = np.concatenate([xc, xd], axis=1), _pool_weights(n, 12)
    jnew = jpu.update_mixed_prior(jnp.asarray(x), jnp.asarray(w), jprior, label=label,
                                  key=jax.random.key(0))
    tnew = tpu.update_mixed_prior(_t(x), _t(w), tprior, label=label, gen=_gen(0))
    assert isinstance(tprior.prior_cont, Uniform)             # not updated in place
    assert isinstance(tnew.prior_cont, WeightedKernelDensityEstimation)
    assert torch.equal(tnew.prior_cont.bounds, torch.as_tensor(BOX))
    if label == "binary":
        np.testing.assert_allclose(_np(tnew.prior_disc.probs),
                                   np.asarray(jnew.prior_disc.probs), atol=1e-6)
        assert tnew.prior_binary is tnew.prior_disc
    else:
        np.testing.assert_allclose(_np(tnew.prior_disc.weights),
                                   np.asarray(jnew.prior_disc.weights), atol=1e-6)
    for name in ("bw", "neff", "covariance"):
        np.testing.assert_allclose(_np(getattr(tnew.prior_cont, name)),
                                   np.asarray(getattr(jnew.prior_cont, name)), rtol=1e-6)
    with pytest.raises(ValueError):
        tpu.update_mixed_prior(_t(x), _t(w), tprior, label="continuous")


def test_discrete_priors_carry_across():
    """discrete_prior_to_numpy / discrete_prior_from_numpy: masses exactly,
    a mixed prior's Sobol offset and WKDE block carried."""
    jb = jd.BinaryPrior(4, probs=[0.1, 0.2, 0.3, 0.4])
    assert np.array_equal(_np(discrete_prior_from_numpy(
        discrete_prior_to_numpy(jb), "cpu").probs), np.asarray(jb.probs))
    jc = jpu.update_categorical_prior(jnp.ones(10) / 10,
                                      jnp.asarray(_category_indices(10, 0)),
                                      jd.CategoricalPrior(CATS))
    tc = discrete_prior_from_numpy(discrete_prior_to_numpy(jc), "cpu")
    assert np.array_equal(_np(tc.weights), np.asarray(jc.weights)) and tc.categories == CATS
    jm = jd.MixedBinaryPrior(2, 3, BOX, continous_first=False)
    jm.sample(jax.random.key(0), 32)
    tm = discrete_prior_from_numpy(discrete_prior_to_numpy(jm), "cpu")
    assert tm.prior_cont._offset == 32 and not tm.continous_first
    got, want = tm.sample(_gen(0), 16), jm.sample(jax.random.key(0), 16)
    assert np.array_equal(_np(got)[:, 3:], np.asarray(want)[:, 3:])
    x = np.random.default_rng(0).uniform(-1, 0.5, (50, 2)).astype(np.float32)
    jm.prior_cont = jpu.update_continuous_prior(jnp.asarray(x), jnp.ones(50) / 50, jm.prior_cont,
                                                2, key=jax.random.key(1))
    tm = discrete_prior_from_numpy(discrete_prior_to_numpy(jm), "cpu")
    probe = _t(x[:10])
    np.testing.assert_allclose(_np(tm.prior_cont.pdf(probe)),
                               np.asarray(jm.prior_cont.pdf(jnp.asarray(x[:10]))), rtol=1e-5)


# ----------------------------------------------------------------------------
# the tasks
# ----------------------------------------------------------------------------

def test_ising_matches_jax():
    """The KL objective of 48 random edge masks to 1e-4 relative (the log
    partition functions are float32 logsumexps over 65,536 energies in both
    packages, summed in another order); the full mask is ~0 and dropping
    every edge is worse (tests/test_tasks.py:44-55)."""
    x = _binary_rows(48, 24, 13)
    jprior, jf = jt.setup_ising()
    tprior, tf = tt.setup_ising(device="cpu")
    want = np.asarray(jf(jnp.asarray(x)))
    got = _np(tf(_t(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    full, none = float(tf(torch.ones(1, 24))[0]), float(tf(torch.zeros(1, 24))[0])
    assert abs(full) < 1e-2 and none < full
    assert abs(full - float(jf(jnp.ones((1, 24)))[0])) < 1e-5
    assert isinstance(tprior, BinaryPrior) and tprior.n_dims == 24


def test_maxsat_matches_jax():
    """The same clauses (indices and signs exactly) and weights; the
    objective of 64 assignments to 1e-5 (float32 sums of standardized
    weights in another order)."""
    path = tt.DATA_DIR / "maxcut-johnson8-2-4.clq.wcnf"
    j, t = jt.MaxSAT(str(path)), tt.MaxSAT(path, device="cpu")
    assert t.n_variables == j.n_variables == 28
    assert np.array_equal(_np(t.idx), np.asarray(j.idx))
    assert np.array_equal(_np(t.sign), np.asarray(j.sign))
    assert np.array_equal(_np(t.weights), np.asarray(j.weights))
    x = _binary_rows(64, 28, 14)
    _, jf = jt.setup_maxsat()
    tprior, tf = tt.setup_maxsat(device="cpu")
    np.testing.assert_allclose(_np(tf(_t(x))), np.asarray(jf(jnp.asarray(x))), atol=1e-5)
    assert np.unique(_np(tf(_t(x))).round(5)).size > 3 and tprior.n_dims == 28


def test_pest_matches_jax():
    """The host simulator on the same seed gives the same float32 values."""
    x = np.random.default_rng(15).integers(0, 5, (4, 15)).astype(np.float32)
    jprior, jf = jt.setup_pest()
    tprior, tf = tt.setup_pest(device="cpu")
    got = tf(_t(x))
    assert got.dtype == torch.float32 and (got < 0).all()
    assert np.array_equal(_np(got), np.asarray(jf(jnp.asarray(x))))
    assert tprior.categories == jprior.categories and tprior.c_max == 5


def test_mixed_setups_match_jax():
    """setup_ackley (3 + 20, mixed binary) and setup_rosenbrock (1 + 6 x 4,
    mixed categorical): the same priors, and objectives to 1e-5 relative."""
    rng = np.random.default_rng(16)
    for jsetup, tsetup in ((jsyn.setup_ackley, tsyn.setup_ackley),
                           (jsyn.setup_rosenbrock, tsyn.setup_rosenbrock)):
        jprior, jf = jsetup()
        tprior, tf = tsetup(device="cpu")
        assert type(tprior).__name__ == type(jprior).__name__
        assert (tprior.n_dims_cont, tprior.n_dims_disc) == (jprior.n_dims_cont,
                                                           jprior.n_dims_disc)
        assert np.array_equal(_np(tprior.bounds), np.asarray(jprior.bounds))
        x = np.asarray(jprior.sample(jax.random.key(0), 64))
        np.testing.assert_allclose(_np(tf(_t(x))), np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-5)
    assert tprior.categories == [[-2.0, -1.0, 1.0, 2.0]] * 6
    x = rng.normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_allclose(_np(tsyn.rosenbrock(_t(x))),
                               np.asarray(jsyn.rosenbrock(jnp.asarray(x))), rtol=1e-5)
