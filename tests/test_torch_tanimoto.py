"""Parity of the port's Tanimoto Gram and Tanimoto GP with the JAX package
on the CPU, where `tanimoto_similarity` takes its plain PyTorch reference.
The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py. Also the four repairs that let a Tanimoto GP fit
and predict in the port: no lengthscale in its kernel, no lengthscale prior,
a zero gradient for the unused raw lengthscale, and a config that accepts
the kernel."""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core.rckernel import RecombinationKernel as JaxRCKernel
from sober_tpu.gp import exact as jx
from sober_tpu.gp.tanimoto import fit_tanimoto_gp as jax_fit_tanimoto_gp
from sober_tpu.ops import kernels as jk
from sober_tpu.ops.pallas_kernels import tanimoto_gram_pallas
from sober_tpu_torch.core.rckernel import MODES, RecombinationKernel
from sober_tpu_torch.gp import exact as tx
from sober_tpu_torch.gp.tanimoto import batch_tanimoto_sim, fit_tanimoto_gp
from sober_tpu_torch.interop import gp_state_from_numpy, gp_state_to_numpy
from sober_tpu_torch.ops.kernels import make_kernel
from sober_tpu_torch.ops.tanimoto_gram import (POOLS, PackCache,
                                               check_fingerprints, pack_bits,
                                               pack_bits_reference,
                                               tanimoto_gram_packed,
                                               tanimoto_gram_packed_reference,
                                               tanimoto_similarity,
                                               tanimoto_similarity_reference)
from sober_tpu_torch.priors.dataset import DatasetPrior


def _bits(n, d, seed, density=0.025, zero_rows=()):
    x = (np.random.default_rng(seed).random((n, d)) < density).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x


def _oracle(x, y):
    """Tanimoto similarity in float64."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    xy = x @ y.T
    return xy / np.maximum(x.sum(1)[:, None] + y.sum(1)[None, :] - xy, 1e-20)


def _gp_data(n=80, d=256, seed=0):
    """Fingerprints with a noisy additive target."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) < 0.05).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (x @ w / np.sqrt(x.sum(1) + 1.0) + 0.3 * rng.normal(size=n))
    return x, y.astype(np.float32)


# ----------------------------------------------------------------------------
# the Gram
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,d", [(70, 130, 256), (40, 100, 2048)])
def test_similarity_matches_jax_pallas_and_oracle(n, m, d):
    """The reference and the port's kernel-registry Gram against JAX's
    bf16-pass Gram, the Pallas kernel in interpret mode and a float64
    oracle, all to 1e-6 absolute, with all-zero rows on both sides (an
    all-zero pair is 0, not NaN)."""
    x = _bits(n, d, 1, zero_rows=(0, 5))
    y = _bits(m, d, 2, zero_rows=(3, m - 1))
    os_ = 1.3
    want = _oracle(x, y)
    ref = tanimoto_similarity_reference(torch.as_tensor(x),
                                        torch.as_tensor(y)).numpy()
    kern = make_kernel("tanimoto", outputscale=os_, device="cpu")
    gram = kern.gram(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    jax_gram = np.asarray(jk.tanimoto_gram(
        {"outputscale": jnp.float32(os_)}, jnp.asarray(x), jnp.asarray(y)))
    pallas = np.asarray(tanimoto_gram_pallas(
        jnp.asarray(x), jnp.asarray(y), tile_m=64, tile_n=64, interpret=True))
    assert np.isfinite(ref).all() and ref[0, 0] == 0.0
    assert np.abs(ref - want).max() <= 1e-6
    assert np.abs(ref - pallas).max() <= 1e-6
    assert np.abs(gram - jax_gram).max() <= 1e-6 * os_
    assert np.abs(gram - os_ * want).max() <= 1e-6 * os_
    np.testing.assert_array_equal(
        batch_tanimoto_sim(torch.as_tensor(x), torch.as_tensor(y)).numpy(), ref)
    np.testing.assert_allclose(kern.diag(torch.as_tensor(x)).numpy(),
                               np.asarray(jk.Kernel("tanimoto", {
                                   "outputscale": jnp.float32(os_)}).diag(
                                       jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("d", [2048, 300, 33, 1])
def test_pack_layout_matches_packbits(d):
    """The pack kernel's layout, emulated on the host: word w of a row holds
    elements 32w .. 32w + 31, bit l = element 32w + l, zero bits past d.
    That is numpy.packbits in little bit order, read as little-endian
    uint32. The counts are the row sums, and a popcount Gram over the
    packed words reproduces the reference exactly."""
    x = _bits(37, d, 3, density=0.3, zero_rows=(4,))
    words, counts = pack_bits_reference(torch.as_tensor(x))
    n_words = -(-d // 32)
    padded = np.zeros((37, 32 * n_words), np.uint8)
    padded[:, :d] = x
    want = np.packbits(padded, axis=1, bitorder="little").view("<u4")
    assert words.dtype == torch.int32 and words.shape == (37, n_words)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(counts.numpy(), x.sum(1).astype(np.int32))
    # the kernel's arithmetic: popcount(a & b) summed over words
    w64 = words.numpy().view(np.uint32).astype(np.uint64)
    inter = np.zeros((37, 37))
    for k in range(n_words):
        a = w64[:, k][:, None] & w64[:, k][None, :]
        inter += np.array([[bin(int(v)).count("1") for v in row] for row in a])
    c = counts.numpy().astype(np.float32)
    sim = (inter.astype(np.float32)
           / np.maximum(c[:, None] + c[None, :] - inter.astype(np.float32),
                        np.float32(1e-20)))
    ref = tanimoto_similarity_reference(torch.as_tensor(x),
                                        torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(sim.astype(np.float32), ref)


def test_wrappers_take_reference_on_cpu():
    """On CPU tensors the wrappers compute the references, launch nothing
    and read no flag."""
    x = torch.as_tensor(_bits(20, 64, 4))
    n_sim, n_pack = tanimoto_gram_packed.launches, pack_bits.launches
    n_reads = check_fingerprints.reads
    assert torch.equal(tanimoto_similarity(x, x[:7]),
                       tanimoto_similarity_reference(x, x[:7]))
    got, want = pack_bits(x), pack_bits_reference(x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tanimoto_gram_packed(*got, *want),
                       tanimoto_gram_packed_reference(*want, *want))
    check_fingerprints("cpu")
    assert (tanimoto_gram_packed.launches, pack_bits.launches,
            check_fingerprints.reads) == (n_sim, n_pack, n_reads)


@pytest.mark.parametrize("bad", [0.5, float("nan"), 2.0, -1.0])
def test_pack_reference_marks_non_binary_rows(bad):
    """A row holding a value other than 0 or 1 packs to the count -1 (its
    words as the kernel's ballot gives them: a bit wherever x != 0); the
    other rows keep their popcounts."""
    x = _bits(9, 70, 7, density=0.3)
    clean_words, clean_counts = pack_bits_reference(torch.as_tensor(x))
    x[4, 33] = bad
    words, counts = pack_bits_reference(torch.as_tensor(x))
    want = clean_counts.clone()
    want[4] = -1
    assert torch.equal(counts, want)
    keep = torch.arange(9) != 4
    assert torch.equal(words[keep], clean_words[keep])
    assert int(words[4, 1]) & 2 and int(words[4, 1]) & ~2 == int(clean_words[4, 1]) & ~2


@pytest.mark.parametrize("d", [33, 300, 2048])
def test_packed_gram_matches_jax_pallas(d):
    """The Gram kernel's function on packed operands, in its plain version,
    against JAX's Pallas kernel in interpret mode and a float64 oracle, to
    1e-6, all-zero rows on both sides; a row or column of count -1 is NaN
    and the rest unchanged."""
    x = _bits(45, d, 11, zero_rows=(0, 7))
    y = _bits(70, d, 12, zero_rows=(69,))
    xw, nx = pack_bits_reference(torch.as_tensor(x))
    yw, ny = pack_bits_reference(torch.as_tensor(y))
    got = tanimoto_gram_packed_reference(xw, nx, yw, ny).numpy()
    pallas = np.asarray(tanimoto_gram_pallas(
        jnp.asarray(x), jnp.asarray(y), tile_m=64, tile_n=64, interpret=True))
    assert np.isfinite(got).all() and got[0, 0] == 0.0 and got[7, 69] == 0.0
    assert np.abs(got - pallas).max() <= 1e-6
    assert np.abs(got - _oracle(x, y)).max() <= 1e-6
    np.testing.assert_array_equal(
        got, tanimoto_similarity_reference(torch.as_tensor(x),
                                           torch.as_tensor(y)).numpy())
    nx[3], ny[10] = -1, -1
    marked = tanimoto_gram_packed_reference(xw, nx, yw, ny).numpy()
    assert np.isnan(marked[3]).all() and np.isnan(marked[:, 10]).all()
    keep_r, keep_c = np.arange(45) != 3, np.arange(70) != 10
    np.testing.assert_array_equal(marked[keep_r][:, keep_c], got[keep_r][:, keep_c])


def test_pack_cache_hits_misses_and_forgets():
    """A registered tensor is packed at its first lookup and then reused;
    a write to it (its _version) makes the next lookup repack; other
    tensors, its views and copies included, are not looked up; a dead
    tensor leaves no entry, and the cache never keeps it alive."""
    cache = PackCache(pack_bits_reference)
    pool = torch.as_tensor(_bits(30, 100, 8))
    cache.register(pool)
    assert len(cache) == 1 and cache.packs == 0
    first = cache.lookup(pool)
    assert cache.packs == 1
    assert all(torch.equal(a, b) for a, b in zip(first, pack_bits_reference(pool)))
    assert cache.lookup(pool) is first and cache.packs == 1
    assert all(cache.lookup(other) is None
               for other in (pool.clone(), pool[:5], pool.view(30, 100)))
    pool[2, 3] = 1.0 - pool[2, 3]
    second = cache.lookup(pool)
    assert cache.packs == 2 and second is not first
    assert torch.equal(second[1], pack_bits_reference(pool)[1])
    assert cache.lookup(pool) is second and cache.packs == 2
    del pool, first, second
    gc.collect()
    assert len(cache) == 0


def test_dataset_prior_registers_its_pool_only_on_cuda():
    """On the CPU the Gram takes the reference, so a prior registers
    nothing."""
    n = len(POOLS)
    prior = DatasetPrior(_bits(12, 40, 9), np.zeros(12, np.float32), device="cpu")
    assert len(POOLS) == n and POOLS.lookup(prior.features) is None


# ----------------------------------------------------------------------------
# the Tanimoto GP
# ----------------------------------------------------------------------------

def test_fit_tanimoto_gp_matches_jax():
    """Both packages fit their own hypers (L-BFGS, bucket 128, no priors).
    The optimizers' trajectories differ (optax's zoom line search against
    torch's strong Wolfe), so the end point is compared: the MLL within
    1e-3 relative, outputscale within 2% and noise within 2% + 1e-7."""
    x, y = _gp_data()
    js = jax_fit_tanimoto_gp(jnp.asarray(x), jnp.asarray(y))
    ts = fit_tanimoto_gp(torch.as_tensor(x), torch.as_tensor(y))
    assert ts.x.shape == (128, 256) and float(ts.mask.sum()) == 80
    assert set(ts.kernel.params) == {"outputscale"}
    y_std = (y - y.mean()) / y.std(ddof=1)
    mask = np.asarray(js.mask)
    y_pad = np.concatenate([y_std, np.zeros(48, np.float32)])
    loss_j = float(tx.neg_mll(
        tx.GPParams(*(torch.as_tensor(np.asarray(getattr(
            jx.raw_params_from_state(js), f))) for f in tx.GPParams._fields)),
        ts.x, torch.as_tensor(y_pad), ts.config, torch.as_tensor(mask)))
    raw_t = tx.GPParams(
        torch.zeros(()),
        torch.log(torch.expm1(ts.kernel.params["outputscale"])),
        tx._inv_interval(ts.noise, ts.config.noise_lo, ts.config.noise_hi))
    loss_t = float(tx.neg_mll(raw_t, ts.x, torch.as_tensor(y_pad), ts.config,
                              torch.as_tensor(mask)))
    assert abs(loss_t - loss_j) <= 1e-3 * abs(loss_j)
    os_j = float(js.kernel.params["outputscale"])
    os_t = float(ts.kernel.params["outputscale"])
    assert abs(os_t - os_j) <= 0.02 * os_j
    assert abs(float(ts.noise) - float(js.noise)) <= 0.02 * float(js.noise) + 1e-7


def test_carried_state_predictions_match_jax():
    """A JAX-fitted Tanimoto state, carried across: predict, predict_mean,
    predict_raw, predictive_covariance and the three recombination-kernel
    modes agree to 1e-5."""
    x, y = _gp_data(seed=1)
    js = jax_fit_tanimoto_gp(jnp.asarray(x), jnp.asarray(y))
    ts = gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")
    xq = _bits(50, 256, 5, density=0.05, zero_rows=(7,))
    xr = _bits(30, 256, 6, density=0.05)
    jq, tq = jnp.asarray(xq), torch.as_tensor(xq)
    for got, want in zip(tx.predict(ts, tq), jx.predict(js, jq)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    for got, want in zip(tx.predict_raw(ts, tq), jx.predict_raw(js, jq)):
        scale = max(1.0, float(np.abs(np.asarray(want)).max()))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale
    np.testing.assert_allclose(tx.predict_mean(ts, tq).numpy(),
                               np.asarray(jx.predict_mean(js, jq)), atol=1e-5)
    np.testing.assert_allclose(
        tx.predictive_covariance(ts, tq, torch.as_tensor(xr)).numpy(),
        np.asarray(jx.predictive_covariance(js, jq, jnp.asarray(xr))),
        atol=1e-5)
    for mode in MODES:
        got = RecombinationKernel(ts, mode)(tq, torch.as_tensor(xr)).numpy()
        want = np.asarray(JaxRCKernel(js, mode)(jq, jnp.asarray(xr)))
        assert np.abs(got - want).max() <= 1e-5, mode
    with pytest.raises(ValueError):
        RecombinationKernel(ts, "nope")


# ----------------------------------------------------------------------------
# the repairs
# ----------------------------------------------------------------------------

def test_gpconfig_accepts_tanimoto():
    cfg = tx.GPConfig(kernel_name="tanimoto")
    assert cfg.kernel_name == "tanimoto"
    with pytest.raises(ValueError):
        tx.GPConfig(kernel_name="nope")


def test_tanimoto_kernel_has_no_lengthscale():
    """make_kernel and materialize give a Tanimoto kernel only an
    outputscale, as the JAX package does; the raw lengthscale stays in
    GPParams, unused."""
    assert set(make_kernel("tanimoto", n_dims=8, ard=True, device="cpu").params) == {"outputscale"}
    assert set(make_kernel("rbf", device="cpu").params) == {"outputscale", "lengthscale"}
    cfg = tx.GPConfig(kernel_name="tanimoto")
    params = tx.init_params(cfg, 256, device="cpu")
    kernel, noise = tx.materialize(params, cfg)
    jkernel, _ = jx.materialize(jx.init_params(jx.GPConfig(
        kernel_name="tanimoto"), 256), jx.GPConfig(kernel_name="tanimoto"))
    assert set(kernel.params) == set(jkernel.params) == {"outputscale"}
    assert params.raw_lengthscale.shape == ()


def test_priors_skip_lengthscale_for_tanimoto():
    """With use_priors the Tanimoto MAP objective has the outputscale prior
    only, as in the JAX package, and matches it to 1e-5 relative."""
    x, y = _gp_data(n=40, seed=2)
    y = (y - y.mean()) / y.std(ddof=1)
    raw = {"raw_lengthscale": np.float32(0.3), "raw_outputscale": np.float32(0.4),
           "raw_noise": np.float32(-0.5)}
    jcfg = jx.GPConfig(kernel_name="tanimoto", use_priors=True)
    tcfg = tx.GPConfig(kernel_name="tanimoto", use_priors=True)
    want = float(jx.neg_mll(jx.GPParams(**{k: jnp.asarray(v) for k, v in raw.items()}),
                            jnp.asarray(x), jnp.asarray(y), jcfg))
    got = float(tx.neg_mll(tx.GPParams(*(torch.as_tensor(raw[k])
                                         for k in tx.GPParams._fields)),
                           torch.as_tensor(x), torch.as_tensor(y), tcfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_unused_lengthscale_gets_zero_grad():
    """The Tanimoto loss never reads raw_lengthscale, so autograd leaves its
    grad None; the fit treats it as zero (jax.grad's answer) and runs."""
    x, y = _gp_data(n=40, seed=3)
    y = torch.as_tensor((y - y.mean()) / y.std(ddof=1))
    x = torch.as_tensor(x)
    cfg = tx.GPConfig(kernel_name="tanimoto", fit_iters=10)
    params = tx._leaves(tx.init_params(cfg, x.shape[1], device="cpu"))
    tx._set_grads(params, tx.neg_mll(params, x, y, cfg), cfg)
    assert torch.equal(params.raw_lengthscale.grad, torch.zeros(()))
    assert float(params.raw_outputscale.grad.abs()) > 0
    for optimiser in ("adam", "lbfgs"):
        fitted = tx.fit_params(x, y, cfg, optimiser=optimiser)
        assert float(fitted.raw_lengthscale) == 0.0
        assert (float(tx.neg_mll(fitted, x, y, cfg))
                <= float(tx.neg_mll(tx.init_params(cfg, x.shape[1], device="cpu"), x, y, cfg)))
