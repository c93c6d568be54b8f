"""Parity of the port's Gram kernels and Caratheodory loop with the JAX
package, on the CPU, where every kernel wrapper takes its plain PyTorch
reference. The kernels themselves are tested on the card by
tests/test_torch_cuda.py."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.ops import kernels as jk
from sober_tpu.ops.pallas_car import car_eliminate_pallas
from sober_tpu.ops.pallas_kernels import rbf_gram_pallas
from sober_tpu_torch.ops import _build
from sober_tpu_torch.ops.car import (MAX_M, MAX_WIDTH, SMEM_LIMIT, CarPlan,
                                     car_eliminate, car_eliminate_reference,
                                     car_plan, reference_horizon)
from sober_tpu_torch.ops.kernels import make_kernel
from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference


def test_import_without_jax():
    """Every module of the port imports, and none of them imports jax."""
    code = ("import pkgutil, sys, importlib, sober_tpu_torch; "
            "names = [m.name for m in pkgutil.walk_packages("
            "sober_tpu_torch.__path__, 'sober_tpu_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert {'sober_tpu_torch.compat', 'sober_tpu_torch.apps.inverse', "
            "'sober_tpu_torch.benchmarks.batch_bo', 'sober_tpu_torch.gp.multitask', "
            "'sober_tpu_torch.gp.sampling', 'sober_tpu_torch.utils.timing', "
            "'sober_tpu_torch.tasks.svm', 'sober_tpu_torch.gp.fbgp', "
            "'sober_tpu_torch.priors.tmvn'} <= set(names), names; "
            "assert not any(m == 'jax' or m.startswith('jax.') or m == 'sober_tpu' "
            "or m.startswith('sober_tpu.') for m in sys.modules), 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_scripts_import_without_jax():
    """Every module of examples_torch/, tutorials_torch/ and
    tools/acceptance_torch.py imports, and none of them imports jax, the
    JAX package or the JAX examples."""
    code = ("import glob, importlib.util, sys; "
            "paths = sorted(glob.glob('examples_torch/*.py') + glob.glob('tutorials_torch/*.py')"
            " + ['tools/acceptance_torch.py']); "
            "assert len(paths) == 26, paths; "
            "specs = [importlib.util.spec_from_file_location('m%d' % i, p) "
            "for i, p in enumerate(paths)]; "
            "[s.loader.exec_module(importlib.util.module_from_spec(s)) for s in specs]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sober_tpu', "
            "'examples')]; assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)


# ----------------------------------------------------------------------------
# Grams
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("name", ["rbf", "matern12", "matern32", "matern52",
                                  "linear"])
def test_gram_matches_jax(name, ard):
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (37, 4)).astype(np.float32)
    y = rng.uniform(-1, 1, (53, 4)).astype(np.float32)
    ls = rng.uniform(0.4, 1.5, 4).astype(np.float32) if ard else np.float32(0.7)
    os_ = np.float32(1.3)
    want = np.asarray(jk.KERNELS[name](
        {"lengthscale": jnp.asarray(ls), "outputscale": jnp.asarray(os_)},
        jnp.asarray(x), jnp.asarray(y)))
    kern = make_kernel(name, n_dims=4, ard=ard, device="cpu")
    kern.params["lengthscale"] = torch.as_tensor(ls)
    kern.params["outputscale"] = torch.as_tensor(os_)
    got = kern.gram(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    jkern = jk.Kernel(name, {"lengthscale": jnp.asarray(ls),
                             "outputscale": jnp.asarray(os_)})
    np.testing.assert_allclose(kern.diag(torch.as_tensor(x)).numpy(),
                               np.asarray(jkern.diag(jnp.asarray(x))),
                               rtol=1e-6)


# d = 100 is past the first CUDA kernel's limit of 64 features, which the
# Pallas kernel never had
@pytest.mark.parametrize("ard,d", [(False, 5), (True, 5), (True, 3), (False, 100)],
                         ids=["False", "True", "d3-True", "d100-False"])
def test_rbf_reference_matches_pallas(ard, d):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (50, d)).astype(np.float32)
    y = rng.uniform(-1, 1, (90, d)).astype(np.float32)
    if d == 100:                 # pairs close enough for entries far from 0
        y[:20] = x[:20] + rng.normal(0, 0.05, (20, d)).astype(np.float32)
    ls = rng.uniform(0.5, 1.2, d).astype(np.float32) if ard else np.float32(0.7)
    p = {"lengthscale": ls, "outputscale": np.float32(1.3)}
    want = np.asarray(rbf_gram_pallas(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        jnp.asarray(y), tile_m=64, tile_n=64, interpret=True))
    got = rbf_gram_reference({k: torch.as_tensor(v) for k, v in p.items()},
                             torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_wrappers_take_reference_on_cpu():
    """On CPU tensors the wrappers compute the reference and launch nothing."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (20, 3)), dtype=torch.float32)
    p = {"lengthscale": torch.tensor(0.5), "outputscale": torch.tensor(2.0)}
    n_rbf, n_car = rbf_gram.launches, car_eliminate.launches
    assert torch.equal(rbf_gram(p, x, x[:7]), rbf_gram_reference(p, x, x[:7]))
    big_n, _, mu, mask = _car_inputs(np.random.default_rng(1), 24, 9, 3)
    got = car_eliminate(torch.as_tensor(mu), torch.as_tensor(big_n),
                        torch.as_tensor(mask), 10)
    want = car_eliminate_reference(torch.as_tensor(mu), torch.as_tensor(big_n),
                                   torch.as_tensor(mask), 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (rbf_gram.launches, car_eliminate.launches) == (n_rbf, n_car)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "libmissing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ----------------------------------------------------------------------------
# Caratheodory elimination loop
# ----------------------------------------------------------------------------

def _jax_null_basis(x, mu, mask, n_elim):
    """The two-stage null basis of sober_tpu/core/rchq.py:_caratheodory, in
    JAX (as tests/test_pallas.py builds it)."""
    m, p = x.shape
    active0 = jnp.logical_and(mu > 0, mask > 0).astype(jnp.float32)
    q_full, _ = jnp.linalg.qr(jnp.asarray(x) * active0[:, None], mode="complete")
    n0 = q_full[:, p:]
    d_gram = (n0 * (1.0 - active0)[:, None]).T @ n0
    lam, c_vecs = jnp.linalg.eigh(0.5 * (d_gram + d_gram.T))
    n_take = min(n_elim, m - p)
    big_n = (n0 @ c_vecs[:, :n_take]) * (lam[:n_take] <= 1e-6)[None, :]
    return np.array(big_n, np.float32)


def _car_inputs(rng, m, p, n_pad):
    """Random well-conditioned CAR inputs with n_pad padding rows, and their
    null basis built in JAX. Returns numpy (big_n, x, mu, mask)."""
    x = rng.normal(size=(m, p)).astype(np.float32)
    mu = rng.uniform(0.1, 1.0, m).astype(np.float32)
    mask = np.ones(m, np.float32)
    if n_pad:
        mask[-n_pad:] = 0.0
        mu[-n_pad:] = 0.0
    mu /= mu.sum()
    big_n = _jax_null_basis(x, jnp.asarray(mu), jnp.asarray(mask), m - p)
    return big_n, x, mu, mask


@pytest.mark.parametrize("m,p,n_pad,seed", [(64, 17, 5, 7), (48, 31, 0, 8),
                                             (96, 40, 9, 9)])
def test_car_loop_matches_pallas_and_fori(m, p, n_pad, seed):
    """One null basis fed to the port's reference, the Pallas kernel in
    interpret mode and the JAX fori-loop path: the same eliminated set and
    |dmu| <= 1e-5, plus the invariants of tests/test_pallas.py."""
    from sober_tpu.core.rchq import _caratheodory

    big_n, x, mu, mask = _car_inputs(np.random.default_rng(seed), m, p, n_pad)
    n_take = big_n.shape[1]
    active0 = ((mu > 0) & (mask > 0)).astype(np.float32)

    mu_t, el_t = car_eliminate_reference(
        torch.as_tensor(mu), torch.as_tensor(big_n), torch.as_tensor(mask),
        n_take)
    w_t = (mu_t * (1 - el_t)).numpy() * active0
    mu_p, el_p = car_eliminate_pallas(jnp.asarray(mu), jnp.asarray(big_n),
                                      jnp.asarray(mask), n_take, interpret=True)
    w_p = np.asarray(mu_p * (1 - el_p)) * active0
    w_f = np.asarray(_caratheodory(jnp.asarray(x), jnp.asarray(mu), m - p,
                                   jnp.asarray(mask)))

    np.testing.assert_array_equal(el_t.numpy(), np.asarray(el_p))
    assert set(np.flatnonzero(w_t == 0)) == set(np.flatnonzero(w_f == 0))
    assert np.abs(w_t - w_p).max() <= 1e-5
    assert np.abs(w_t - w_f).max() <= 1e-5
    assert (w_t >= 0).all()
    if n_pad:
        assert (w_t[-n_pad:] == 0).all()                  # padding stays empty
    n_usable = int(np.sum(np.abs(big_n).max(axis=0) > 0))
    assert (w_t == 0).sum() >= (mu == 0).sum() + n_usable - 2
    assert np.abs(x.T @ w_t - x.T @ mu).max() < 1e-4


def test_reference_horizon_bounds_exact_agreement():
    """Past the horizon the float32 and float64 runs part; up to it they
    agree exactly, which is what the card's kernel is held to."""
    big_n, x, mu, mask = _car_inputs(np.random.default_rng(4), 200, 100, 7)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt)
    n_take = big_n.shape[1]
    k = reference_horizon(t(mu), t(big_n), t(mask), n_take)
    assert 10 <= k <= n_take
    m32, e32 = car_eliminate_reference(t(mu), t(big_n), t(mask), k)
    m64, e64 = car_eliminate_reference(t(mu, torch.float64),
                                       t(big_n, torch.float64),
                                       t(mask, torch.float64), k)
    assert torch.equal(e32.double(), e64)
    assert float((m32.double() - m64).abs().max()) <= 1e-6


@pytest.mark.parametrize("m,q", [(128, 64), (100, 50)])
def test_reference_horizon_holds_at_every_step(m, q):
    """chip_smoke.py's CAR problems at the FBGP's (m = 100) and BASQ's
    (m = 128) shapes: the float32 and float64 runs agree after every step
    up to the horizon and part at the next; at m = 128 they meet again
    within the tolerance after all n_take steps, so the horizon is found by
    walking both runs, not by testing one step count."""
    from sober_tpu_torch.core.rchq import null_basis

    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.normal(size=(m, m - q)), dtype=torch.float32)
    mu = rng.uniform(0.1, 1.0, m)
    mask = np.ones(m)
    mask[-7:] = mu[-7:] = 0.0
    mu = torch.as_tensor(mu / mu.sum(), dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.float32)
    big_n, n_take, _ = null_basis(x, mu, m - q, mask)

    def apart(k):
        m32, e32 = car_eliminate_reference(mu, big_n, mask, k)
        m64, e64 = car_eliminate_reference(mu.double(), big_n.double(),
                                           mask.double(), k)
        return float((m32.double() - m64).abs().max()) + (
            0.0 if torch.equal(e32.double(), e64) else 1.0)

    k = reference_horizon(mu, big_n, mask, n_take)
    assert 10 <= k < n_take
    assert all(apart(j) <= 1e-6 for j in range(1, k + 1))
    assert apart(k + 1) > 1e-6
    if m == 128:
        assert apart(n_take) <= 1e-6


# (m, q) -> the plan: the main path's shapes (m=200, q=100 at batch 100 and
# in screening; m=400, q=200 at batch 200), the card tests' shapes, and the
# edges of each variant
CAR_PLANS = {
    (200, 100): CarPlan("smem", 1, 88_448),
    (400, 200): CarPlan("cluster", 8, 44_992),
    (1000, 500): CarPlan("l2", 1, 2_000),
    (64, 47): CarPlan("smem", 1, 14_144),
    (390, 197): CarPlan("cluster", 8, 44_176),
    (1, 0): CarPlan("smem", 1, 48),
    (256, 216): CarPlan("smem", 1, 228_896),     # the largest q in one block
    (256, 217): CarPlan("cluster", 8, 32_896),
    (257, 10): CarPlan("cluster", 8, 4_112),     # m past one block's lanes
    (800, 120): CarPlan("cluster", 8, 54_368),
    (2048, 208): CarPlan("cluster", 8, 227_776),  # the largest q in 8 blocks
    (2048, 209): CarPlan("l2", 1, 836),
    (2049, 1): CarPlan("l2", 1, 4),              # past 8 blocks' lanes
    (MAX_M, 10): CarPlan("l2", 1, 40),
}


@pytest.mark.parametrize("m,q", sorted(CAR_PLANS))
def test_car_plan_picks_variant_by_shape(m, q):
    plan = car_plan(m, q)
    assert plan == CAR_PLANS[(m, q)]
    if plan.variant != "l2":
        width = -(-m // plan.cluster)
        qp = -(-q // 8) * 8
        assert width <= MAX_WIDTH and plan.smem_bytes <= SMEM_LIMIT
        # a warp's candidate slot per 8 lanes, the Householder vector (fp64
        # and fp32), the columns of qp + 4 words
        assert plan.smem_bytes == (32 * plan.cluster * -(-width // 8) + 12 * qp
                                   + 4 * width * (qp + 4))
        # a quarter warp's 16-byte loads (8 columns, one row group) fall in
        # 8 different groups of 4 banks
        assert len({(c * (qp + 4) // 4) % 8 for c in range(8)}) == 8


@pytest.mark.parametrize("m,q", [(0, 5), (MAX_M + 1, 10), (10, -1)])
def test_car_plan_rejects_what_no_variant_runs(m, q):
    with pytest.raises(ValueError):
        car_plan(m, q)


def test_car_batch_on_cpu_is_the_reference_per_row():
    """A (b, m) batch on the CPU: each row is the reference's own result,
    and nothing launches."""
    rows = [_car_inputs(np.random.default_rng(s), 24, 9, 3) for s in (1, 2, 3)]
    t = lambda k: torch.as_tensor(np.stack([r[k] for r in rows]))
    n_car = car_eliminate.launches
    mu_b, el_b = car_eliminate(t(2), t(0), t(3), 12)
    assert mu_b.shape == el_b.shape == (3, 24)
    for k, (big_n, _, mu, mask) in enumerate(rows):
        want = car_eliminate_reference(torch.as_tensor(mu), torch.as_tensor(big_n),
                                       torch.as_tensor(mask), 12)
        assert torch.equal(mu_b[k], want[0]) and torch.equal(el_b[k], want[1])
    assert car_eliminate.launches == n_car
