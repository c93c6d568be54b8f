"""Parity of the port's kernel recombination (sober_tpu_torch.core.rchq) with
the JAX package on the CPU. Supports are not required to be equal: the
split eigh of a Gram with a degenerate zero eigenspace returns different
bases in torch and JAX, and low-bit differences rotate supports between
equally valid answers (ROADMAP.md, queue 3). The invariants are held
instead: w >= 0, sum w = sum mu and the moment error."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu.core import rchq as jr
from sober_tpu.ops import kernels as jk
from sober_tpu_torch.core import rchq as tr
from sober_tpu_torch.ops.kernels import make_kernel


def _pool(n, d, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)


def _jax_rbf(ls=0.5):
    p = {"lengthscale": jnp.float32(ls), "outputscale": jnp.float32(1.0)}
    return lambda a, b: jk.rbf_gram(p, a, b)


def _torch_rbf(ls=0.5):
    k = make_kernel("rbf", lengthscale=ls, device="cpu")
    return lambda a, b: k.gram(a, b)


@pytest.mark.parametrize("n_test", [15, 31])
def test_nystrom_basis_exact_projector_matches_jax(n_test):
    """The exact-eigh path (n_nys < 384): the projectors u^T u agree; u
    itself is free up to signs and rotations inside degenerate spaces."""
    x = _pool(64, 3, 0)
    k = np.array(_jax_rbf()(jnp.asarray(x), jnp.asarray(x)))
    u_j = np.asarray(jr.nystrom_basis(jnp.asarray(k), n_test))
    u_t = tr.nystrom_basis(torch.as_tensor(k), n_test).numpy()
    assert u_t.shape == (n_test, 64)
    assert np.abs(u_t.T @ u_t - u_j.T @ u_j).max() <= 1e-5


def test_nystrom_basis_randomized_captures_energy():
    """The randomized path (n_nys = 512): deterministic for a given Gram, and
    >= 99% of the top-n_test Rayleigh energy of a rank-n_test Gram."""
    n_nys, n_test = 512, 100
    rng = np.random.default_rng(3)
    v, _ = np.linalg.qr(rng.standard_normal((n_nys, n_test)))
    lam = np.linspace(1.0, 2.0, n_test)
    k = torch.as_tensor((v * lam) @ v.T, dtype=torch.float32)
    u = tr.nystrom_basis(k, n_test)
    assert torch.equal(u, tr.nystrom_basis(k, n_test))
    assert float(torch.trace(u @ k @ u.T)) > 0.99 * lam.sum()


def test_top_breaks_ties_like_jax():
    rng = np.random.default_rng(0)
    x = rng.choice([0.0, 0.0, 0.0, 0.25, 0.5], size=200).astype(np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(x), 57)
    vals_t, idx_t = tr._top(torch.as_tensor(x), 57)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


def _strip(n, n_nys, n_test, seed):
    """A normalized RBF feature strip built in JAX, and weights with zeros."""
    x = _pool(n, 3, seed)
    kern = _jax_rbf()
    u = jr.nystrom_basis(kern(jnp.asarray(x[:n_nys]), jnp.asarray(x[:n_nys])),
                         n_test)
    phi = np.asarray(u @ kern(jnp.asarray(x[:n_nys]), jnp.asarray(x)))
    phi = (phi / np.abs(phi).max()).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    mu = rng.uniform(0, 1, n).astype(np.float32)
    mu[rng.choice(n, n // 4, replace=False)] = 0.0
    return phi, 3.0 * mu / mu.sum(), rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("with_obj", [False, True])
def test_local_reduce_invariants_vs_jax(with_obj, record_property):
    n_test = 15
    phi, mu, obj = _strip(900, 64, n_test, seed=5)
    obj_j = jnp.asarray(obj) if with_obj else None
    obj_t = torch.as_tensor(obj) if with_obj else None
    idx_j, w_j = jr.local_reduce(jnp.asarray(phi), jnp.asarray(mu), n_test + 1,
                                 obj_j)
    idx_t, w_t = tr.local_reduce(torch.as_tensor(phi), torch.as_tensor(mu),
                                 n_test + 1, obj_t)
    idx_t, w_t = idx_t.numpy(), w_t.numpy()
    idx_j, w_j = np.asarray(idx_j), np.asarray(w_j)
    assert idx_t.shape == (n_test + 1,) and (w_t >= 0).all()
    assert len(set(idx_t.tolist())) == n_test + 1
    assert abs(w_t.sum() - mu.sum()) <= 1e-5 * mu.sum()
    want = phi @ mu
    err_t = np.abs(phi[:, idx_t] @ w_t - want).max()
    err_j = np.abs(phi[:, idx_j] @ w_j - want).max()
    assert err_t <= max(2 * err_j, 1e-5)
    support = lambda i, w: set(i[w > 0].tolist())
    record_property("support_overlap",
                    len(support(idx_t, w_t) & support(idx_j, w_j)))


def test_recombination_moment_matching_on_randomized_basis():
    """End to end through the randomized basis (n_nys = 512), as
    tests/test_rchq.py holds the JAX package."""
    n, s = 4000, 32
    x = torch.as_tensor(_pool(n, 4, 10))
    kern = _torch_rbf()
    idx, w = tr.recombination(x, x[:512], s, kern)
    assert abs(float(w.sum()) - 1.0) < 1e-4 and bool((w >= 0).all())
    k_nys = kern(x[:512], x[:512])
    u = tr.nystrom_basis(0.5 * (k_nys + k_nys.T), s - 1)
    phi = u @ kern(x[:512], x)
    phi = phi / phi.abs().max()
    err = (phi[:, idx] @ w - phi @ torch.full((n,), 1.0 / n)).abs().max()
    assert float(err) < 5e-3


def test_recombination_pinned_rows_and_objective():
    """extra_test_rows are matched exactly beside the eigenfunctions; with
    calc_obj riding the tree and the final push as well, the batch's
    objective is at least that of the batch chosen without it."""
    n, s = 1500, 12
    x = torch.as_tensor(_pool(n, 2, 11))
    f = torch.sin(3 * x[:, 0]) + x[:, 1] ** 2
    obj = lambda p: -(p ** 2).sum(1)
    batches = {}
    for name, calc_obj in (("plain", None), ("obj", obj)):
        idx, w = tr.recombination(x, x[:64], s, _torch_rbf(), calc_obj=calc_obj,
                                  extra_test_rows=f[None, :])
        assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-4
        assert len(set(idx.tolist())) == s
        batches[name] = idx, w
    idx, w = batches["plain"]
    assert abs(float(f[idx] @ w) - float(f.mean())) < 1e-5 * float(f.abs().max())
    value = {k: float(obj(x[i]) @ w) for k, (i, w) in batches.items()}
    assert value["obj"] >= value["plain"] - 1e-6
