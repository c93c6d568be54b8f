"""The port's device mesh and sharded paths (sober_tpu_torch.parallel)
against the JAX package's on the CPU.

The port's functions run on a mesh of 8 shards on the CPU
(make_mesh(8, devices=["cpu"] * 8)); JAX's on the 8 virtual CPU devices
that tests/conftest.py provides. Both packages take one GP fitted in JAX
and carried over (interop), and the same numpy inputs. Recombination is
held to the eager per-block replica built from the port's local_reduce and
to the quadrature invariants (supports are free between equally valid
answers: ROADMAP.md, queue 3). A mesh of one shard equals each unsharded
counterpart exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu import parallel as jpar
from sober_tpu.gp import exact as jx
from sober_tpu.gp import fbgp as jf
from sober_tpu_torch.apps.bolfi import SOBERUCB
from sober_tpu_torch.core.fused import fused_acquisition
from sober_tpu_torch.core.pi import lfi
from sober_tpu_torch.core.rchq import local_reduce, nystrom_basis, recombination
from sober_tpu_torch.core.rckernel import RecombinationKernel
from sober_tpu_torch.gp.exact import posterior_max_mean, predictive_covariance
from sober_tpu_torch.interop import (fbgp_from_numpy, fbgp_to_numpy,
                                     gp_state_from_numpy, gp_state_to_numpy)
from sober_tpu_torch.parallel import (make_mesh, replicate, shard_candidates,
                                      sharded_acquisition, sharded_barycenter_sums,
                                      sharded_fbgp_batch_predict,
                                      sharded_nystrom_features, sharded_pi_weights,
                                      sharded_recombination)
from sober_tpu_torch.parallel.mesh import Sharded, sweep, to_device
from sober_tpu_torch.utils.linalg import symmetrize
from sober_tpu_torch.utils.weights import cleansing_weights

t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32))


def _pool(n, d, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, d)).astype(np.float32)


def _fitted(n=32, d=2, seed=0):
    """A GP fitted in JAX on n noisy points of [-1, 1]^d, and its port copy
    (a noise well above its floor: the packages' float32 posteriors then
    agree to ~1e-5; ROADMAP.md, queue 3)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(3 * x[:, 0]) + 0.2 * rng.normal(size=n)).astype(np.float32)
    js = jx.fit_gp(jnp.asarray(x), jnp.asarray(y))
    return js, gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(1, devices=["cpu"])


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jpar.make_mesh(8, axis_names=("cand",))


@pytest.fixture(scope="module")
def fitted():
    return _fitted()


# ----------------------------------------------------------------------------
# the mesh
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_factors_as_jax(n):
    """One axis holds n shards; two factor n as JAX's make_mesh does."""
    m = make_mesh(n, devices=["cpu"] * 8)
    assert m.size == n and m.shape == {"cand": n}
    m2 = make_mesh(n, ("a", "b"), devices=["cpu"] * 8)
    assert m2.devices.shape == jpar.make_mesh(n, ("a", "b")).devices.shape
    assert m2.shape == dict(zip(("a", "b"), m2.devices.shape))
    assert len(m2.axis_devices("b")) == m2.shape["b"]


def test_make_mesh_takes_cuda_only():
    """Without devices the mesh takes the visible CUDA cards, and with none
    it raises: no fallback to the CPU."""
    if torch.cuda.is_available():
        assert make_mesh().devices.flat[0] == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(9, devices=["cpu"] * 8)


def test_shard_and_replicate(mesh):
    """Row blocks in order, a length the mesh does not divide refused;
    replicas on one device are the object itself."""
    x = t(_pool(64, 3, 0))
    sh = shard_candidates(mesh, x)
    assert len(sh.blocks) == 8 and sh.shape == (64, 3)
    assert torch.equal(sh.gather(), x)
    with pytest.raises(ValueError, match="divisible"):
        shard_candidates(mesh, x[:63])
    state = {"a": x, "b": [x[:2], (x[0],)]}
    assert all(r is state for r in replicate(mesh, state))


def test_to_device_moves_every_tensor(fitted):
    """A GP state, a kernel adapter and a bound method move to another
    device (here "meta") as new objects holding the tensors there, their
    structure kept; to their own device they come back as themselves."""
    _, state = fitted
    kern = RecombinationKernel(state)
    assert to_device(kern, "cpu") is kern
    moved = to_device(kern.__call__, "meta")
    assert moved.__self__ is not kern and moved.__self__.mode == kern.mode
    m_state = moved.__self__.model
    assert type(m_state) is type(state) and m_state.config is state.config
    assert m_state.x.device.type == "meta" and m_state.chol.device.type == "meta"
    assert state.x.device.type == "cpu"
    assert m_state.kernel.params["lengthscale"].device.type == "meta"


def test_sweep_equals_the_whole_call(mesh, fitted):
    """pi swept shard by shard equals pi over the whole pool; an uneven pool
    is swept whole, or refused when strict."""
    _, state = fitted
    eta = posterior_max_mean(state)
    x = t(_pool(512, 2, 1))
    fn = lambda xb: lfi(state, eta, xb)
    np.testing.assert_allclose(sweep(mesh, fn, x).numpy(), fn(x).numpy(),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(sweep(mesh, fn, x[:509]), fn(x[:509]))
    with pytest.raises(ValueError, match="divisible"):
        sweep(mesh, fn, x[:509], strict=True)


# ----------------------------------------------------------------------------
# the sharded entry points against JAX's
# ----------------------------------------------------------------------------

def test_pi_weights_match_jax(mesh, jmesh, fitted):
    """Per-shard pi with a global normalization: JAX's within atol 1e-6 and
    1e-5 relative, summing to 1."""
    js, state = fitted
    x = _pool(512, 2, 1)
    pdf = np.full(512, 0.25, np.float32)
    want = np.asarray(jpar.sharded_pi_weights(
        jmesh, js, jx.posterior_max_mean(js),
        jpar.shard_candidates(jmesh, jnp.asarray(x)), jnp.asarray(pdf)))
    got = sharded_pi_weights(mesh, state, posterior_max_mean(state), t(x), t(pdf))
    assert isinstance(got, Sharded) and len(got.blocks) == 8
    got = got.gather().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-4


def test_nystrom_features_match_jax(mesh, jmesh, fitted):
    """The sharded strip against JAX's and the port's unsharded product,
    with orthonormal test-function rows as the Nystrom basis has."""
    js, state = fitted
    x = _pool(256, 2, 2)
    u = np.linalg.qr(np.random.default_rng(2).normal(size=(32, 7)))[0].T.astype(np.float32)
    want = np.asarray(jpar.sharded_nystrom_features(
        jmesh, js, jnp.asarray(u), jnp.asarray(x[:32]),
        jpar.shard_candidates(jmesh, jnp.asarray(x))))
    got = sharded_nystrom_features(mesh, state, t(u), t(x[:32]), t(x))
    assert got.dim == 1 and got.shape == (7, 256)
    got = got.gather().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    whole = (t(u) @ predictive_covariance(state, t(x[:32]), t(x))).numpy()
    np.testing.assert_allclose(got, whole, atol=1e-5)


def test_barycenter_sums_match_jax(mesh, jmesh):
    """Per-shard one-hot segment sums and one sum across shards."""
    rng = np.random.default_rng(3)
    n, k, g = 256, 5, 16
    phi = rng.normal(size=(k, n)).astype(np.float32)
    w = rng.uniform(0, 1, n).astype(np.float32)
    gid = rng.integers(0, g, n)
    want = np.asarray(jpar.sharded_barycenter_sums(
        jmesh, jnp.asarray(phi), jnp.asarray(w), jnp.asarray(gid, jnp.int32), g))
    got = sharded_barycenter_sums(mesh, t(phi), t(w), torch.as_tensor(gid), g)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_acquisition_weights_match_jax(mesh, jmesh, fitted):
    """sharded_acquisition's pool weights against JAX's at 1e-5, and its
    batch a valid quadrature."""
    js, state = fitted
    x = _pool(1024, 2, 4)
    pdf = np.full(1024, 0.25, np.float32)
    _, _, jw = jpar.sharded_acquisition(
        jmesh, js, jx.posterior_max_mean(js), jpar.shard_candidates(jmesh, jnp.asarray(x)),
        jnp.asarray(x[:32]), jnp.asarray(pdf), 8)
    idx, w, weights = sharded_acquisition(mesh, state, posterior_max_mean(state), t(x),
                                          t(x[:32]), t(pdf), 8)
    np.testing.assert_allclose(weights.gather().numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    assert idx.shape == w.shape == (8,) and bool((w >= 0).all())
    assert abs(float(w.sum()) - 1.0) < 1e-4


@pytest.fixture(scope="module")
def fbgp():
    """An FBGP of 8 chains built in JAX (tests/test_parallel.py's), and the
    port's copy of it (interop)."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.uniform(-2, 2, (20, 1)), jnp.float32)
    gp = jf.FitboGP(x, jnp.exp(-0.5 * x[:, 0] ** 2))
    hy, lmls = jf.sampling_hypers(gp, jf.RBFHyperPrior(), n_hypers=64,
                                  key=jax.random.key(0))
    w_qd, theta_qd = jf.quadrature_distillation(hy, lmls, n_nys=24, n_qd=8)
    jm = jf.FullyBayesianGP(gp, w_qd, theta_qd)
    return jm, fbgp_from_numpy(fbgp_to_numpy(jm), "cpu")


def test_fbgp_hyper_sharding_matches_jax(fbgp):
    """The FBGP's chains sharded over an 8-shard "hyper" axis give
    marginal_predict and JAX's sharded prediction within 1e-4."""
    jm, pm = fbgp
    xq = np.linspace(-1, 1, 6, dtype=np.float32).reshape(-1, 1)
    jmu, jvar = jpar.sharded_fbgp_batch_predict(
        jpar.make_mesh(8, axis_names=("hyper",)), jm, jnp.asarray(xq))
    hyper = make_mesh(8, ("hyper",), devices=["cpu"] * 8)
    mu, var = sharded_fbgp_batch_predict(hyper, pm, t(xq))
    want_mu, want_var = pm.marginal_predict(t(xq))
    np.testing.assert_allclose(mu.numpy(), want_mu.numpy(), atol=1e-4)
    np.testing.assert_allclose(var.numpy(), want_var.numpy(), atol=1e-4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), atol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        sharded_fbgp_batch_predict(make_mesh(3, ("hyper",), devices=["cpu"] * 3),
                                   pm, t(xq))


# ----------------------------------------------------------------------------
# sharded recombination
# ----------------------------------------------------------------------------

def _basis_strip(kernel, x, x_nys, n_test):
    """The globally scaled feature strip as sharded_recombination forms it."""
    u = nystrom_basis(symmetrize(torch.nan_to_num(kernel(x_nys, x_nys))), n_test)
    phi = u @ kernel(x_nys, x)
    return phi / torch.clamp_min(torch.max(torch.abs(phi)), 1e-30)


def test_sharded_recombination_end_to_end(mesh):
    """The strip never exists whole. (a) deterministic, with moments within
    1e-5 of the same blockwise algorithm staged eagerly (per-block
    local_reduce, then the merge); (b) w >= 0, sum w = 1 and the moments
    of the pool within 3e-4 of their scale; (c) within 6e-4 of the
    unsharded recombination's moments."""
    _, state = _fitted(n=48, d=3, seed=7)
    rng = np.random.default_rng(8)
    n_rec, n_nys, batch = 4096, 128, 16
    x, x_nys = t(_pool(n_rec, 3, 9)), t(_pool(n_nys, 3, 10))
    w0 = t(rng.uniform(0, 1, n_rec))
    w0 = w0 / w0.sum()
    kernel = RecombinationKernel(state)

    x_sh = shard_candidates(mesh, x)
    idx_s, w_s = sharded_recombination(mesh, kernel, x_sh, x_nys, w0, batch)
    idx_s2, w_s2 = sharded_recombination(mesh, kernel, x_sh, x_nys, w0, batch)
    assert torch.equal(idx_s, idx_s2) and torch.equal(w_s, w_s2)

    phi = _basis_strip(kernel, x, x_nys, batch - 1)
    blk = n_rec // 8
    idxs, ws, phis = [], [], []
    for s in range(8):
        sl = slice(s * blk, (s + 1) * blk)
        i_loc, w_loc = local_reduce(phi[:, sl], w0[sl], batch)
        idxs.append(i_loc + s * blk)
        ws.append(w_loc)
        phis.append(phi[:, sl][:, i_loc])
    i_fin, w_fin = local_reduce(torch.cat(phis, 1), torch.cat(ws), batch)
    idx_ref = torch.cat(idxs)[i_fin]
    got = phi[:, idx_s] @ w_s
    assert float((got - phi[:, idx_ref] @ w_fin).abs().max()) < 1e-5

    assert bool((w_s >= 0).all()) and abs(float(w_s.sum()) - 1.0) < 1e-4
    want = phi @ w0
    scale = max(float(want.abs().max()), 1.0)
    assert float((got - want).abs().max()) < 3e-4 * scale
    idx_1, w_1 = recombination(x, x_nys, batch, kernel, init_weights=w0)
    assert float((got - phi[:, idx_1] @ w_1).abs().max()) < 6e-4 * scale


def test_sharded_recombination_calc_obj_and_extra_rows(mesh):
    """With an objective row and two pinned rows: deterministic; the pinned
    rows and the moments matched at the augmented path's 2e-2; w >= 0
    summing to 1; the objective steers the batch; the single-device
    augmented path's objective value within 0.3."""
    _, state = _fitted(n=48, d=3, seed=9)
    rng = np.random.default_rng(10)
    n_rec, n_nys, batch, n_ex = 4096, 64, 12, 2
    x, x_nys = t(_pool(n_rec, 3, 11)), t(_pool(n_nys, 3, 12))
    w0 = t(rng.uniform(0, 1, n_rec))
    w0 = w0 / w0.sum()
    kernel = RecombinationKernel(state)
    calc_obj = lambda xx: torch.sum(xx, dim=-1)
    extra = t(rng.normal(size=(n_ex, n_rec)))

    idx_s, w_s = sharded_recombination(mesh, kernel, x, x_nys, w0, batch,
                                       calc_obj=calc_obj, extra_test_rows=extra)
    idx_s2, w_s2 = sharded_recombination(mesh, kernel, x, x_nys, w0, batch,
                                         calc_obj=calc_obj, extra_test_rows=extra)
    assert torch.equal(idx_s, idx_s2) and torch.equal(w_s, w_s2)

    phi = _basis_strip(kernel, x, x_nys, batch - 1 - n_ex)
    escale = torch.clamp_min(torch.max(torch.abs(extra), dim=1, keepdim=True).values, 1e-30)
    full = torch.cat([phi, extra / escale])
    want = full @ w0
    scale = max(float(want.abs().max()), 1.0)
    assert float((full[:, idx_s] @ w_s - want).abs().max()) < 2e-2 * scale
    assert bool((w_s >= 0).all()) and abs(float(w_s.sum()) - 1.0) < 1e-4

    idx_p, _ = sharded_recombination(mesh, kernel, x, x_nys, w0, batch,
                                     extra_test_rows=extra)
    assert not torch.equal(idx_s, idx_p)
    idx_1, w_1 = recombination(x, x_nys, batch, kernel, init_weights=w0,
                               calc_obj=calc_obj, extra_test_rows=extra)
    assert float((full[:, idx_1] @ w_1 - want).abs().max()) < 2e-2 * scale
    assert float(calc_obj(x[idx_s]) @ w_s) >= float(calc_obj(x[idx_1]) @ w_1) - 0.3


def test_acquisition_equals_the_two_call_composition(mesh, fitted):
    """sharded_acquisition equals sharded_pi_weights followed by
    sharded_recombination over the posterior covariance."""
    _, state = _fitted(n=48, d=3, seed=3)
    eta = posterior_max_mean(state)
    x = t(_pool(4096, 3, 4))
    pdf = torch.full((4096,), 1.0 / 8.0)
    idx, w, weights = sharded_acquisition(mesh, state, eta, x, x[:64], pdf, 8)
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3
    w_ref = sharded_pi_weights(mesh, state, eta, x, pdf)
    assert torch.equal(weights.gather(), w_ref.gather())
    idx_ref, w_quad = sharded_recombination(mesh, RecombinationKernel(state), x, x[:64],
                                            w_ref, 8)
    assert torch.equal(idx, idx_ref)
    np.testing.assert_allclose(w.numpy(), w_quad.numpy(), atol=1e-5)


def test_acquisition_with_an_ucb_row(mesh):
    """SOBERUCB as calc_obj: deterministic, a valid quadrature, pi as the
    unsharded cleansing within 3e-3, and at least 95% of the single-device
    augmented batch's weighted UCB."""
    _, state = _fitted(n=40, d=2, seed=11)
    eta = posterior_max_mean(state)
    ucb = SOBERUCB(state)
    x = t(_pool(4096, 2, 12))
    pdf = torch.full((4096,), 0.25)
    idx_s, w_s, weights = sharded_acquisition(mesh, state, eta, x, x[:64], pdf, 8,
                                              calc_obj=ucb)
    idx_s2, _, _ = sharded_acquisition(mesh, state, eta, x, x[:64], pdf, 8, calc_obj=ucb)
    assert torch.equal(idx_s, idx_s2)
    assert bool((w_s >= 0).all()) and abs(float(w_s.sum()) - 1.0) < 1e-3
    w_ref = cleansing_weights(lfi(state, eta, x) / pdf)
    np.testing.assert_allclose(weights.gather().numpy(), w_ref.numpy(), atol=3e-3)
    idx_1, w_1 = recombination(x, x[:64], 8, lambda a, b: predictive_covariance(state, a, b),
                               init_weights=w_ref, calc_obj=ucb)
    assert float(ucb(x[idx_s]) @ w_s) >= 0.95 * float(ucb(x[idx_1]) @ w_1)


# ----------------------------------------------------------------------------
# a mesh of one shard
# ----------------------------------------------------------------------------

def test_one_shard_equals_the_unsharded_paths(mesh1, fitted):
    """Every entry point on a one-shard mesh equals its unsharded
    counterpart bit for bit."""
    _, state = fitted
    eta = posterior_max_mean(state)
    x = t(_pool(1024, 2, 5))
    pdf = torch.full((1024,), 0.25)
    w = cleansing_weights(lfi(state, eta, x) / pdf)
    assert torch.equal(sharded_pi_weights(mesh1, state, eta, x, pdf).gather(), w)

    u = t(np.random.default_rng(5).normal(size=(7, 32)))
    assert torch.equal(sharded_nystrom_features(mesh1, state, u, x[:32], x).gather(),
                       u @ predictive_covariance(state, x[:32], x))

    gid = torch.as_tensor(np.random.default_rng(6).integers(0, 16, 1024))
    phi = u @ predictive_covariance(state, x[:32], x)
    onehot = (gid[:, None] == torch.arange(16)).to(phi.dtype)
    bary = sharded_barycenter_sums(mesh1, phi, w, gid, 16)
    assert torch.equal(bary, onehot.T @ (phi * w[None, :]).T)
    seg = torch.zeros(16, 7).index_add_(0, gid, (phi * w[None, :]).T)
    np.testing.assert_allclose(bary.numpy(), seg.numpy(), atol=1e-6)

    kernel = RecombinationKernel(state)
    got = sharded_recombination(mesh1, kernel, x, x[:32], w, 8)
    want = recombination(x, x[:32], 8, kernel, init_weights=w)
    assert torch.equal(got.idx, want.idx) and torch.equal(got.w, want.w)

    idx, wq, weights = sharded_acquisition(mesh1, state, eta, x, x[:32], pdf, 8)
    idx_f, wq_f, weights_f = fused_acquisition(state, eta, x, x[:32], pdf, 8)
    assert torch.equal(idx, idx_f) and torch.equal(wq, wq_f)
    assert torch.equal(weights.gather(), weights_f)


def test_one_hyper_shard_equals_marginal_predict(fbgp):
    """sharded_fbgp_batch_predict on one shard equals marginal_predict."""
    _, pm = fbgp
    xq = t(np.linspace(-1, 1, 5).reshape(-1, 1))
    mu, var = sharded_fbgp_batch_predict(make_mesh(1, ("hyper",), devices=["cpu"]), pm, xq)
    want_mu, want_var = pm.marginal_predict(xq)
    assert torch.equal(mu, want_mu) and torch.equal(var, want_var)
