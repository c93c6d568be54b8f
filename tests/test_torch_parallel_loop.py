"""The port's Sober on a device mesh (Sober(mesh=..., schedule=...)) on the
CPU: a mesh of 8 shards on the CPU against mesh=None, and the dataset
domain's pruned pool against the JAX package's mesh-mode Sober on its 8
virtual CPU devices (tests/conftest.py).

gspmd is a placement decision: the same generators draw the same pools,
pi and the proposal agree, and a dataset batch is the same rows. blockwise
recombines by per-shard trees; its batches are held to the invariants.
Both packages' random streams differ, so only the deterministic dataset
pruning is compared across them (tests/test_parallel.py holds JAX's own
mesh mode)."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sober_tpu import Sober as JaxSober
from sober_tpu import parallel as jpar
from sober_tpu.gp import exact as jx
from sober_tpu.priors.dataset import DatasetPrior as JaxDatasetPrior
from sober_tpu_torch import Sober
from sober_tpu_torch.gp.exact import fit_gp
from sober_tpu_torch.gp.fbgp import RBFHyperPrior
from sober_tpu_torch.interop import (dataset_prior_from_numpy, gp_state_from_numpy,
                                     gp_state_to_numpy)
from sober_tpu_torch.parallel import make_mesh
from sober_tpu_torch.priors import Uniform

BOX = torch.tensor([[-1.0, -1.0], [1.0, 1.0]])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


def _state(seed, y_fn, noise=0.0, n=24):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32)
    y = y_fn(x) + noise * torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    return x, y, fit_gp(x, y)


def _uniform():
    return Uniform(BOX, device="cpu")


def _check_batch(xb, batch):
    assert xb.shape == (batch, 2)
    assert bool(torch.isfinite(xb).all()) and bool((xb.abs() <= 1.0 + 1e-6).all())


def test_schedule_and_mesh_are_checked(mesh):
    """Only "gspmd" and "blockwise" are schedules, and the mesh's first
    device must be the prior's."""
    _, _, state = _state(20, lambda x: torch.sin(3 * x[:, 0]))
    with pytest.raises(ValueError, match="gspmd"):
        Sober(_uniform(), state, mesh=mesh, schedule="shard_map")
    with pytest.raises(ValueError, match="first device"):
        Sober(_uniform(), state, mesh=make_mesh(2, devices=["meta", "cpu"]))


def test_gspmd_matches_single_device_continuous(mesh):
    """The same generators give the same draws; pi within 3e-3; next_batch
    moves the proposal to the same family, and the batch's mean pi is above
    a quarter of mesh=None's."""
    _, _, state = _state(20, lambda x: torch.sin(3 * x[:, 0]) * torch.cos(2 * x[:, 1]))
    sober_1 = Sober(_uniform(), state, seed=4)
    sober_m = Sober(_uniform(), state, seed=4, mesh=mesh)
    x1, w1 = sober_1.sampling(2048)
    xm, wm = sober_m.sampling(2048)
    assert torch.equal(xm, x1)
    np.testing.assert_allclose(wm.numpy(), w1.numpy(), atol=3e-3)

    xb_1 = sober_1.next_batch(2048, 64, 8)
    xb_m = sober_m.next_batch(2048, 64, 8)
    _check_batch(xb_m, 8)
    assert type(sober_m.prior) is type(sober_1.prior)
    assert float(sober_m.pi(xb_m).mean()) > 0.25 * float(sober_1.pi(xb_1).mean())


@pytest.fixture(scope="module")
def dataset():
    """tests/test_parallel.py's dataset: 2048 rows of 8 features, a GP fitted
    in JAX on the first 40 and carried over."""
    rng = np.random.default_rng(21)
    feats = rng.uniform(-1, 1, (2048, 8)).astype(np.float32)
    targs = (np.sin(3 * feats[:, 0]) + 0.1 * rng.normal(size=2048)).astype(np.float32)
    js = jx.fit_gp(jnp.asarray(feats[:40]), jnp.asarray(targs[:40]))
    return feats, targs, js, gp_state_from_numpy(gp_state_to_numpy(js), device="cpu")


def test_gspmd_matches_single_device_dataset(mesh, dataset):
    """The pi sweep over the sharded pool and the pruning select the same
    rows as mesh=None; the pruned pool is JAX's mesh-mode one."""
    feats, targs, js, state = dataset
    prior = dataset_prior_from_numpy(feats, targs, device="cpu")
    idx_1, xb_1 = Sober(prior, state, seed=5).next_batch(256, 32, 8)
    sober_m = Sober(prior, state, seed=5, mesh=mesh)
    idx_m, xb_m = sober_m.next_batch(256, 32, 8)
    assert torch.equal(idx_m, idx_1) and torch.equal(xb_m, xb_1)

    jsober = JaxSober(JaxDatasetPrior(jnp.asarray(feats), jnp.asarray(targs)), js,
                      seed=5, mesh=jpar.make_mesh(8, axis_names=("cand",)))
    jidx = np.asarray(jsober.sampling_datasets(256, 32)[0])
    idx_s = sober_m.sampling_datasets(256, 32)[0]
    assert set(idx_s.tolist()) == set(jidx.tolist())


def test_blockwise_dataset_batch(mesh, dataset):
    """A blockwise dataset batch: distinct rows of the pool, weights >= 0
    summing to 1."""
    feats, targs, _, state = dataset
    sober = Sober(dataset_prior_from_numpy(feats, targs, device="cpu"), state, seed=5,
                  mesh=mesh, schedule="blockwise")
    w, xb = sober.next_batch(256, 32, 8, return_weights=True)
    idx, _ = sober.next_batch(256, 32, 8)
    assert len(set(idx.tolist())) == 8 and int(idx.max()) < 2048
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-4


def test_blockwise_schedule_full_pipeline(mesh):
    """blockwise drives the learned-proposal pipeline through the sharded
    recombination with no warning (the port has no fused/staged split):
    two valid batches, a refit proposal, and a pool the mesh does not
    divide refused."""
    _, _, state = _state(22, lambda x: torch.sin(3 * x[:, 0]))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sober = Sober(_uniform(), state, seed=6, mesh=mesh, schedule="blockwise")
    prior0 = sober.prior
    for _ in range(2):
        _check_batch(sober.next_batch(2048, 64, 8), 8)
    assert sober.prior is not prior0
    with pytest.raises(ValueError, match="divisible"):
        sober.next_batch(1001, 64, 8)


def test_step_on_mesh(mesh):
    """Sober.step (the refit and the acquisition) on the mesh: a valid
    batch whose mean pi is above a quarter of mesh=None's."""
    x, y, state = _state(31, lambda x: torch.sin(3 * x[:, 0]), noise=0.05)
    sober_m = Sober(_uniform(), state, seed=12, mesh=mesh)
    xb_m = sober_m.step(x, y, 2048, 64, 8)
    _check_batch(xb_m, 8)
    sober_1 = Sober(_uniform(), state, seed=12)
    xb_1 = sober_1.step(x, y, 2048, 64, 8)
    assert float(sober_m.pi(xb_m).mean()) > 0.25 * float(sober_1.pi(xb_1).mean())


def test_step_fbgp_on_mesh(mesh):
    """Sober.step_fbgp on the mesh: the sampler carries the refit FBGP, the
    batch is valid, and its mean pi is above a quarter of mesh=None's."""
    x, y, state = _state(33, lambda x: torch.exp(-0.5 * torch.sum((x / 0.6) ** 2, dim=1)),
                         noise=0.01)
    kw = dict(n_hypers=64, n_nys_qd=16, n_qd=8)
    hp = RBFHyperPrior(device="cpu")
    sober_m = Sober(_uniform(), state, seed=14, mesh=mesh)
    xb_m = sober_m.step_fbgp(x, y, hp, 2048, 64, 8, **kw)
    _check_batch(xb_m, 8)
    assert sober_m.fbgp and 0 < int(sober_m.last_npos) <= 2048
    sober_1 = Sober(_uniform(), state, seed=14)
    xb_1 = sober_1.step_fbgp(x, y, hp, 2048, 64, 8, **kw)
    assert float(sober_m.pi(xb_m).mean()) > 0.25 * float(sober_1.pi(xb_1).mean())
