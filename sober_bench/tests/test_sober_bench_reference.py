"""The float64 reference agrees with itself, and the check of a run comes
out false when the timed path is broken underneath: a fit that returns its
state unchanged, half the batch left out with the weights renormalized over
the rest, and a batch altered where it is produced (an index, or the
weights), for each fault that the cell's check names as seen. Both cells,
at a size a CPU run holds, with the cells' limits. The control (TF32)
exists only on the card: its test is marked cuda."""
import sys

import pytest
import torch

from tiny import REPO, cell

sys.path.insert(0, REPO)
from sober_bench import faults, harness  # noqa: E402
from sober_bench import reference as ref  # noqa: E402

SEED = 2**31 + 77


@pytest.fixture(scope="module", params=["shekel-b100", "solvent-b100"])
def warm_cell(request):
    c = cell(request.param)
    c.warm()
    return c


def run(c, seconds=3.0):
    window_s, starts, _, records, _, _ = c.measure(SEED, seconds)
    assert records, "no round was checked"
    return c.judge(records)


def test_the_sound_path_is_correct(warm_cell):
    correct, checks, failed = run(warm_cell)
    assert correct and failed == 0, checks


def test_the_reference_agrees_with_itself():
    g = torch.Generator().manual_seed(0)
    x = 10 * torch.rand((70, 4), generator=g, dtype=torch.float64)
    y = torch.sin(x).sum(1)
    spec = ref.FitSpec("rbf", 1e-8, 1e-3, 30, 0.1, "adam", 32)
    h1, problem, _ = ref.fit(x, y, spec)
    h2, _, _ = ref.fit(x, y, spec)
    assert all(torch.equal(h1[k], h2[k]) for k in h1)
    assert ref.loss_at(h1, problem, spec) < ref.loss_at(
        ref.hypers(ref.initial_raw(spec, "cpu"), spec), problem, spec)
    post = ref.Posterior(x, y, h1, spec)
    xq = 10 * torch.rand((5000, 4), generator=g, dtype=torch.float64)
    old, ref.BLOCK = ref.BLOCK, 512
    try:
        blocked = post.pi(xq)
    finally:
        ref.BLOCK = old
    assert torch.allclose(blocked, post.pi(xq), rtol=0, atol=1e-12)
    w = torch.rand(5000, generator=g, dtype=torch.float64)
    cov = lambda a, b: post.covariance(a, b, weighted=False)
    # the whole pool as its own batch matches its moments exactly
    gap, top = ref.moment_gap(cov, xq, xq[:200], w, torch.arange(5000), w / w.sum(), 50)
    assert gap < 1e-12 and top < 1e-12
    # a batch with perturbed weights does not
    idx = torch.arange(200)
    w_b = w[idx] / w[idx].sum()
    noise = 1 + 0.5 * torch.rand(200, generator=g, dtype=torch.float64)
    gap_b, top_b = ref.moment_gap(cov, xq, xq[:200], w, idx, w_b * noise, 50)
    assert gap_b > 1e-3 and top_b > 1e-3


def test_the_reference_wkde_follows_the_pool_weights():
    g = torch.Generator().manual_seed(3)
    x = 10 * torch.rand((1000, 4), generator=g)
    w = ref.cleanse(torch.rand(1000, generator=g, dtype=torch.float64))
    pick = torch.randperm(1000, generator=g)[:200]
    assert torch.equal(ref.row_index(x[pick], x), pick)
    weights, cov = ref.wkde_fit(x, w, x[pick])
    assert torch.allclose(weights, w[pick] / w[pick].sum(), rtol=1e-12)
    xc = x[pick].double()
    mean = weights @ xc
    direct = ((xc - mean).T * weights) @ (xc - mean) / (1 - torch.sum(weights ** 2))
    bw2 = torch.sum(weights ** 2) ** (2.0 / 8)
    assert torch.allclose(cov, direct * bw2, rtol=1e-5)
    # the weights follow the pool's: other weights give another proposal
    other, _ = ref.wkde_fit(x, ref.cleanse(w * torch.linspace(0.5, 1.5, 1000,
                                                               dtype=torch.float64)), x[pick])
    assert torch.sum(torch.abs(other - weights)) > 1e-2
    # a component that is not a row of the pool
    off = x[pick].clone()
    off[3, 0] += 1e-3
    assert int(ref.row_index(off, x)[3]) == -1 and ref.wkde_fit(x, w, off) is None
    assert ref.pi_tv(w, w) == 0.0 and ref.pi_tv(w, torch.flip(w, [0])) > 0.1


def test_cleanse_and_top_k():
    w = torch.tensor([3.0, -1.0, 1e-9, 1.0, float("nan")], dtype=torch.float64)
    assert torch.equal(ref.cleanse(torch.nan_to_num(w, nan=-1.0)),
                       torch.tensor([0.75, 0.0, 0.0, 0.25, 0.0], dtype=torch.float64))
    assert ref.top_k(torch.tensor([1.0, 2.0, 2.0, 0.5]), 2).tolist() == [1, 2]


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_broken_path_is_not_correct(warm_cell, fault):
    if fault not in warm_cell.workload["check"]["faults"]:
        pytest.skip(f"{warm_cell.name}'s check does not see {fault} at its size (PERF.md)")
    with faults.planted(warm_cell, fault):
        correct, checks, _ = run(warm_cell)
    assert not correct, (fault, checks)
    # and the path is whole again
    assert run(warm_cell)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["shekel-b100", "solvent-b100"])
def test_the_control_is_not_correct(name):
    """The program with TF32 matmuls on, on the card, at a small size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # Shekel's control shows in the fit of a whole campaign (up to 1,500
    # observations, where float32's fit takes its retry): the cell's own
    # campaigns on a smaller pool
    c = (cell(name, "cuda") if name == "solvent-b100" else
         harness.Cell(name, "cuda", traffic={"n_rec": 20_000}))
    c.warm()
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        correct, checks, _ = run(c, 20.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    assert not correct, checks
