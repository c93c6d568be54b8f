"""The port's CUDA kernels against their plain PyTorch references, on the
card. Every test is marked `cuda` and skips without a CUDA device. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from sober_tpu_torch.core.rchq import null_basis
from sober_tpu_torch.ops.car import (MAX_M, car_eliminate, car_eliminate_reference,
                                     car_plan, reference_horizon)
from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference
from sober_tpu_torch import DatasetPrior, Sober, fit_tanimoto_gp
from sober_tpu_torch.ops.tanimoto_gram import (POOLS, check_fingerprints,
                                               pack_bits, pack_bits_reference,
                                               tanimoto_gram_packed,
                                               tanimoto_similarity,
                                               tanimoto_similarity_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,ard", [(512, 65536, 10, False),
                                       (65536, 500, 10, True),
                                       (70, 130, 3, True), (1, 1, 64, False),
                                       (500, 200000, 4, False),
                                       (200, 500, 10, False), (1, 500, 4, True),
                                       (257, 130, 33, True), (65, 7, 100, False),
                                       (130, 700, 100, True),
                                       (13000, 200, 6, True), (30000, 130, 3, False),
                                       (200000, 500, 24, False), (500, 200000, 24, True),
                                       (20000, 500, 23, True), (500, 500, 15, False),
                                       (512, 500, 7, True)])
def test_rbf_kernel_matches_reference_on_card(cuda, n, m, d, ard):
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    # past 32 features, coordinates in [-0.3, 0.3]: entries stay far from 0
    # and the reference's norm trick stays accurate to ~1e-7
    scale = 1.0 if d <= 32 else 0.3
    x = t(rng.uniform(-scale, scale, (n, d)))
    y = t(rng.uniform(-scale, scale, (m, d)))
    ls = t(rng.uniform(0.5, 1.5, d)) if ard else t(0.8)
    p = {"lengthscale": ls, "outputscale": t(1.3)}
    before = rbf_gram.launches
    got = rbf_gram(p, x, y)
    torch.cuda.synchronize()
    assert rbf_gram.launches == before + 1
    # direct differences against the reference's norm trick; the kernel's
    # ex2.approx.ftz gives 0 where the reference keeps a denormal, which is
    # below 1.2e-38 apart
    assert float((got - rbf_gram_reference(p, x, y)).abs().max()) <= 1.3e-5
    # and against float64 direct differences, on the first rows
    xs, ys = x[:64].double() / ls.double(), y.double() / ls.double()
    exact = 1.3 * torch.exp(-0.5 * ((xs[:, None] - ys[None]) ** 2).sum(-1))
    assert float((got[:64].double() - exact).abs().max()) <= 1.3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 4, 40])
def test_rbf_kernel_takes_rows_off_16_byte_boundaries(cuda, d):
    """Operands that start one float into their storage: bases that are not
    16-byte aligned are copied 4 bytes at a time."""
    rng = np.random.default_rng(d)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    x = t(rng.uniform(-0.5, 0.5, 300 * d + 1))[1:].view(300, d)
    y = t(rng.uniform(-0.5, 0.5, 128 * d + 1))[1:].view(128, d)
    assert x.data_ptr() % 16 and y.data_ptr() % 16
    p = {"lengthscale": t(rng.uniform(0.5, 1.5, d)), "outputscale": t(0.7)}
    got = rbf_gram(p, x, y)
    torch.cuda.synchronize()
    assert float((got - rbf_gram_reference(p, x, y)).abs().max()) <= 1.3e-5


@pytest.mark.cuda
def test_rbf_kernel_rejects_what_it_cannot_run(cuda):
    x = torch.zeros((4, 3), device=cuda)
    p = {"lengthscale": torch.tensor(1.0, device=cuda),
         "outputscale": torch.tensor(1.0, device=cuda, requires_grad=True)}
    with pytest.raises(ValueError, match="requires grad"):
        rbf_gram(p, x, x)
    p["outputscale"] = torch.tensor(1.0, device=cuda)
    with pytest.raises(TypeError):
        rbf_gram(p, x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rbf_gram(p, torch.zeros((3, 4), device=cuda).T, x)
    with pytest.raises(ValueError, match="at least one feature"):
        rbf_gram(p, torch.zeros((4, 0), device=cuda), torch.zeros((5, 0), device=cuda))


def _car_problem(m, q, seed, device):
    """A CAR on m points with m - q moments and 7 padding rows, from a numpy
    seed: (x, mu, mask, big_n, n_take, active0)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    x = t(rng.normal(size=(m, m - q)))
    mu = rng.uniform(0.1, 1.0, m)
    mask = np.ones(m)
    mask[-7:] = mu[-7:] = 0.0
    mu, mask = t(mu / mu.sum()), t(mask)
    big_n, n_take, active0 = null_basis(x, mu, m - q, mask)
    return x, mu, mask, big_n, n_take, active0


@pytest.mark.cuda
@pytest.mark.parametrize("m,q,variant", [(400, 200, "cluster"), (390, 197, "cluster"),
                                         (200, 100, "smem"), (64, 47, "smem"),
                                         (1000, 500, "l2")])
def test_car_kernel_matches_reference_on_card(cuda, m, q, variant):
    """Each variant at its shapes: the invariants over the full run, the
    reference's elimination count, and an exact match up to the horizon."""
    x, mu, mask, big_n, n_take, active0 = _car_problem(m, q, m, cuda)
    assert car_plan(m, n_take).variant == variant
    before = car_eliminate.variant_launches[variant]
    mu_k, el_k = car_eliminate(mu, big_n, mask, n_take)
    mu_r, el_r = car_eliminate_reference(mu, big_n, mask, n_take)
    torch.cuda.synchronize()
    assert car_eliminate.variant_launches[variant] == before + 1
    w_k = mu_k * (1 - el_k) * active0
    assert bool((w_k >= 0).all()) and bool((w_k[-7:] == 0).all())
    assert float((x.T @ w_k - x.T @ mu).abs().max()) < 1e-4
    assert int(el_k.sum()) == int(el_r.sum())
    k = reference_horizon(mu, big_n, mask, n_take)
    assert k >= 10
    mu_k, el_k = car_eliminate(mu, big_n, mask, k)
    mu_r, el_r = car_eliminate_reference(mu, big_n, mask, k)
    assert torch.equal(el_k, el_r)
    assert float((mu_k - mu_r).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,q,batch", [(400, 200, 2), (200, 100, 3), (1000, 500, 2)])
def test_car_kernel_batch_equals_single_runs(cuda, m, q, batch):
    """A grid of independent CARs (batch blocks or clusters): each row is bit
    for bit the kernel's own single run on that row."""
    probs = [_car_problem(m, q, m + s, cuda) for s in range(batch)]
    n_take = min(p[4] for p in probs)
    mu = torch.stack([p[1] for p in probs])
    mask = torch.stack([p[2] for p in probs])
    big_n = torch.stack([p[3][:, :n_take] for p in probs]).contiguous()
    mu_b, el_b = car_eliminate(mu, big_n, mask, n_take)
    for k in range(batch):
        mu_1, el_1 = car_eliminate(mu[k], big_n[k].contiguous(), mask[k], n_take)
        assert torch.equal(mu_b[k], mu_1) and torch.equal(el_b[k], el_1)
        assert int(el_1.sum()) > 0


@pytest.mark.cuda
def test_car_kernel_rejects_what_it_cannot_run(cuda):
    mu = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="n_take"):
        car_eliminate(mu, torch.zeros((8, 4), device=cuda), mu, 5)
    with pytest.raises(TypeError):
        car_eliminate(mu.double(), torch.zeros((8, 4), device=cuda).double(),
                      mu.double(), 2)
    with pytest.raises(ValueError, match="outside"):
        car_eliminate(torch.zeros(MAX_M + 1, device=cuda),
                      torch.zeros((MAX_M + 1, 1), device=cuda),
                      torch.zeros(MAX_M + 1, device=cuda), 1)


def _bits(rng, n, d, zero_rows=()):
    x = (rng.random((n, d)) < 0.025).astype(np.float32)
    x[list(zero_rows)] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [(4096, 512, 2048), (500, 2000, 2048),
                                   (1000, 777, 300), (1, 1, 1), (65, 130, 4100),
                                   (133, 64, 2048), (17, 9, 31)])
def test_tanimoto_kernel_matches_reference_on_card(cuda, n, m, d):
    """Exact integer intersections and the same fp32 division: the kernel
    equals the reference bit for bit, all-zero rows included, and matches a
    float64 oracle to 1e-6. The shapes cross the 128 x 128 tile's edges,
    word counts that are not a multiple of 4 and d past one 2048-bit
    ring."""
    rng = np.random.default_rng(n + d)
    x = _bits(rng, n, d, zero_rows=(0,) if n > 1 else ())
    y = _bits(rng, m, d, zero_rows=(m - 1,) if m > 1 else ())
    xt, yt = (torch.as_tensor(a, device=cuda) for a in (x, y))
    before = tanimoto_gram_packed.launches
    got = tanimoto_similarity(xt, yt)
    torch.cuda.synchronize()
    assert tanimoto_gram_packed.launches == before + 1
    assert torch.equal(got, tanimoto_similarity_reference(xt, yt))
    xy = x.astype(np.float64) @ y.T.astype(np.float64)
    oracle = xy / np.maximum(x.sum(1)[:, None] + y.sum(1)[None, :] - xy, 1e-20)
    assert np.abs(got.cpu().numpy() - oracle).max() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 300, 33])
def test_pack_kernel_matches_reference_on_card(cuda, d):
    rng = np.random.default_rng(d)
    x = torch.as_tensor(_bits(rng, 333, d, zero_rows=(5,)), device=cuda)
    words, counts = pack_bits(x)
    want_words, want_counts = pack_bits_reference(x.cpu())
    assert torch.equal(words.cpu(), want_words)
    assert torch.equal(counts.cpu(), want_counts)
    assert torch.equal(counts.cpu(), x.sum(1).to(torch.int32).cpu())


@pytest.mark.cuda
def test_tanimoto_kernel_rejects_what_it_cannot_run(cuda):
    """A value other than 0 or 1 (NaN included) makes its row NaN and the
    rest exact, with no host read; check_fingerprints then raises once and
    resets. Wrong types, grads and layouts raise at the call."""
    check_fingerprints(cuda)
    x = torch.as_tensor(_bits(np.random.default_rng(1), 40, 64), device=cuda)
    want = tanimoto_similarity_reference(x, x)
    for bad in (0.5, float("nan")):
        xb = x.clone()
        xb[1, 3] = bad
        got = tanimoto_similarity(xb, x)
        assert bool(torch.isnan(got[1]).all())
        keep = torch.arange(40, device=cuda) != 1
        assert torch.equal(got[keep], want[keep])
        assert bool(torch.isnan(tanimoto_similarity(x, xb)[:, 1]).all())
        assert int(pack_bits(xb)[1][1]) == -1
        with pytest.raises(ValueError, match="only 0 and 1"):
            check_fingerprints(cuda)
        check_fingerprints(cuda)
    with pytest.raises(TypeError):
        tanimoto_similarity(x.double(), x.double())
    with pytest.raises(ValueError, match="requires grad"):
        tanimoto_similarity(x.clone().requires_grad_(True), x)
    with pytest.raises(ValueError, match="contiguous"):
        tanimoto_similarity(torch.zeros((64, 40), device=cuda).T, x)


@pytest.mark.cuda
def test_dataset_pool_is_packed_once(cuda):
    """A DatasetPrior's features are packed at the first Gram that takes
    them and reused across next_batch calls; a write to them makes the
    next Gram repack. A pool holding a 0.5 raises at its first Gram."""
    rng = np.random.default_rng(3)
    feats = _bits(rng, 3000, 256)
    targets = rng.normal(size=3000).astype(np.float32)
    prior = DatasetPrior(feats, targets, device=cuda)
    x_obs, y_obs = prior.sample(torch.Generator(device=cuda).manual_seed(0), 64)
    sober = Sober(prior, fit_tanimoto_gp(x_obs, y_obs),
                  kernel_type="weighted_predictive_covariance")
    packs, reads = POOLS.packs, check_fingerprints.reads
    for _ in range(2):
        sober.next_batch(300, 40, 8)
    assert POOLS.packs == packs + 1
    # one read at the pool's pack, one at the end of each next_batch
    assert check_fingerprints.reads == reads + 3
    prior.features.add_(0.0)
    sober.next_batch(300, 40, 8)
    assert POOLS.packs == packs + 2
    feats[7, 9] = 0.5
    bad = DatasetPrior(feats, targets, device=cuda)
    with pytest.raises(ValueError, match="only 0 and 1"):
        tanimoto_similarity(bad.features, x_obs)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,ard", [(8, 512, False), (8, 512, True),
                                     (500, 20000, False)])
def test_rbf_gradient_matches_reference_on_card(cuda, n, m, ard):
    """The autograd Function (kernel forward, plain backward from the saved
    Gram) against autograd through the reference, in x and y: relative
    1e-5 of the largest gradient entry."""
    rng = np.random.default_rng(n + m)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    x, y = t(rng.uniform(0, 10, (n, 4))), t(rng.uniform(0, 10, (m, 4)))
    p = {"lengthscale": t(rng.uniform(1.0, 3.0, 4)) if ard else t(2.0),
         "outputscale": t(1.3)}
    g = t(rng.normal(size=(n, m)))
    grads = []
    for fn in (rbf_gram, rbf_gram_reference):
        a, b = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        before = rbf_gram.launches
        torch.sum(fn(p, a, b) * g).backward()
        assert rbf_gram.launches == before + (fn is rbf_gram)
        grads.append((a.grad, b.grad))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_continuous_next_batch_on_card(cuda):
    """Sober on a Uniform proposal over Shekel's box, on the card: the RBF
    Gram and CAR launch, the proposal moves on to a WKDE, and the batches
    (plain, weighted, polished, and from step) keep their invariants."""
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.priors import WeightedKernelDensityEstimation
    from sober_tpu_torch.tasks.synthetic import setup_shekel

    prior, f = setup_shekel(device=cuda)
    x = prior.sample(None, 60)
    y = f(x)
    sober = Sober(prior, fit_gp_padded(x, y))
    rbf0, car0 = rbf_gram.launches, car_eliminate.launches
    w, xb = sober.next_batch(20000, 200, 20, return_weights=True)
    assert rbf_gram.launches > rbf0 and car_eliminate.launches > car0
    assert isinstance(sober.prior, WeightedKernelDensityEstimation)
    assert xb.shape == (20, 4) and bool(torch.isfinite(xb).all())
    # a WKDE clips its last outside draws onto the box: the closed box
    assert bool(((xb >= 0) & (xb <= 10)).all())
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3
    xb = sober.next_batch(20000, 200, 20, polish=True)
    assert bool(((xb >= 0) & (xb <= 10)).all()) and bool(torch.isfinite(xb).all())
    x, y = torch.cat([x, xb]), torch.cat([y, f(xb)])
    xb = sober.step(x, y, 20000, 200, 20, warm_start=True)
    assert xb.shape == (20, 4) and bool(((xb >= 0) & (xb <= 10)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["binary", "mixedcategorical"])
def test_discrete_next_batch_on_card(cuda, label):
    """Sober on the Ising edge masks (binary) and on the mixed Rosenbrock,
    on the card: the RBF Gram and CAR launch, the batches are legal (0/1
    edges; the four category values and the closed box), the weights >= 0
    sum to 1, and step acquires a legal batch too."""
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.tasks import setup_ising, setup_rosenbrock

    prior, f = (setup_ising if label == "binary" else setup_rosenbrock)(device=cuda)
    x = prior.sample(torch.Generator(device=cuda).manual_seed(0), 60)
    y = f(x)
    sober = Sober(prior, fit_gp_padded(x, y))
    rbf0, car0 = rbf_gram.launches, car_eliminate.launches

    def legal(xb):
        if label == "binary":
            return bool(((xb == 0) | (xb == 1)).all())
        cats = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=cuda)
        return (bool(torch.isin(xb[:, 1:], cats).all())
                and bool((xb[:, 0].abs() <= 4).all()))

    w, xb = sober.next_batch(20000, 200, 20, return_weights=True)
    assert rbf_gram.launches > rbf0 and car_eliminate.launches > car0
    assert xb.shape == (20, prior.n_dims) and legal(xb)
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3
    x, y = torch.cat([x, xb]), torch.cat([y, f(xb)])
    xb = sober.step(x, y, 20000, 200, 20, warm_start=True)
    assert xb.shape == (20, prior.n_dims) and legal(xb)


def _fbgp_cpu_and_card(cuda, n_obs=30, d=3):
    """An FBGP refit on the CPU (plain references) on bench.py's surface at
    a small size, and the same model with its tensors moved to the card."""
    from sober_tpu_torch.gp.fbgp import (ChainCache, FitboGP, FullyBayesianGP,
                                         RBFHyperPrior, fbgp_refit)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (n_obs, d)), dtype=torch.float32)
    y = torch.exp(-0.5 * torch.sum((x / 0.6) ** 2, dim=1))
    cpu = fbgp_refit(FitboGP(x, y, bucket=32), RBFHyperPrior(device="cpu"),
                     n_hypers=100, n_nys=32, n_qd=12)
    g = lambda a: None if a is None else a.to(cuda)
    card = FullyBayesianGP.from_arrays(
        g(cpu.Xobs), g(cpu.fobs), g(cpu.mask), g(cpu.eta), g(cpu.w_qd),
        g(cpu.Theta_qd), ChainCache(*map(g, cpu._cache)))
    return cpu, card, rng


@pytest.mark.cuda
def test_fbgp_chain_predict_and_kernel_on_card(cuda):
    """The FBGP's chain predictions (one RBF launch a chain for K(x, X_obs),
    the batched L^-1 product), its marginal covariance (the recombination
    kernel) on the card against the same model on the CPU, within 1e-5 of
    their scale; pi within 2e-4: its z = (mu_f - eta) / sd takes the
    difference of two O(1) numbers over an sd down to ~1e-2, so the
    predictions' 1e-5 moves pi by up to ~1e-4 (6.3e-5 measured on an
    H100)."""
    from sober_tpu_torch.gp.fbgp import PIFBGP

    cpu, card, rng = _fbgp_cpu_and_card(cuda)
    xq = torch.as_tensor(rng.uniform(-1, 1, (700, 3)), dtype=torch.float32)
    yq = xq[::7] + 0.01
    before = rbf_gram.launches
    got = card.batch_predict(xq.to(cuda))
    assert rbf_gram.launches == before + cpu.Theta_qd.shape[0]
    for a, b in zip(got, cpu.batch_predict(xq)):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())
    want = cpu.rc_kernel()(xq, yq)
    got = card.rc_kernel()(xq.to(cuda), yq.to(cuda)).cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    want = PIFBGP(cpu)(xq)
    assert float((PIFBGP(card)(xq.to(cuda)).cpu() - want).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_step_fbgp_on_card(cuda):
    """Sober.step_fbgp on the card at a small config of bench.py's FBGP
    step: the RBF Gram and CAR launch, the batch is legal, the model is the
    refit FBGP, and an MES-augmented step works too."""
    from sober_tpu_torch.gp.fbgp import FullyBayesianGP, RBFHyperPrior
    from sober_tpu_torch.priors import Uniform

    cpu, card, rng = _fbgp_cpu_and_card(cuda)
    sober = Sober(Uniform([[-1.0] * 3, [1.0] * 3], device=cuda), card)
    x = torch.as_tensor(rng.uniform(-1, 1, (40, 3)), dtype=torch.float32, device=cuda)
    y = torch.exp(-0.5 * torch.sum((x / 0.6) ** 2, dim=1))
    hp = RBFHyperPrior(device=cuda)
    rbf0, car0 = rbf_gram.launches, car_eliminate.launches
    w, xb = sober.step_fbgp(x, y, hp, 4096, 128, 20, n_hypers=200, n_nys_qd=50,
                            n_qd=20, return_weights=True)
    assert rbf_gram.launches > rbf0 and car_eliminate.launches > car0
    assert xb.shape == (20, 3) and bool(((xb >= -1) & (xb <= 1)).all())
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3
    assert isinstance(sober.pi.model, FullyBayesianGP)
    assert sober.pi.model.Xobs.device.type == "cuda"
    xb = sober.step_fbgp(x, y, hp, 4096, 128, 20, n_hypers=200, n_nys_qd=50,
                         n_qd=20, calc_obj="MES")
    assert xb.shape == (20, 3) and bool(torch.isfinite(xb).all())


@pytest.mark.cuda
def test_kmeans_is_reproducible_on_card(cuda):
    """KMeans on the card gives the same centroids bit for bit on a repeat
    (its M-step is a one-hot matmul; index_add_'s atomics summed in no
    fixed order)."""
    from sober_tpu_torch.ops.kmeans import kmeans

    x = torch.rand((4096, 6), generator=torch.Generator().manual_seed(0))
    a = kmeans(x.to(cuda), 256)[1]
    b = kmeans(x.to(cuda), 256)[1]
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_mvn_cdf_and_gradients_on_card(cuda):
    """The Genz CDF and its closed-form gradients on the card against the
    CPU at d = 5 (the same Sobol nodes on both): the values 1e-5 relative,
    the gradients in value and covariance 1e-4 of their largest entry."""
    from sober_tpu_torch.priors import multivariate_normal_cdf

    rng = np.random.default_rng(5)
    a = rng.normal(size=(5, 5))
    cov = (a @ a.T + 5 * np.eye(5)).astype(np.float32)
    val = rng.normal(size=(3, 5)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        v = torch.tensor(val, device=dev, requires_grad=True)
        c = torch.tensor(cov, device=dev, requires_grad=True)
        p = multivariate_normal_cdf(v, torch.zeros(5, device=dev), c)
        p.sum().backward()
        out[str(dev)] = [t.detach().cpu() for t in (p, v.grad, c.grad)]
    (p_c, gv_c, gc_c), (p_g, gv_g, gc_g) = out["cpu"], out["cuda"]
    assert float(((p_g - p_c).abs() / p_c).max()) < 1e-5
    for g, c in ((gv_g, gv_c), (gc_g, gc_c)):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())


@pytest.mark.cuda
def test_truncated_gaussian_next_batch_on_card(cuda):
    """Sober on the ECM task's truncated-Gaussian prior on the card: the
    prior's constant and density as on the CPU (1e-5 relative), batches
    inside the box with legal weights, and both regimes' draws inside their
    boxes."""
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.priors import TruncatedGaussian
    from sober_tpu_torch.tasks import setup_ecm_two

    prior, sim = setup_ecm_two(device=cuda)
    prior_c, sim_c = setup_ecm_two(device="cpu")
    assert abs(float(prior.constant) - float(prior_c.constant)) <= 1e-5 * float(prior_c.constant)
    # the observations' noise is drawn on the CPU on both: equal to 1e-5 of
    # the spectrum's scale (a noise drawn apart differs by its sd, 0.26)
    for got, want in ((sim.reZ, sim_c.reZ), (sim.imZ, sim_c.imZ)):
        assert float((got.cpu() - want).abs().max() / want.abs().max()) < 1e-5
    theta = torch.as_tensor(np.random.default_rng(1).uniform(1.0, 2.0, (64, 5)),
                            dtype=torch.float32)
    want = prior_c.pdf(theta)
    assert float(((prior.pdf(theta.to(cuda)).cpu() - want).abs() / want.clamp_min(1e-30)).max()) < 1e-5
    x = prior.sample(torch.Generator(device=cuda).manual_seed(0), 40)
    d, _ = sim(x)
    sober = Sober(prior, fit_gp_padded(x, d, bucket=64), seed=3)
    lo, hi = prior.bounds
    w, xb = sober.next_batch(2048, 64, 8, return_weights=True)
    assert xb.shape == (8, 5) and bool(((xb >= lo) & (xb <= hi)).all())
    assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-4
    unit = [[0.0, 0.0], [1.0, 1.0]]
    for mu, cov, gibbs in (([0.5, 0.5], 0.3, False), ([3.0, 3.0], 0.25, True)):
        tg = TruncatedGaussian(mu, cov * np.eye(2), unit, device=cuda)
        assert tg._use_gibbs == gibbs
        s = tg.sample(torch.Generator(device=cuda).manual_seed(1), 4096)
        assert bool(torch.isfinite(s).all()) and bool(((s >= 0) & (s <= 1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["ts", "dts", "sober_ts", "turbo", "hallucination"])
def test_baseline_batch_on_card(cuda, method):
    """A batch-BO baseline on a padded Branin state on the card: its
    posterior Grams launch the RBF kernel (SOBER-TS also CAR), the batch is
    finite, of its shape and inside the box, TS's rows distinct."""
    from sober_tpu_torch.benchmarks import batch_bo as bo
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.tasks import setup_branin

    prior, f = setup_branin(device=cuda)
    x = prior.sample(None, 10)
    model = fit_gp_padded(x, f(x))
    gen = torch.Generator(device=cuda).manual_seed(0)
    run = {"ts": lambda: bo.thompson_sampling(gen, model, prior, 1024, 8),
           "dts": lambda: bo.decoupled_thompson_sampling(gen, model, prior, 2048, 8),
           "sober_ts": lambda: bo.sober_ts(gen, model, prior, 8, n_cand_super=2048,
                                           n_cand=256, n_nys=64),
           "turbo": lambda: bo.turbo(gen, bo.TurboState(dim=2, batch_size=8), model, prior, 8),
           "hallucination": lambda: bo.hallucination(
               gen, model, lambda a, b: fit_gp_padded(a, b), prior, 2)}[method]
    rbf0, car0 = rbf_gram.launches, car_eliminate.launches
    xb = run()
    assert rbf_gram.launches > rbf0
    assert (car_eliminate.launches > car0) == (method == "sober_ts")
    lo, hi = prior.bounds
    assert xb.device.type == "cuda" and xb.shape == ((2, 2) if method == "hallucination"
                                                     else (8, 2))
    assert bool(torch.isfinite(xb).all()) and bool(((xb >= lo) & (xb <= hi)).all())
    if method == "ts":
        assert len(torch.unique(xb, dim=0)) == 8


@pytest.mark.cuda
def test_icm_fit_on_card(cuda):
    """fit_icm_gp on the card against the CPU on the same data: the loss at
    the CPU fit's raw parameters within 1e-4 relative, and the card's
    fitted loss within 1e-3 of the CPU's; the joint covariances factor."""
    from sober_tpu_torch.gp import multitask as mt

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (64, 6)).astype(np.float32)
    y = np.stack([np.sin(2 * x[:, 0]), x[:, 1] * x[:, 2], np.cos(x[:, 3]) + x[:, 0]], 1)
    y = (y + 0.03 * rng.normal(size=y.shape)).astype(np.float32)
    ys = (y - y.mean(0)) / y.std(0, ddof=1)
    raw = {k: v for k, v in mt._icm_init(torch.as_tensor(x), 3, 3, True).items()}
    loss = lambda dev: float(mt._icm_neg_mll({k: v.to(dev) for k, v in raw.items()},
                                             torch.as_tensor(x, device=dev),
                                             torch.as_tensor(ys, device=dev), 0))
    assert abs(loss(cuda) - loss("cpu")) <= 1e-4 * abs(loss("cpu"))
    st_g = mt.fit_icm_gp(torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda),
                         ard=True)
    st_c = mt.fit_icm_gp(torch.as_tensor(x), torch.as_tensor(y), ard=True)
    def fitted(st):
        d = st.lx[:, None] * st.lb[None] + st.noise
        return 0.5 * float(torch.sum(st.yt ** 2 / d) + torch.sum(torch.log(d))
                           + st.yt.numel() * np.log(2 * np.pi))
    assert fitted(st_g) <= fitted(st_c) + 1e-3 * abs(fitted(st_c))
    cov = mt.task_posterior_cov_icm(st_g, st_g.x[:16])
    assert bool((torch.linalg.cholesky_ex(cov)[1] == 0).all())


@pytest.mark.cuda
def test_is_cuda_on_card(cuda):
    from sober_tpu_torch import compat

    tm = compat.TensorManager()
    assert tm.is_cuda() and tm.rand(2, 8).device.type == "cuda"
    assert not compat.TensorManager(device="cpu").is_cuda()


@pytest.mark.cuda
def test_kernels_launch_on_the_operands_card(cuda):
    """Each kernel on operands on the last visible card, launched while card
    0 is current: the wrappers make the operands' card current around the
    launch, so the C side launches there and reads that card's occupancy.
    On a one-card machine the last card is cuda:0 and this only checks the
    guard's launch."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    with torch.cuda.device(0):
        p = {"lengthscale": t(0.8), "outputscale": t(1.3)}
        x, y = t(rng.uniform(-1, 1, (300, 4))), t(rng.uniform(-1, 1, (2000, 4)))
        gram = rbf_gram(p, x, y)
        _, mu, mask, big_n, n_take, _ = _car_problem(200, 100, 200, dev)
        k = reference_horizon(mu, big_n, mask, n_take)
        mu_k, el_k = car_eliminate(mu, big_n, mask, k)
        bx, by = (torch.as_tensor(_bits(rng, n, 2048), device=dev) for n in (130, 70))
        words, counts = pack_bits(bx)
        tan = tanimoto_similarity(bx, by)
    torch.cuda.synchronize(dev)
    assert gram.device == mu_k.device == words.device == tan.device == dev
    assert float((gram - rbf_gram_reference(p, x, y)).abs().max()) <= 1.3e-5
    mu_r, el_r = car_eliminate_reference(mu, big_n, mask, k)
    assert torch.equal(el_k, el_r) and float((mu_k - mu_r).abs().max()) <= 1e-5
    want_words, want_counts = pack_bits_reference(bx)
    assert torch.equal(words, want_words) and torch.equal(counts, want_counts)
    assert torch.equal(tan, tanimoto_similarity_reference(bx, by))


@pytest.mark.cuda
def test_mesh_acquisition_and_loop_on_card(cuda):
    """An 8-shard mesh on the card (and over every card where there are
    more): sharded_acquisition is a valid quadrature whose pool weights
    equal the unsharded ones, and both schedules of Sober give valid
    batches; gspmd's dataset rows equal mesh=None's."""
    from sober_tpu_torch.core.pi import lfi
    from sober_tpu_torch.gp.exact import fit_gp, posterior_max_mean
    from sober_tpu_torch.parallel import make_mesh, sharded_acquisition
    from sober_tpu_torch.priors import Uniform
    from sober_tpu_torch.utils.weights import cleansing_weights

    rng = np.random.default_rng(8)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    x = t(rng.uniform(-1, 1, (40, 3)))
    y = torch.sin(3 * x[:, 0]) + 0.1 * t(rng.normal(size=40))
    state = fit_gp(x, y)
    eta = posterior_max_mean(state)
    pool, pdf = t(rng.uniform(-1, 1, (16384, 3))), torch.full((16384,), 0.125, device=cuda)
    meshes = [make_mesh(8, devices=[cuda] * 8)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    for mesh in meshes:
        idx, w, weights = sharded_acquisition(mesh, state, eta, pool, pool[:128], pdf, 16)
        assert bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3
        assert len(set(idx.tolist())) == 16 and int(idx.max()) < 16384
        want = cleansing_weights(lfi(state, eta, pool) / pdf)
        assert float((weights.gather() - want).abs().max()) <= 1e-6
        for schedule in ("gspmd", "blockwise"):
            box = torch.tensor([[-1.0] * 3, [1.0] * 3], device=cuda)
            sober = Sober(Uniform(box, device=cuda), state, mesh=mesh, schedule=schedule)
            xb = sober.next_batch(16384, 128, 16)
            assert bool(torch.isfinite(xb).all()) and bool((xb.abs() <= 1 + 1e-6).all())
        feats = t(rng.uniform(-1, 1, (2048, 3)))
        prior = DatasetPrior(feats, torch.sin(3 * feats[:, 0]), device=cuda)
        idx_m, _ = Sober(prior, state, seed=5, mesh=mesh).next_batch(256, 32, 8)
        idx_1, _ = Sober(prior, state, seed=5).next_batch(256, 32, 8)
        assert torch.equal(idx_m, idx_1)
