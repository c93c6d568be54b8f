"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Nine paths. The first is one exact-GP batch-BO iteration on a continuous
domain: a warm-started MAP refit of the GP hypers, the posterior cache, the
incumbent eta, and the fused acquisition (pi weights, Nystrom features, the
halving tree of Caratheodory eliminations). The second is one
dataset-domain screening iteration, Sober.next_batch over a pool of
133,303 x 2048-bit fingerprints with a Tanimoto GP (bench.py:bench_dataset).
The third is the continuous Sober loop at examples/shekel.py's width:
fit_gp_padded -> update_model -> Sober.next_batch(200000, 500, 100) on
Shekel over [0, 10]^4 from a Sobol Uniform proposal that becomes a WKDE,
then Sober.step with a warm start and a polished batch. The fourth is the
quick-start Branin gate of tests/test_acceptance.py. The fifth is
bench.py:bench_ising's warm-started Sober.step on the Ising edge masks (24
binary dimensions, n_rec 200,000, n_nys 500, batch 100, 500 observations);
the sixth the other discrete and mixed configs of examples/ (Ackley,
Rosenbrock, pest control, MaxSAT). The seventh is the fully-Bayesian GP at
bench.py's two FBGP configs: fbgp_refit (1000 hypersamples distilled to 50
chains over 100 observations in 3-d) and Sober.step_fbgp (n_rec 8192,
n_nys 256, batch 50), then examples/fbgp_hartmann.py's MES flow. The eighth
is BASQ's evidence of a Gaussian likelihood at tutorial 05's quadrature
sizes. The ninth is simulation-based inference: tutorial 05 on the ECM
battery task (a TruncatedGaussian prior, next_batch(4096, 256, 50), BASQ),
the README's guided SoberWrapper interface and tests/test_apps.py's
expectation propagation. The script

  0. requires a CUDA device and prints it (name and power limit from
     nvidia-smi), the torch and CUDA versions;
  1. builds the hand-written kernels from sober_tpu_torch/csrc;
  2. holds the RBF Gram kernel to its plain PyTorch reference at every
     shape the continuous iterations launch it at (and at the Ising step's
     d = 24 strips and at d = 100), and
     times both, with torch's fill_ of the same output as a yardstick of
     the card's write rate beside each strip; and holds the gradient of its
     autograd Function (the polish's route) to the reference's;
  3. holds the Caratheodory kernel to its reference at both configs'
     shapes, and times both;
  4. holds the Tanimoto Gram and its bit-pack kernel to their references
     and to a float64 oracle at the dataset path's shapes, times them (the
     Gram with and without the packs, the plain version, and torch._int_mm
     as a yardstick of the product), and checks the non-binary contract:
     NaN rows, then check_fingerprints raises;
  5. checks the port on the card against the port on the CPU (plain
     PyTorch references) on a small continuous iteration and 6. on a small
     screening iteration;
  7. runs the full continuous iteration at 65k/200 and at 200k/100 (the
     configurations of bench.py), with the kernels' launch counts;
  8. fits the Tanimoto GP and runs the full screening iteration at
     bench.py's configuration, with its stage split, launch counts, pool
     packs and host reads of the fingerprint flag;
  9. runs the Shekel loop (4 iterations, a step, a polish), each batch
     checked (finite, inside the box, weights >= 0 summing to 1, moment
     error below 5e-3), with its stage split, launches, host reads, peak
     memory and device-busy share;
 10. runs the Branin gate: seeds 0, 1 and 2 must each reach 10.59;
 11. runs the Ising step (a warm-up and 5 timed), each batch checked (0/1
     values, weights >= 0 summing to 1, indices in range, moment error
     below 5e-3), with its stage split, launches, host reads, peak memory
     and device-busy share;
 12. runs 3 batches of each discrete flow, each batch checked (legal
     values, weights, moment error), Rosenbrock's best rising on seeds 0
     and 1, each best beside the JAX package's record;
 13. runs fbgp_refit at bench.py's config (a warm-up and 5 timed, with the
     sweep, the surrogate fit, the distillation and the chain caches each
     timed after a sync), checks each refit and the distilled posterior
     against the undistilled one; times the sweep's two batched
     factorizations at (1001, 128, 128) beside their bounds and holds the
     sweep on the card to the CPU's; runs step_fbgp at bench.py's config
     (stages, launches by shape, host reads, peak memory, busy share, each
     batch checked) and times the RBF kernel at its busiest shapes; runs 3
     MES batches of the Hartmann flow (legal batches, the best rising);
 14. runs BASQ.quadrature(8192, 256, 64) on the Gaussian evidence: within
     0.15 of the truth, posterior draws and the MAP near 0;
 15. runs tutorial 05 at its sizes (phase sbi_ecm: 5 batches, each legal,
     inside the prior's box, moment error below 5e-3; BASQ at 8192/256/64;
     the MAP beside the truth, no gate), after the ECM's Genz constant,
     density and simulator on the card against the CPU (1e-5);
 16. runs the README's SoberWrapper at its sizes on the ECM spectrum with a
     TruncatedGaussian prior, BOLFI and a forked pool, under a time limit
     (phase sober_wrapper: legal batches, the diagonalization the CPU's);
 17. runs the identity-simulator EP (phase ep_flow: within 0.15 of theta*
     and closer than the prior) and the Gibbs and tilting samplers at
     tests/test_mvn.py's tail boxes (phase tmvn_tail: its tolerances);
 18. holds the RBF and CAR kernels at every shape phases 9-17 launched;

and prints one JSON line per phase, the kernels' summary, the card, and as
its last line {"ok": true, "device": {...}}. Any failed check raises, so the
exit code is non-zero and no result line is printed. Inputs are made from
numpy and torch seeds; nothing is read from outside the repository.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# (name, n_cand, batch, n_nys, d, n_obs, CAR launches per iteration)
CONFIGS = (("65k/200", 65_536, 200, 512, 10, 500, 9),
           ("200k/100", 200_000, 100, 500, 4, 500, 11))
# the RBF Grams of one continuous iteration, (n, m, launches) per config:
# K(X, X) in build_state and posterior_max_mean, K(pool, X) in the pi
# sweep's predict, then in recombination's two predictive_covariance calls
# K(nys, nys), K(nys, X), K(X, nys), K(nys, pool), K(nys, X), K(X, pool)
RBF_SHAPES = {"65k/200": ((500, 500, 2), (65_536, 500, 1), (512, 512, 1),
                          (512, 500, 2), (500, 512, 1), (512, 65_536, 1),
                          (500, 65_536, 1)),
              "200k/100": ((500, 500, 6), (200_000, 500, 1), (500, 200_000, 2))}
# a Gram of at least this many entries is a strip: store-bound, and timed
# beside fill_
STRIP = 10_000_000
ITERS = 5
# the screening iteration of bench.py:bench_dataset: pool rows, bits, bit
# density, observations, n_rec, n_nys, batch
DATASET = (133_303, 2048, 0.025, 512, 2000, 500, 100)
# Tanimoto Grams and CAR launches per next_batch: one Gram for the pi sweep
# and 5 for each of recombination's two kernel calls (the weighted
# predictive covariance makes 2 predict_mean Grams and 3 in
# predictive_covariance); CAR runs ceil(log2(2000 / 200)) + 1 rounds
DATASET_LAUNCHES = {"tanimoto_gram": 11, "car_eliminate": 5}
# bit packs per next_batch besides the pool's (packed once per prior): the
# observations at the pi sweep, and 2 per recombination Gram but 1 for
# K(nys, nys), whose operands are one tensor
DATASET_PACKS = 20
# the Shekel loop at examples/shekel.py's width: initial points, n_rec,
# n_nys, batch, iterations of fit -> update_model -> next_batch
SHEKEL = (100, 200_000, 500, 100, 4)
# the quick-start gate (tests/test_acceptance.py): seeds, initial points,
# n_rec, n_nys, batch, batches at most, the value each seed must reach
BRANIN = ((0, 1, 2), 10, 20_000, 500, 30, 8, 10.59)
# the Ising step of bench.py:bench_ising: n_rec, n_nys, batch, observations
ISING = (200_000, 500, 100, 500)
# the RBF strips of one Ising step at d = 24 (n, m): the pi sweep over the
# pool against the 512 padded observations, recombination's K(nys, pool)
ISING_STRIPS = ((200_000, 512), (500, 200_000))
# the other discrete and mixed configs of examples/, each run for
# FLOW_ITERS batches: (task, setup, seed, n_init, batch, n_rec, n_nys)
FLOWS = (("ackley", "setup_ackley", 0, 100, 200, 20_000, 500),
         ("rosenbrock", "setup_rosenbrock", 0, 100, 100, 20_000, 500),
         ("rosenbrock", "setup_rosenbrock", 1, 100, 100, 20_000, 500),
         ("pest", "setup_pest", 0, 100, 100, 100_000, 500),
         ("maxsat", "setup_maxsat", 0, 100, 100, 20_000, 500))
FLOW_ITERS = 3
# bench.py:bench_fbgp and bench_fbgp_step: observations, d, hypersamples,
# the distillation's n_nys, chains; the step's n_rec, n_nys, batch
FBGP = (100, 3, 1000, 100, 50, 8192, 256, 50)
# examples/fbgp_hartmann.py: initial points, hypersamples, the distillation's
# n_nys, chains, n_rec, n_nys, batch (calc_obj "MES"); iterations run here
HARTMANN = (50, 1000, 100, 50, 8192, 256, 50, 3)
# tutorials/05's quadrature (n_quad, n_nys, nodes) on tests/test_bq_fbgp.py's
# Gaussian evidence; its truth, log(sqrt(2 pi) 0.7 / 6), and the gate
BASQ_QUAD = (8192, 256, 64)
BASQ_TRUTH, BASQ_TOL = float(np.log(np.sqrt(2 * np.pi) * 0.7 / 6.0)), 0.15
# tutorials/05_simulation_based_inference.py:19-21 (examples/sbi_ecm.py:
# 14-15): initial draws, iterations of fit -> update_model -> next_batch,
# n_rec, n_nys, batch; the quadrature's n_quad, n_nys, nodes; posterior and
# MAP draws. The ECM's true parameters (tasks/ecm.py)
SBI_ECM = (100, 5, 4096, 256, 50, 8192, 256, 64, 500, 2000)
ECM_TRUTH = (2.0, -0.5, -1.0, 0.0, 0.5)
ECM_BOUNDS = ((1.0, -2.0, -2.0, -2.0, -2.0), (3.0, 2.0, 2.0, 2.0, 2.0))
# README.md:60-67's guided interface: model_initial_samples, run_SOBER's
# model_samples_per_iteration (next_batch(400, 200, 100)) and the
# iterations run of its 10, run_BASQ's integration nodes; the phase's limit
WRAPPER = (100, 100, 3, 100)
WRAPPER_SECONDS = 600
# tests/test_apps.py:261's identity-simulator EP: theta*, initial samples,
# one sweep of 2 SOBER iterations a site at batch 16 (surrogate samples 1024
# and 64), BASQ at 32 nodes from 1024 and 64
EP_THETA = (0.6, -0.4)
EP_RUN = dict(ep_iterations=1, sober_iterations=2, model_samples_per_iteration=16,
              surrogate_samples=1024, surrogate_effective_samples=64,
              integration_nodes=32, basq_samples=1024, basq_effective_samples=64,
              verbose=False)
# tests/test_mvn.py's tail (rho 0.8 on [2, 4]^2) and low-acceptance
# (identity on [3, 4]^2) boxes: draws, and the Gibbs and tilting mean and sd
# tolerances in sd units
TMVN_DRAWS, TMVN_TOL = 20_000, {"gibbs": (0.08, 0.10), "tilting": (0.04, 0.05)}
# where the TPU kernels live that the CUDA kernels replace (the bit pack
# computes the row sums |x| and |y| of the Pallas Tanimoto kernel)
REPLACES = {"rbf_gram": "sober_tpu/ops/pallas_kernels.py:131",
            "car_eliminate": "sober_tpu/ops/pallas_car.py:99",
            "tanimoto_gram": "sober_tpu/ops/pallas_kernels.py:72",
            "pack_bits": "sober_tpu/ops/pallas_kernels.py:72"}
SOURCES = {"rbf_gram": "sober_tpu_torch/csrc/rbf_gram.cu",
           "car_eliminate": "sober_tpu_torch/csrc/car_eliminate.cu",
           "tanimoto_gram": "sober_tpu_torch/csrc/tanimoto_gram.cu",
           "pack_bits": "sober_tpu_torch/csrc/tanimoto_gram.cu"}


# NVIDIA's H100 SXM peaks (dense): HBM bytes/s, float32 and float64 FLOP/s
# outside the tensor cores, int8 tensor-core OP/s
HBM_RATE, FP32_PEAK, FP64_PEAK, INT8_PEAK = 3.35e12, 67e12, 34e12, 1979e12


def bound_ms(n_bytes: float, n_ops: float, peak: float) -> tuple[float, str]:
    """The least time for the work, in ms, and what sets it: the bytes over
    the HBM rate or the operations over their peak rate."""
    t_bytes, t_ops = n_bytes / HBM_RATE, n_ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` runs of fn, each timed by CUDA events after a
    warm-up, in ms. A sleep kernel queued before the start event keeps the
    card busy while the host issues fn, so the time is the card's alone; of
    a call whose host work outlasts the sleep (a plain Python loop), the
    sleep's ~0.5 ms is left out."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> tuple[str, float]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    query = lambda fields, fmt: subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    smi = query("name,power.limit", "csv,noheader")
    sm_clock = float(query("clocks.max.sm", "csv,noheader,nounits"))
    emit(phase="device", nvidia_smi=smi, max_sm_clock_mhz=sm_clock,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], count=torch.cuda.device_count())
    return smi, sm_clock


def phase_build() -> None:
    from sober_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    emit(phase="build", seconds=time.perf_counter() - t0, library=so.name)


def phase_rbf(summary: dict) -> None:
    """The RBF kernel against its reference at every (n, m, d) the
    continuous iterations launch, at the Ising step's d = 24 strips, and at
    d = 100 (the first port refused d > 64), scalar and ARD lengthscales;
    device time per iteration of each continuous config, summed over its
    launches."""
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    cases = [(name, d, n, m, k) for name, _, _, _, d, _, _ in CONFIGS
             for n, m, k in RBF_SHAPES[name]]
    cases.append(("width", 100, 512, 65_536, 0))
    cases += [("ising_d24", 24, n, m, 0) for n, m in ISING_STRIPS]
    per_iteration = {}
    for config, d, n, m, launches in cases:
        scalar, _ = time_rbf(config, d, n, m, launches, rng, dev)
        if launches:
            acc = per_iteration.setdefault(config, {"ms": 0.0, "bound_ms": 0.0})
            acc["ms"] += launches * scalar["ms"]
            acc["bound_ms"] += launches * scalar["bound_ms"]
        keep = {k: scalar[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "store_library_ms")}
        if config == "ising_d24":
            summary.setdefault("rbf_gram_ising_d24", []).append(
                {"shape": [n, m, d], **keep})
        if (n, m, d) == (512, 65_536, 10):
            summary["rbf_gram"] = {"max_abs_err": scalar["max_abs_err"], **keep,
                                   "shape": [n, m, d]}
    emit(phase="rbf_gram_per_iteration", device_ms=per_iteration)


def time_rbf(config, d, n, m, launches, rng, dev) -> tuple[dict, dict]:
    """The RBF kernel at (n, m, d) on coordinates in [-1, 1] ([-0.3, 0.3]
    past 32 features, where the reference's norm trick stays accurate),
    scalar and ARD lengthscales: held to the reference and to float64 on
    the first rows within 1e-5 * outputscale, timed beside the reference
    and (for a strip) fill_ of the same output, with its bound. Emits and
    returns the (scalar, ARD) rows."""
    from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference

    scale = 1.0 if d <= 32 else 0.3
    x = torch.as_tensor(rng.uniform(-scale, scale, (n, d)), dtype=torch.float32,
                        device=dev)
    y = torch.as_tensor(rng.uniform(-scale, scale, (m, d)), dtype=torch.float32,
                        device=dev)
    # x and y read once, the Gram written once; 3 d + 2 flops an entry
    # (difference and square-add a feature; exp and scale)
    bound, by = bound_ms(4.0 * ((n + m) * d + n * m), float(n) * m * (3 * d + 2),
                         FP32_PEAK)
    store_ms = (cuda_ms(lambda: torch.empty((n, m), device=dev).fill_(1.0))
                if n * m >= STRIP else None)
    rows = []
    for ard in (False, True):
        ls = (torch.as_tensor(rng.uniform(0.5, 1.5, d), dtype=torch.float32, device=dev)
              if ard else torch.tensor(0.8, device=dev))
        os_ = torch.tensor(1.3, device=dev)
        params = {"lengthscale": ls, "outputscale": os_}
        got = rbf_gram(params, x, y)
        want = rbf_gram_reference(params, x, y)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        xs, ys = x[:64].double() / ls.double(), y.double() / ls.double()
        exact = float(os_) * torch.exp(-0.5 * ((xs[:, None] - ys[None]) ** 2).sum(-1))
        oracle_err = float((got[:64].double() - exact).abs().max())
        del xs, ys, exact
        # the kernel sums squared differences directly, the reference uses
        # the norm trick: they differ by the latter's cancellation
        require(err <= 1e-5 * float(os_) and oracle_err <= 1e-5 * float(os_),
                f"rbf {n}x{m} d={d} ard={ard}: err {err}, oracle {oracle_err}")
        row = dict(phase="rbf_gram", config=config, shape=[n, m, d], ard=ard,
                   launches_per_iteration=launches, max_abs_err=err,
                   oracle_max_abs_err=oracle_err, tol=1e-5 * float(os_),
                   ms=cuda_ms(lambda: rbf_gram(params, x, y)),
                   plain_ms=cuda_ms(lambda: rbf_gram_reference(params, x, y)),
                   bound_ms=bound, bound_by=by, store_library_ms=store_ms)
        emit(**row)
        rows.append(row)
    return rows[0], rows[1]


def car_problem(m, q, dev):
    """A CAR on m points with m - q moments and 7 padding rows, from numpy
    seed m: (x, mu, mask, big_n, n_take, active0)."""
    from sober_tpu_torch.core.rchq import null_basis

    rng = np.random.default_rng(m)
    x = torch.as_tensor(rng.normal(size=(m, m - q)), dtype=torch.float32, device=dev)
    mu = rng.uniform(0.1, 1.0, m)
    mask = np.ones(m)
    mask[-7:] = 0.0                           # padding rows
    mu[-7:] = 0.0
    mu = torch.as_tensor(mu / mu.sum(), dtype=torch.float32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    return (x, mu, mask) + null_basis(x, mu, m - q, mask)


def hold_car(m, x, mu, mask, big_n, n_take, active0) -> dict:
    """The CAR kernel (car_plan's variant) against its reference on one
    problem: a full run keeps w >= 0, empty padding, the moments to 1e-4
    and the reference's count of eliminations; up to the reference horizon
    (the steps where fp32 rounding does not yet decide the path, at least
    10 or all of them) it eliminates the same rows with weights within
    1e-5."""
    from sober_tpu_torch.ops.car import (car_eliminate, car_eliminate_reference,
                                         car_plan, reference_horizon)

    plan = car_plan(m, n_take)
    before = car_eliminate.variant_launches[plan.variant]
    mu_k, el_k = car_eliminate(mu, big_n, mask, n_take)
    mu_r, el_r = car_eliminate_reference(mu, big_n, mask, n_take)
    require(car_eliminate.variant_launches[plan.variant] == before + 1,
            f"car m={m}: {plan.variant} did not run")
    w_k, w_r = mu_k * (1 - el_k) * active0, mu_r * (1 - el_r) * active0
    moment = x.T @ mu
    mom_k = float((x.T @ w_k - moment).abs().max())
    mom_r = float((x.T @ w_r - moment).abs().max())
    n_k, n_r = int(el_k.sum()), int(el_r.sum())
    require(bool((w_k >= 0).all()) and bool((w_k[-7:] == 0).all()),
            f"car m={m}: w >= 0 and empty padding")
    require(mom_k < 1e-4 and mom_r < 1e-4, f"car m={m}: moments {mom_k} {mom_r}")
    require(n_k == n_r, f"car m={m}: {n_k} vs {n_r} eliminations")
    k = reference_horizon(mu, big_n, mask, n_take)
    require(k >= min(10, n_take), f"car m={m}: reference horizon only {k} steps")
    mu_kh, el_kh = car_eliminate(mu, big_n, mask, k)
    mu_rh, el_rh = car_eliminate_reference(mu, big_n, mask, k)
    err = float((mu_kh - mu_rh).abs().max())
    require(bool(torch.equal(el_kh, el_rh)) and err <= 1e-5,
            f"car m={m} k={k}: same={bool(torch.equal(el_kh, el_rh))} dmu={err}")
    return {"shape": [m, n_take], "variant": plan.variant, "eliminated": n_k,
            "horizon": k, "max_abs_err": err, "same_set": bool(torch.equal(el_k, el_r)),
            "moment_err": mom_k, "moment_err_reference": mom_r}


def car_bounds(m, q, n_elim, plan, sync_step_ms, sm_clock_mhz):
    """The CAR kernel's roofline (its inputs read and outputs written once;
    in step t, 2 m (q - t) float64 flops of the dot product and as many
    float32 flops of the rank-1 update, over the steps that eliminated a
    lane, taken as the first n_elim) and its dependency floor: n_take times
    the measured time of a step that finds no lane (its barriers and
    reductions), plus one read of each step's live rows at 128
    shared-memory bytes a clock per SM."""
    flops = 2.0 * m * sum(q - t for t in range(n_elim))
    t_bytes = 4.0 * (m * q + 4 * m) / HBM_RATE
    t_ops = flops / FP64_PEAK + flops / FP32_PEAK
    roof_ms, by = 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    width = -(-m // plan.cluster)
    pass_s = sum(4.0 * (q - t) * width for t in range(q)) / (128 * sm_clock_mhz * 1e6)
    return roof_ms, by, q * sync_step_ms + 1e3 * pass_s


def phase_car(summary: dict, sm_clock_mhz: float) -> None:
    from sober_tpu_torch.ops.car import (MAX_CLUSTER, CarPlan, _fit, _launch,
                                         car_eliminate, car_eliminate_reference,
                                         car_plan)

    dev = torch.device("cuda")
    # the main path's shapes (a cluster at m=400, one block at m=200), the
    # FBGP distillation's and batch selection's (m=100) and BASQ's
    # quadrature's (m=128), and the L2 variant's; beside the chosen plan,
    # the alternatives are timed on the same inputs: every other cluster
    # size that holds the basis, and the L2 kernel (the first port's design)
    for m, q in ((400, 200), (200, 100), (100, 50), (128, 64), (1000, 500)):
        x, mu, mask, big_n, n_take, active0 = car_problem(m, q, dev)
        plan = car_plan(m, n_take)
        alternatives = tuple(p for c in (1, 2, 4, MAX_CLUSTER)
                             if (p := _fit(m, n_take, c)) not in (None, plan))
        alternatives += (CarPlan("l2", 1, 0),) if plan.variant != "l2" else ()
        full = hold_car(m, x, mu, mask, big_n, n_take, active0)
        n_k, k = full["eliminated"], full["horizon"]
        mu_rh, el_rh = car_eliminate_reference(mu, big_n, mask, k)
        times, dmu = {}, 0.0
        for alt in (plan,) + alternatives:
            run = lambda kk=n_take, a=alt: _launch(mu, big_n, mask, kk, a)
            mu_kh, el_kh = run(k)
            same = bool(torch.equal(el_kh, el_rh))
            err = float((mu_kh - mu_rh).abs().max())
            require(same and err <= 1e-5,
                    f"car m={m} {alt.variant}/{alt.cluster} k={k}: same={same} dmu={err}")
            label = f"{alt.variant}{alt.cluster if alt.variant == 'cluster' else ''}"
            times[label] = cuda_ms(run)
            dmu = max(dmu, err)
        ms = times[f"{plan.variant}{plan.cluster if plan.variant == 'cluster' else ''}"]
        plain_ms = cuda_ms(lambda: car_eliminate_reference(mu, big_n, mask, n_take),
                           reps=10 if m < 1000 else 3)
        # a basis of zero columns: every step finds no lane, so a step is
        # only its barriers and reductions
        zero_n = torch.zeros_like(big_n)
        zero_ms = cuda_ms(lambda: car_eliminate(mu, zero_n, mask, n_take))
        roof_ms, by, floor_ms = car_bounds(m, n_take, n_k, plan, zero_ms / n_take,
                                           sm_clock_mhz)
        emit(phase="car_eliminate", m=m, q=n_take, variant=plan.variant,
             cluster=plan.cluster, smem_bytes=plan.smem_bytes, eliminated=n_k,
             horizon=k, max_abs_err=dmu, same_set_full_run=full["same_set"],
             moment_err=full["moment_err"], moment_err_reference=full["moment_err_reference"],
             ms=ms, ms_by_plan=times,
             plain_ms=plain_ms, no_lane_run_ms=zero_ms, bound_ms=roof_ms,
             bound_by=by, step_floor_ms=floor_ms)
        if m == 400:
            summary["car_eliminate"] = {"max_abs_err": dmu, "ms": ms,
                                        "plain_ms": plain_ms, "bound_ms": roof_ms,
                                        "bound_by": by, "step_floor_ms": floor_ms,
                                        "shape": [m, n_take]}


def make_problem(n_cand, n_nys, batch, d, n_obs, device):
    """bench.py:bench_fused's data, from numpy seed 0."""
    rng = np.random.default_rng(0)
    x_obs = rng.uniform(-1, 1, (n_obs, d)).astype(np.float32)
    y_obs = (np.sin(3 * x_obs[:, 0]) * np.cos(2 * x_obs[:, 1])
             + 0.1 * rng.normal(size=n_obs).astype(np.float32)).astype(np.float32)
    x_cand = rng.uniform(-1, 1, (n_cand, d)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    x_obs, y_obs, x_cand = t(x_obs), t(y_obs), t(x_cand)
    return (x_obs, y_obs, x_cand, x_cand[:n_nys],
            torch.full((n_cand,), 1.0 / 2.0 ** d, device=device))


def iteration(x_obs, y_obs, x_cand, x_nys, prior_pdf, params_prev, cfg, batch,
              stages=None):
    """bench.py's full_iteration: warm-started refit, state, eta, acquisition."""
    from sober_tpu_torch.core.fused import fused_acquisition
    from sober_tpu_torch.gp.exact import build_state, fit_params, posterior_max_mean

    marks = [time.perf_counter()]

    def mark():
        if stages is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    y_std = (y_obs - y_obs.mean()) / y_obs.std()
    params = fit_params(x_obs, y_std, cfg, params0=params_prev)
    mark()
    state = build_state(params, x_obs, y_obs, cfg)
    mark()
    eta = posterior_max_mean(state)
    mark()
    idx, w, weights = fused_acquisition(state, eta, x_cand, x_nys, prior_pdf, batch)
    mark()
    if stages is not None:
        for name, a, b in zip(("fit", "build_state", "eta", "acquisition"),
                              marks, marks[1:]):
            stages.setdefault(name, []).append(1e3 * (b - a))
    return state, idx, w, weights


def moment_error(kernel, x_cand, x_nys, weights, idx, w, batch) -> float:
    """Moment error of the batch on the port's own normalized feature strip
    (the same Gram, basis and scale that recombination used); kernel is
    recombination's Gram callable."""
    from sober_tpu_torch.core.rchq import nystrom_basis
    from sober_tpu_torch.utils.linalg import symmetrize

    k_nys = symmetrize(torch.nan_to_num(kernel(x_nys, x_nys)))
    u = nystrom_basis(k_nys, batch - 1)
    phi = u @ kernel(x_nys, x_cand)
    phi = phi / torch.clamp_min(phi.abs().max(), 1e-30)
    want = phi @ (weights / weights.sum())
    got = phi[:, idx] @ w
    return float((got - want).abs().max())


def check_batch(idx, w, n_cand, batch, label) -> None:
    require(tuple(idx.shape) == (batch,) and tuple(w.shape) == (batch,),
            f"{label}: batch shape")
    require(bool(torch.isfinite(w).all()) and bool((w >= 0).all()), f"{label}: w >= 0")
    require(abs(float(w.sum()) - 1.0) < 1e-3, f"{label}: sum w = {float(w.sum())}")
    require(int(idx.min()) >= 0 and int(idx.max()) < n_cand, f"{label}: idx in range")
    require(len(set(idx.tolist())) == batch, f"{label}: idx distinct")


def phase_small_vs_cpu() -> None:
    """The port on the card against the port on the CPU (all plain PyTorch
    references) on one small iteration, from the same fitted hypers."""
    from sober_tpu_torch.core.fused import fused_acquisition
    from sober_tpu_torch.gp.exact import (GPConfig, build_state, map_params,
                                          fit_params, posterior_max_mean,
                                          predictive_covariance)

    cfg = GPConfig(fit_iters=100)
    n_cand, n_nys, batch = 2048, 64, 16
    out = {}
    for dev in ("cpu", "cuda"):
        x_obs, y_obs, x_cand, x_nys, pdf = make_problem(n_cand, n_nys, batch, 3, 40, dev)
        if dev == "cpu":
            params = fit_params(x_obs, (y_obs - y_obs.mean()) / y_obs.std(), cfg)
        state = build_state(map_params(lambda p: p.to(dev), params), x_obs, y_obs, cfg)
        eta = posterior_max_mean(state)
        idx, w, weights = fused_acquisition(state, eta, x_cand, x_nys, pdf, batch)
        check_batch(idx, w, n_cand, batch, f"small {dev}")
        kernel = lambda a, b: predictive_covariance(state, a, b)
        out[dev] = (float(eta), weights.cpu(),
                    moment_error(kernel, x_cand, x_nys, weights, idx, w, batch))
    eta_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    w_err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    require(eta_err < 1e-4, f"small: eta rel err {eta_err}")
    require(w_err < 1e-6, f"small: weights err {w_err}")
    require(out["cuda"][2] < 5e-3, f"small: moment err {out['cuda'][2]}")
    emit(phase="small_iteration_cuda_vs_cpu", eta_rel_err=eta_err,
         weights_max_abs_err=w_err, moment_err_cuda=out["cuda"][2],
         moment_err_cpu=out["cpu"][2])


def car_variant_check(batch: int, before: dict, label: str) -> dict:
    """The CAR launches by variant since `before`; every one must be the
    variant car_plan picks at the path's shape (m = 2 batch barycenters)."""
    from sober_tpu_torch.ops.car import car_eliminate, car_plan

    got = {k: n - before[k] for k, n in car_eliminate.variant_launches.items()}
    want = car_plan(2 * batch, batch).variant
    require(got[want] == sum(got.values()) > 0,
            f"{label}: CAR variants {got}, want only {want}")
    return got


def car_profile(run) -> dict:
    """torch.profiler over one run: the CAR and RBF kernels' device time and
    count, and the device time of all kernels. None where the trace shows no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    car = [e for e in rows if "car_smem_kernel" in e.key or "car_l2_kernel" in e.key]
    rbf = [e for e in rows if "rbf_gram_kernel" in e.key]
    total = sum(dev_us(e) for e in rows)
    return {"car_device_ms": sum(dev_us(e) for e in car) / 1e3 if total else None,
            "car_kernels": sum(e.count for e in car),
            "rbf_device_ms": sum(dev_us(e) for e in rbf) / 1e3 if total else None,
            "rbf_kernels": sum(e.count for e in rbf),
            "all_device_ms": total / 1e3 if total else None}


def phase_iteration(cfg_row, counts: dict) -> None:
    from sober_tpu_torch.gp.exact import GPConfig, fit_params, predictive_covariance
    from sober_tpu_torch.ops.car import car_eliminate
    from sober_tpu_torch.ops.rbf_gram import rbf_gram

    name, n_cand, batch, n_nys, d, n_obs, car_per_iter = cfg_row
    dev = torch.device("cuda")
    x_obs, y_obs, x_cand, x_nys, pdf = make_problem(n_cand, n_nys, batch, d, n_obs, dev)
    cfg = GPConfig(fit_iters=100)
    # steady-state BO iteration: the refit is warm-started from the hypers
    # fitted without the newest batch (bench.py:130-136)
    x_prev, y_prev = x_obs[:n_obs - batch], y_obs[:n_obs - batch]
    params_prev = fit_params(x_prev, (y_prev - y_prev.mean()) / y_prev.std(), cfg)
    torch.cuda.synchronize()

    rbf_gram.launches = 0
    car_eliminate.launches = 0
    variants0 = dict(car_eliminate.variant_launches)
    stages, times = {}, []
    for it in range(1 + ITERS):                       # one warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, idx, w, weights = iteration(x_obs, y_obs, x_cand, x_nys, pdf,
                                           params_prev, cfg, batch, stages)
        torch.cuda.synchronize()
        if it:
            times.append(time.perf_counter() - t0)
    n_rbf, n_car = rbf_gram.launches, car_eliminate.launches
    variants = car_variant_check(batch, variants0, name)
    counts["rbf_gram"] = counts.get("rbf_gram", 0) + n_rbf
    counts["car_eliminate"] = counts.get("car_eliminate", 0) + n_car
    require(n_car == car_per_iter * (1 + ITERS),
            f"{name}: {n_car} CAR launches, want {car_per_iter} per iteration")
    rbf_per_iter = sum(k for _, _, k in RBF_SHAPES[name])
    require(n_rbf == rbf_per_iter * (1 + ITERS),
            f"{name}: {n_rbf} RBF launches, want {rbf_per_iter} per iteration")

    check_batch(idx, w, n_cand, batch, name)
    mom = moment_error(lambda a, b: predictive_covariance(state, a, b),
                       x_cand, x_nys, weights, idx, w, batch)
    require(mom < 5e-3, f"{name}: moment error {mom}")
    profiled = car_profile(lambda: iteration(x_obs, y_obs, x_cand, x_nys, pdf,
                                             params_prev, cfg, batch))
    emit(phase="iteration", config=name, n_cand=n_cand, batch=batch, n_nys=n_nys,
         d=d, n_obs=n_obs, iteration_s_median=statistics.median(times),
         iteration_s=times,
         stage_ms_median={k: statistics.median(v[1:]) for k, v in stages.items()},
         launches_per_iteration={"rbf_gram": n_rbf / (1 + ITERS),
                                 "car_eliminate": n_car / (1 + ITERS)},
         car_variant_launches=variants, profile_one_iteration=profiled,
         moment_err=mom, w_sum=float(w.sum()),
         lengthscale=float(state.kernel.params["lengthscale"]),
         noise=float(state.noise),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def make_pool():
    """bench.py:bench_dataset's pool, from numpy seed 0: fingerprints at
    ~2.5% bit density (typical of 2048-bit Morgan fingerprints) and normal
    targets. Made once; the Tanimoto phase and the screening iteration share
    it."""
    n_total, n_bits, density = DATASET[:3]
    rng = np.random.default_rng(0)
    feats = (rng.random((n_total, n_bits)) < density).astype(np.float32)
    return feats, rng.normal(size=n_total).astype(np.float32)


def int_mm_ms(x, y) -> float:
    """torch._int_mm on int8 0/1 copies of x (n, d) and y (m, d), padded
    with zeros to its multiples of 8: the intersection counts alone, a
    yardstick of the tensor cores' int8 rate that the port never calls."""
    up = lambda v: -(-v // 8) * 8
    pad = lambda t, r, c: torch.nn.functional.pad(
        t, (0, c - t.shape[1], 0, r - t.shape[0])).to(torch.int8)
    a = pad(x, max(x.shape[0], 17), up(x.shape[1]))
    b = pad(y, up(y.shape[0]), up(x.shape[1]))
    return cuda_ms(lambda: torch._int_mm(a, b.t()))


def phase_tanimoto(summary: dict, pool: np.ndarray) -> None:
    from sober_tpu_torch.ops.tanimoto_gram import (check_fingerprints, pack_bits,
                                                   pack_bits_reference,
                                                   tanimoto_gram_packed,
                                                   tanimoto_similarity,
                                                   tanimoto_similarity_reference)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    pool_t = torch.as_tensor(pool, device=dev)
    odd = (rng.random((1777, 300)) < 0.025).astype(np.float32)
    odd[[0, 5, 1000, 1776]] = 0.0                    # all-zero rows
    shapes = (("pi sweep K(pool, X)", pool_t,
               pool_t[torch.as_tensor(rng.choice(len(pool), 512, replace=False),
                                      device=dev)]),
              ("recombination strip K(nys, pool)", pool_t[:500], pool_t[500:2500]),
              ("odd shape with zero rows", torch.as_tensor(odd[:1000], device=dev),
               torch.as_tensor(odd[1000:], device=dev)))
    for label, x, y in shapes:
        got = tanimoto_similarity(x, y)
        want = tanimoto_similarity_reference(x, y)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_differ = int((got != want).sum())
        require(bool(torch.isfinite(got).all()) and err <= 1e-6,
                f"tanimoto {label}: err {err}")
        rows = rng.choice(x.shape[0], min(256, x.shape[0]), replace=False)
        xs, ys = x[rows].double().cpu().numpy(), y.double().cpu().numpy()
        xy = xs @ ys.T
        oracle = xy / np.maximum(xs.sum(1)[:, None] + ys.sum(1)[None, :] - xy, 1e-20)
        oracle_err = float(np.abs(got[rows].cpu().numpy() - oracle).max())
        require(oracle_err <= 1e-6, f"tanimoto {label}: oracle err {oracle_err}")
        words, counts = pack_bits(x)
        pack_err = float((counts - x.sum(1)).abs().max())   # fp32 sums are exact here
        require(pack_err == 0.0,
                f"tanimoto {label}: popcounts differ from row sums by {pack_err}")
        want_words, _ = pack_bits_reference(x[:4096])
        require(torch.equal(words[:4096], want_words),
                f"tanimoto {label}: packed words differ from the reference")
        packed = (words, counts) + pack_bits(y)
        require(torch.equal(tanimoto_gram_packed(*packed), got),
                f"tanimoto {label}: the packed-operand Gram differs")
        pack_ms = cuda_ms(lambda: pack_bits(x))
        pack_plain_ms = cuda_ms(lambda: pack_bits_reference(x))
        ms = cuda_ms(lambda: tanimoto_similarity(x, y))
        gram_ms = cuda_ms(lambda: tanimoto_gram_packed(*packed))
        plain_ms = cuda_ms(lambda: tanimoto_similarity_reference(x, y))
        product_library_ms = int_mm_ms(x, y)
        check_fingerprints(dev)                     # every input here is 0/1
        n, m, d = x.shape[0], y.shape[0], x.shape[1]
        # the packed words and the counts read once, the Gram written once;
        # the intersections as an int8 tensor-core product, 2 n m d ops
        bound, by = bound_ms((n + m) * (d / 8 + 4) + 4.0 * n * m,
                             2.0 * n * m * d, INT8_PEAK)
        emit(phase="tanimoto_gram", label=label, shape=[n, m, d],
             max_abs_err=err, entries_differing_bitwise=n_differ,
             oracle_max_abs_err=oracle_err, tol=1e-6, pack_ms=pack_ms,
             pack_plain_ms=pack_plain_ms, ms=ms, gram_ms=gram_ms,
             plain_ms=plain_ms, product_library_ms=product_library_ms,
             bound_ms=bound, bound_by=by)
        if n == len(pool):
            summary["tanimoto_gram"] = {"max_abs_err": err, "ms": ms,
                                        "gram_ms": gram_ms, "plain_ms": plain_ms,
                                        "product_library_ms": product_library_ms,
                                        "bound_ms": bound, "bound_by": by,
                                        "shape": [n, m, d]}
            # the pool read once; the words and the counts written once
            bound, by = bound_ms(4.0 * (n * d + n * d // 32 + n), float(n) * d,
                                 FP32_PEAK)
            summary["pack_bits"] = {"max_abs_err": pack_err, "ms": pack_ms,
                                    "plain_ms": pack_plain_ms, "bound_ms": bound,
                                    "bound_by": by, "shape": [n, d]}
    phase_non_binary(pool, pool_t)


def phase_non_binary(pool, pool_t) -> None:
    """A value other than 0 or 1 never gives a finite Gram entry: its row
    (as x) or column (as y) is NaN, the rest exact, and no Gram reads the
    flag; check_fingerprints then raises. A DatasetPrior whose pool holds a
    0.5 raises at its first Gram."""
    from sober_tpu_torch import DatasetPrior
    from sober_tpu_torch.ops.tanimoto_gram import (check_fingerprints,
                                                   tanimoto_similarity,
                                                   tanimoto_similarity_reference)

    dev = torch.device("cuda")
    check_fingerprints(dev)
    clean = pool_t[:64]
    reads_in_grams = 0
    for value in (0.5, float("nan"), 2.0):
        bad = clean.clone()
        bad[3, 7] = value
        reads = check_fingerprints.reads
        for got, ref, line in ((tanimoto_similarity(bad, clean),
                                tanimoto_similarity_reference(clean, clean), 0),
                               (tanimoto_similarity(clean, bad),
                                tanimoto_similarity_reference(clean, clean), 1)):
            torch.cuda.synchronize()
            marked = got[3] if line == 0 else got[:, 3]
            keep = torch.arange(64, device=dev) != 3
            rest = got[keep] if line == 0 else got[:, keep]
            rest_ref = ref[keep] if line == 0 else ref[:, keep]
            require(bool(torch.isnan(marked).all()) and torch.equal(rest, rest_ref),
                    f"non-binary {value}: NaN in exactly its {'row' if line == 0 else 'column'}")
        reads_in_grams += check_fingerprints.reads - reads
        require(reads_in_grams == 0, "a Gram read the flag")
        try:
            check_fingerprints(dev)
        except ValueError:
            pass
        else:
            raise RuntimeError(f"check failed: a {value} passed check_fingerprints")
        check_fingerprints(dev)                      # reset by the raise
    feats = pool[:2000].copy()
    feats[10, 20] = 0.5
    prior = DatasetPrior(feats, np.zeros(2000, np.float32), device=dev)
    try:
        tanimoto_similarity(prior.features, clean)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: a pool holding 0.5 passed its first Gram")
    emit(phase="tanimoto_non_binary", values=[0.5, "nan", 2.0],
         flag_reads_in_grams=reads_in_grams)


def state_to(state, dev):
    """A GPState with every tensor moved to `dev`."""
    from sober_tpu_torch.ops.kernels import Kernel

    kernel = Kernel(state.kernel.name,
                    {k: v.to(dev) for k, v in state.kernel.params.items()})
    tensors = {f: getattr(state, f) for f in state._fields
               if f not in ("config", "kernel", "mean_params")}
    return state._replace(kernel=kernel, mean_params={
        k: v.to(dev) for k, v in state.mean_params.items()}, **{
        f: None if t is None else t.to(dev) for f, t in tensors.items()})


def check_screening_batch(prior, idx_global, x_batch, available, batch, label):
    """The batch of a next_batch call: distinct, in range, available before
    the call, and the features of those rows."""
    require(tuple(idx_global.shape) == (batch,), f"{label}: batch shape")
    require(int(idx_global.min()) >= 0 and int(idx_global.max()) < prior.n_total,
            f"{label}: idx in range")
    require(len(set(idx_global.tolist())) == batch, f"{label}: idx distinct")
    require(bool(available[idx_global].all()), f"{label}: idx available")
    require(torch.equal(x_batch, prior.features[idx_global]), f"{label}: x_batch")


def staged_screening(sober, n_rec, n_nys, batch, stages=None):
    """The stages of next_batch run one by one, each synced and timed:
    the pi sweep, pruning + the Nystrom subset, recombination. Returns the
    batch's pool rows, weights and moment error."""
    from sober_tpu_torch.core.fused_sampling import dataset_candidates
    from sober_tpu_torch.core.sampler import PRUNE_THRESH

    prior = sober.prior
    marks = [time.perf_counter()]

    def mark():
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    w_all = sober.pi(prior.features)
    mark()
    idx_s, x_cand, x_nys, w = dataset_candidates(
        w_all, prior.features, prior.available, sober.keys.next(), n_rec, n_nys,
        PRUNE_THRESH, sober.dataset_pruning)
    mark()
    idx, w_rchq = sober.sampling_recombination(x_cand, x_nys, w, batch)
    mark()
    if stages is not None:
        for name, a, b in zip(("pi_sweep", "prune_nystrom", "recombination"),
                              marks, marks[1:]):
            stages.setdefault(name, []).append(1e3 * (b - a))
    check_batch(idx, w_rchq, n_rec, batch, "staged screening")
    mom = moment_error(sober.kernel, x_cand, x_nys, w, idx, w_rchq, batch)
    require(mom < 5e-3, f"staged screening: moment error {mom}")
    return idx_s, w_all, mom


def phase_small_dataset_vs_cpu() -> None:
    """The screening path on the card against the port on the CPU (plain
    PyTorch references), from one GP state fitted on the CPU."""
    from sober_tpu_torch import DatasetPrior, Sober, fit_tanimoto_gp

    n_pool, n_bits, n_obs, n_rec, n_nys, batch = 4096, 256, 64, 512, 64, 16
    # a seed whose pruning cut is tie-free: on the CPU the 512th and 513th
    # pi weights differ by 1.2e-4
    rng = np.random.default_rng(5)
    feats = (rng.random((n_pool, n_bits)) < 0.05).astype(np.float32)
    w_true = rng.normal(size=n_bits).astype(np.float32)
    targets = (feats @ w_true / np.sqrt(feats.sum(1) + 1.0)).astype(np.float32)
    obs = rng.permutation(n_pool)[:n_obs]
    state = fit_tanimoto_gp(torch.as_tensor(feats[obs]), torch.as_tensor(targets[obs]))
    out = {}
    for dev in ("cpu", "cuda"):
        prior = DatasetPrior(feats, targets, device=dev)
        prior.remove_sampled_index(torch.as_tensor(obs))
        sober = Sober(prior, state_to(state, dev),
                      kernel_type="weighted_predictive_covariance")
        available = prior.available.clone()
        idx_g, x_batch = sober.next_batch(n_rec, n_nys, batch)
        check_screening_batch(prior, idx_g, x_batch, available, batch,
                              f"small screening {dev}")
        stages = {}
        idx_s, w_all, mom = staged_screening(sober, n_rec, n_nys, batch, stages)
        out[dev] = (torch.where(available, w_all, 0.0).cpu(), idx_s.cpu(), mom)
    w_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    top = torch.sort(out["cpu"][0], descending=True).values
    gap = float(top[n_rec - 1] - top[n_rec])
    same = set(out["cuda"][1].tolist()) == set(out["cpu"][1].tolist())
    require(w_err <= 1e-6, f"small screening: pi weights err {w_err}")
    require(gap > 2 * w_err, f"small screening: the cut is not tie-free ({gap})")
    require(same, "small screening: the pruned pools differ")
    emit(phase="small_dataset_cuda_vs_cpu", pi_weights_max_abs_err=w_err,
         cut_gap=gap, pruned_sets_equal=same, moment_err_cuda=out["cuda"][2],
         moment_err_cpu=out["cpu"][2])


def phase_dataset_iteration(pool, targets, counts: dict) -> None:
    """bench.py:bench_dataset on the port: the Tanimoto GP fitted on 512
    observations drawn from the pool (outside the timed loop, as bench
    does), then one warm-up and ITERS timed Sober.next_batch calls."""
    from sober_tpu_torch import DatasetPrior, Sober, fit_tanimoto_gp
    from sober_tpu_torch.ops.car import car_eliminate
    from sober_tpu_torch.ops.rbf_gram import rbf_gram
    from sober_tpu_torch.ops.tanimoto_gram import (POOLS, check_fingerprints,
                                                   pack_bits, tanimoto_gram_packed)
    from sober_tpu_torch.utils.prng import KeyRing

    n_total, n_bits, _, n_obs, n_rec, n_nys, batch = DATASET
    dev = torch.device("cuda")
    pool_packs0 = POOLS.packs
    prior = DatasetPrior(pool, targets, device=dev)
    x_obs, y_obs = prior.sample(KeyRing(0, device=dev).next(), n_obs)
    torch.cuda.synchronize()
    tanimoto_gram_packed.launches = 0
    t0 = time.perf_counter()
    model = fit_tanimoto_gp(x_obs, y_obs)
    torch.cuda.synchronize()
    fit_s, fit_launches = time.perf_counter() - t0, tanimoto_gram_packed.launches
    require(fit_launches > 0, "dataset fit: the Tanimoto kernel never launched")
    emit(phase="dataset_fit", n_obs=n_obs, n_bits=n_bits, seconds=fit_s,
         tanimoto_launches=fit_launches,
         outputscale=float(model.kernel.params["outputscale"]),
         noise=float(model.noise))
    sober = Sober(prior, model, kernel_type="weighted_predictive_covariance")
    sober.update_model(model)
    available = prior.available.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for fn in (tanimoto_gram_packed, pack_bits, car_eliminate, rbf_gram):
        fn.launches = 0
    variants0 = dict(car_eliminate.variant_launches)
    reads0, loop_packs0 = check_fingerprints.reads, POOLS.packs
    times = []
    for it in range(1 + ITERS):                       # one warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx_g, x_batch = sober.next_batch(n_rec, n_nys, batch)
        torch.cuda.synchronize()
        if it:
            times.append(time.perf_counter() - t0)
    n_tan, n_car = tanimoto_gram_packed.launches, car_eliminate.launches
    n_pack, n_rbf = pack_bits.launches, rbf_gram.launches
    # the pool is packed (and its flag read) at the first next_batch; the
    # other host reads are check_fingerprints, once per next_batch
    loop_pool_packs = POOLS.packs - loop_packs0
    loop_reads = check_fingerprints.reads - reads0
    require(loop_pool_packs == 1, f"dataset: the pool was packed {loop_pool_packs} "
            "times in the timed loop, want once")
    require(loop_reads == 1 + ITERS + loop_pool_packs,
            f"dataset: {loop_reads} flag reads in {1 + ITERS} next_batch calls, "
            "want one each and one at the pool's pack")
    require(n_pack - loop_pool_packs == DATASET_PACKS * (1 + ITERS),
            f"dataset: {n_pack - loop_pool_packs} packs besides the pool's, want "
            f"{DATASET_PACKS} per next_batch")
    variants = car_variant_check(batch, variants0, "dataset")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, n in (("tanimoto_gram", n_tan), ("car_eliminate", n_car)):
        require(n == DATASET_LAUNCHES[name] * (1 + ITERS),
                f"dataset: {n} {name} launches, want "
                f"{DATASET_LAUNCHES[name]} per iteration")
    require(n_rbf == 0, "dataset: the RBF kernel launched on a Tanimoto path")
    counts["tanimoto_gram"] = counts.get("tanimoto_gram", 0) + n_tan
    counts["pack_bits"] = counts.get("pack_bits", 0) + n_pack
    counts["car_eliminate"] = counts.get("car_eliminate", 0) + n_car
    check_screening_batch(prior, idx_g, x_batch, available, batch, "dataset")
    w_b, _ = sober.next_batch(n_rec, n_nys, batch, return_weights=True)
    require(bool((w_b >= 0).all()) and abs(float(w_b.sum()) - 1.0) < 1e-3,
            f"dataset: w >= 0, sum w = {float(w_b.sum())}")

    stages, moms = {}, []
    for _ in range(ITERS):
        moms.append(staged_screening(sober, n_rec, n_nys, batch, stages)[2])
    profiled = car_profile(lambda: sober.next_batch(n_rec, n_nys, batch))
    phase_pool_packs = POOLS.packs - pool_packs0
    require(phase_pool_packs == 1,
            f"dataset: the pool was packed {phase_pool_packs} times in the phase")
    emit(phase="dataset_iteration", n_total=n_total, n_bits=n_bits, n_obs=n_obs,
         n_rec=n_rec, n_nys=n_nys, batch=batch,
         iteration_s_median=statistics.median(times), iteration_s=times,
         stage_ms_median={k: statistics.median(v) for k, v in stages.items()},
         stage_ms=stages,
         launches_per_iteration={"tanimoto_gram": n_tan / (1 + ITERS),
                                 "pack_bits": (n_pack - loop_pool_packs) / (1 + ITERS),
                                 "car_eliminate": n_car / (1 + ITERS)},
         pool_packs_in_phase=phase_pool_packs,
         next_batch_calls=1 + ITERS, pool_packs_in_loop=loop_pool_packs,
         flag_reads_in_loop=loop_reads, car_variant_launches=variants,
         profile_one_iteration=profiled,
         moment_err_max=max(moms), w_sum=float(w_b.sum()),
         n_pos=int(sober.last_npos), peak_mem_gib=peak_gib)


def phase_rbf_backward() -> None:
    """The RBF Gram's autograd Function (kernel forward, plain backward from
    the saved Gram) against autograd through the reference, in x and y, at
    the polish's shape (8 starts against 512 padded observations) and at a
    Shekel strip; relative 1e-5 of the largest gradient entry."""
    from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference

    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    for n, m in ((8, 512), (500, 200_000)):
        x, y = t(rng.uniform(0, 10, (n, 4))), t(rng.uniform(0, 10, (m, 4)))
        params = {"lengthscale": t(2.0), "outputscale": t(1.3)}
        g = t(rng.normal(size=(n, m)))
        grads = []
        for fn in (rbf_gram, rbf_gram_reference):
            a, b = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
            torch.sum(fn(params, a, b) * g).backward()
            grads.append((a.grad, b.grad))
        errs = [float((got - want).abs().max() / want.abs().max())
                for got, want in zip(*grads)]
        require(max(errs) <= 1e-5, f"rbf backward {n}x{m}: rel err {errs}")
        emit(phase="rbf_backward", shape=[n, m, 4], rel_err_x=errs[0],
             rel_err_y=errs[1], tol=1e-5)


@contextlib.contextmanager
def host_reads():
    """Counts the synchronizing device-to-host operations inside the block,
    with torch.cuda's sync debug mode; the count is appended to the yielded
    list when the block ends."""
    out = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out.append(sum("synchronizing" in str(w.message) for w in caught))


def capture_recombination(sober) -> dict:
    """Keep the inputs and outputs of the sampler's recombination calls, so
    that each batch's weights and moment error can be checked after a
    next_batch or step call."""
    seen, inner = {}, sober.sampling_recombination

    def run(x_cand, x_nys, weights, batch, calc_obj=None):
        idx, w = inner(x_cand, x_nys, weights, batch, calc_obj=calc_obj)
        seen.update(x_cand=x_cand, x_nys=x_nys, weights=weights, idx=idx, w=w)
        return idx, w

    sober.sampling_recombination = run
    return seen


def check_continuous_batch(sober, seen, xb, lo, hi, batch, label) -> dict:
    """A continuous batch: finite and inside the closed box (a WKDE clips
    the draws still outside after its rejection rounds onto the box, and
    its pdf counts the boundary as inside: sober_tpu/priors/wkde.py:84-117),
    and check_sober_batch's checks. Returns the moment error and the count
    of points on the boundary."""
    require(tuple(xb.shape) == (batch, lo.shape[0]), f"{label}: batch shape")
    inside = lambda x: bool(((x >= lo) & (x <= hi)).all())
    checked = check_sober_batch(sober, seen, xb, inside, batch, label)
    checked["on_boundary"] = int(((xb == lo) | (xb == hi)).any(dim=1).sum())
    return checked


def check_sober_batch(sober, seen, xb, legal, batch, label) -> dict:
    """A batch of next_batch or step: finite, legal (`legal(xb)`: inside the
    box, or the discrete values a domain allows), recombination's indices
    in range and distinct, its weights >= 0 summing to 1, and the moment
    error below 5e-3. Returns the moment error."""
    require(xb.shape[0] == batch and bool(torch.isfinite(xb).all()),
            f"{label}: batch shape, finite")
    require(legal(xb), f"{label}: values outside the domain")
    check_batch(seen["idx"], seen["w"], seen["x_cand"].shape[0], batch, label)
    mom = moment_error(sober.kernel, seen["x_cand"], seen["x_nys"], seen["weights"],
                       seen["idx"], seen["w"], batch)
    require(mom < 5e-3, f"{label}: moment error {mom}")
    return {"moment_err": mom}


def launch_counts() -> dict:
    from sober_tpu_torch.ops.car import car_eliminate
    from sober_tpu_torch.ops.rbf_gram import rbf_gram

    return {"rbf_gram": rbf_gram.launches, "car_eliminate": car_eliminate.launches}


def zero_counts() -> None:
    from sober_tpu_torch.ops.car import car_eliminate
    from sober_tpu_torch.ops.rbf_gram import rbf_gram

    rbf_gram.launches = car_eliminate.launches = 0


# (n, m, d, ard) of every RBF Gram and (m, q) of every CAR basis that the
# Sober loop, the Branin gate, the Ising step and the discrete flows launch
PATH_RBF_SHAPES, PATH_CAR_SHAPES = set(), set()


@contextlib.contextmanager
def counted(path: dict, shapes: dict | None = None):
    """Adds the RBF and CAR launches made inside the block to `path`, and
    their shapes to PATH_RBF_SHAPES and PATH_CAR_SHAPES; with `shapes`, the
    launches of each ("rbf_gram", n, m, d) and ("car_eliminate", m, q) to
    it too."""
    # the modules, not the functions of the same names that ops/ exports
    rbf = importlib.import_module("sober_tpu_torch.ops.rbf_gram")
    car = importlib.import_module("sober_tpu_torch.ops.car")
    rbf_inner, car_inner = rbf._launch, car._launch

    def tally(key):
        if shapes is not None:
            shapes[key] = shapes.get(key, 0) + 1

    def rbf_launch(x, y, ls, os_):
        PATH_RBF_SHAPES.add((x.shape[0], y.shape[0], x.shape[1], ls.numel() > 1))
        tally(("rbf_gram", x.shape[0], y.shape[0], x.shape[1]))
        return rbf_inner(x, y, ls, os_)

    def car_launch(mu, big_n, row_mask, n_take, plan):
        PATH_CAR_SHAPES.add(tuple(big_n.shape[-2:]))
        tally(("car_eliminate", *big_n.shape[-2:]))
        return car_inner(mu, big_n, row_mask, n_take, plan)

    before = launch_counts()
    rbf._launch, car._launch = rbf_launch, car_launch
    try:
        yield
    finally:
        rbf._launch, car._launch = rbf_inner, car_inner
    for name, n in launch_counts().items():
        path[name] = path.get(name, 0) + n - before[name]


def hold_rbf(params: dict, x, y, label: str) -> dict:
    """The RBF kernel against its plain version on the same operands, in
    float32 and in float64 (the reference's norm trick cancels in float32,
    the kernel sums direct differences): within 1e-5 * outputscale of the
    float64 Gram, and of the float32 one up to that one's own distance
    from float64."""
    from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference

    got = rbf_gram(params, x, y).double()
    ref = rbf_gram_reference(params, x, y).double()
    ref64 = rbf_gram_reference({k: v.double() for k, v in params.items()},
                               x.double(), y.double())
    err, err64 = float((got - ref).abs().max()), float((got - ref64).abs().max())
    drift = float((ref - ref64).abs().max())
    tol = 1e-5 * float(params["outputscale"])
    require(err64 <= tol and err <= tol + drift,
            f"{label}: rbf {tuple(x.shape)} x {tuple(y.shape)}: err {err}, "
            f"float64 {err64}, reference drift {drift}, tol {tol}")
    return {"shape": [x.shape[0], y.shape[0], x.shape[1]], "max_abs_err": err,
            "float64_err": err64, "reference_drift": drift, "tol": tol}


def phase_path_shapes() -> None:
    """The RBF and CAR kernels against their plain versions at every shape
    the Sober loop, the Branin gate, the Ising step and the discrete flows
    launched, so every tile and variant the host picked on those paths is
    held on the card: each (n, m, d, ard) Gram on coordinates in [-1, 1]
    (phase_rbf's draw), each (m, q) basis on car_problem's."""
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    worst = {}
    for n, m, d, ard in sorted(PATH_RBF_SHAPES):
        ls = t(rng.uniform(0.5, 1.5, d)) if ard else t(0.8)
        params = {"lengthscale": ls, "outputscale": t(1.3)}
        row = hold_rbf(params, t(rng.uniform(-1, 1, (n, d))),
                       t(rng.uniform(-1, 1, (m, d))), "path shapes")
        if row["float64_err"] >= worst.get("float64_err", -1.0):
            worst = row
    emit(phase="rbf_path_shapes", n_shapes=len(PATH_RBF_SHAPES),
         shapes=sorted(PATH_RBF_SHAPES), worst=worst)
    for m, q in sorted(PATH_CAR_SHAPES):
        emit(phase="car_path_shape", **hold_car(m, *car_problem(m, q, dev)))


def add_counts(counts: dict, path: dict, label: str) -> None:
    """The RBF and CAR launches of the path just driven, into `counts`; both
    must have launched."""
    for name in ("rbf_gram", "car_eliminate"):
        require(path.get(name, 0) > 0, f"{label}: {name} never launched")
        counts[name] = counts.get(name, 0) + path[name]


def busy_share(run) -> dict:
    """Device-busy share of one run under torch.profiler: the kernels'
    device time over the run's host-clock time. User annotations (an
    optimizer's step is one) are left out: their device time is the span
    of the kernels inside them, idle gaps included."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    us = lambda e: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
    dev_us = sum(us(e) for e in rows)
    top = sorted(rows, key=us, reverse=True)[:8]
    return {"wall_ms": 1e3 * wall, "device_ms": dev_us / 1e3 if dev_us else None,
            "busy_share": dev_us / 1e6 / wall if dev_us else None,
            "top_kernels_ms": {e.key[:60]: [us(e) / 1e3, e.count] for e in top}}


def phase_sober_loop(counts: dict) -> None:
    """examples/shekel.py's loop at full width on the card: 100 Sobol
    points, then fit_gp_padded -> update_model -> next_batch(200000, 500,
    100) four times (the first moves the Uniform proposal on to a WKDE),
    then Sober.step with a warm start and a polished next_batch. Every batch
    is checked; each iteration's stages (host clock after a device sync),
    launches, host reads and peak memory are printed, and one more
    iteration runs under torch.profiler for the device-busy share. At each
    call, pi's predict Gram over the last pool against the padded
    observations is held to its plain version (`hold_rbf`)."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp.exact import fit_gp_padded, posterior_mean
    from sober_tpu_torch.priors import WeightedKernelDensityEstimation
    from sober_tpu_torch.tasks.synthetic import setup_shekel
    from sober_tpu_torch.utils.prng import KeyRing

    n_init, n_rec, n_nys, batch, iters = SHEKEL
    dev = torch.device("cuda")
    with host_reads() as probe_sync:
        torch.cuda.synchronize()
    with host_reads() as probe_read:
        bool(torch.ones(1, device=dev).sum() > 0)
    require(probe_read[0] == 1, f"sync debug mode saw {probe_read[0]} reads of 1")
    prior, objective = setup_shekel(device=dev)
    lo, hi = prior.bounds[0], prior.bounds[1]
    x = prior.sample(KeyRing(0, device=dev).next(), n_init)
    y = objective(x)
    sober = Sober(prior, fit_gp_padded(x, y))
    seen = capture_recombination(sober)
    torch.cuda.synchronize()
    zero_counts()
    rows, path = [], {}
    for it in range(iters):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = {}
        with counted(launches):
            t0 = time.perf_counter()
            model = fit_gp_padded(x, y)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            sober.update_model(model)
            proposal = type(sober.prior).__name__
            with host_reads() as reads:
                xb = sober.next_batch(n_rec, n_nys, batch, verbose=True)
        # verbose syncs the device three times (the stages and the total)
        n_reads = reads[0] - 3 * probe_sync[0]
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        checked = check_continuous_batch(sober, seen, xb, lo, hi, batch, f"shekel {it}")
        # pi's predict Gram over the last pool against the padded observations
        checked["pi_gram"] = hold_rbf(model.kernel.params, seen["x_cand"], model.x,
                                      f"shekel {it}")
        yb = objective(xb)
        x, y = torch.cat([x, xb]), torch.cat([y, yb])
        t = sober.last_timings
        rows.append({"iteration": it, "proposal": proposal, "n_obs": int(model.mask.sum()),
                     "fit_ms": 1e3 * fit_s, "candidates_ms": 1e3 * t["candidates"],
                     "recombination_ms": 1e3 * t["recombination"],
                     "next_batch_ms": 1e3 * t["total"], "launches": launches,
                     "host_reads": n_reads, "pipeline_reads": sober.last_reads,
                     "peak_mem_gib": peak, **checked,
                     "n_pos": int(sober.last_npos), "best": float(y.max())})
        emit(phase="sober_loop_iteration", **rows[-1])
    require(isinstance(sober.prior, WeightedKernelDensityEstimation),
            "shekel: the proposal never became a WKDE")
    median = {k: statistics.median(r[k] for r in rows[1:]) for k in
              ("fit_ms", "candidates_ms", "recombination_ms", "next_batch_ms",
               "host_reads", "peak_mem_gib")}

    def one_more():
        sober.update_model(fit_gp_padded(x, y))
        sober.next_batch(n_rec, n_nys, batch)
    # the WKDE pdf over the last pool, alone (a 200,000 x 4,096 mixture)
    pdf_ms = cuda_ms(lambda: sober.prior.pdf(seen["x_cand"]), reps=5)
    with counted(path):
        profiled = busy_share(one_more)
        xs = sober.step(x, y, n_rec, n_nys, batch, warm_start=True)
    step_ms = {k: 1e3 * v for k, v in sober.last_timings.items()}
    step_checked = check_continuous_batch(sober, seen, xs, lo, hi, batch, "shekel step")
    step_checked["pi_gram"] = hold_rbf(sober.pi.model.kernel.params, seen["x_cand"],
                                       sober.pi.model.x, "shekel step")
    x, y = torch.cat([x, xs]), torch.cat([y, objective(xs)])
    with counted(path):
        sober.update_model(fit_gp_padded(x, y))
        xp = sober.next_batch(n_rec, n_nys, batch, polish=True)
    polish_checked = check_continuous_batch(sober, seen, xp, lo, hi, batch,
                                            "shekel polish")
    polish_checked["pi_gram"] = hold_rbf(sober.pi.model.kernel.params, seen["x_cand"],
                                         sober.pi.model.x, "shekel polish")
    mu = posterior_mean(sober.pi.model, xp)
    unpolished = seen["x_cand"][seen["idx"]]
    require(torch.equal(xp[:-1], unpolished[:-1]), "shekel polish: other points moved")
    add_counts(counts, path, "sober_loop")
    emit(phase="sober_loop", n_init=n_init, n_rec=n_rec, n_nys=n_nys, batch=batch,
         d=4, iterations=iters, median_iterations_2_on=median, launches_on_path=path,
         wkde_pdf_ms=pdf_ms, profile_one_iteration=profiled,
         sync_probe={"synchronize": probe_sync[0], "bool": probe_read[0]},
         step_batch=step_checked, step_timings_ms=step_ms, polish_batch=polish_checked,
         polished_mean=float(mu[-1]), best_unpolished_mean=float(mu[:-1].max()),
         best=float(y.max()), truth=10.5364)


def phase_branin_gate(counts: dict) -> None:
    """tests/test_acceptance.py's bar on the card: for each seed, 10 Sobol
    points of the quick-start Branin, then up to 8 batches of
    next_batch(20000, 500, 30); every seed must reach 10.59 (truth
    10.6043)."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.tasks.synthetic import setup_branin
    from sober_tpu_torch.utils.prng import KeyRing

    seeds, n_init, n_rec, n_nys, batch, max_batches, target = BRANIN
    dev = torch.device("cuda")
    zero_counts()
    bests, used, path = [], [], {}
    t0 = time.perf_counter()
    for seed in seeds:
        prior, objective = setup_branin(seed=seed, device=dev)
        x = prior.sample(KeyRing(seed, device=dev).next(), n_init)
        y = objective(x)
        sober = Sober(prior, fit_gp_padded(x, y), seed=seed)
        best, n = float(y.max()), 0
        while n < max_batches and best < target:
            with counted(path):
                sober.update_model(fit_gp_padded(x, y))
                xb = sober.next_batch(n_rec, n_nys, batch)
            yb = objective(xb)
            x, y = torch.cat([x, xb]), torch.cat([y, yb])
            best, n = max(best, float(yb.max())), n + 1
        bests.append(best)
        used.append(n)
    add_counts(counts, path, "branin_gate")
    emit(phase="branin_gate", seeds=list(seeds), bests=bests, batches=used,
         launches_on_path=path,
         target=target, truth=10.6043, seconds=time.perf_counter() - t0)
    require(all(b >= target for b in bests), f"branin gate: bests {bests}")


@contextlib.contextmanager
def timed_stages(targets, stages: dict):
    """Times each (owner, attribute, stage) of `targets` inside the block by
    host clock, each call ended by a device sync: the callable
    owner.attribute is wrapped, and its ms appended to stages[stage]. An
    attribute set on an instance is removed afterwards, so its class's
    method shows again."""
    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    saved = [(owner, attr, vars(owner).get(attr)) for owner, attr, _ in targets]
    for owner, attr, name in targets:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        yield
    finally:
        for owner, attr, old in saved:
            if old is not None:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)


def stage_clock(sober, stages: dict):
    """Times the stages of Sober.step inside the block by host clock, each
    ended by a device sync: the refit (fit_gp_padded as core/sober.py calls
    it), the candidates and recombination; appends their ms to
    stages[name]."""
    mod = importlib.import_module("sober_tpu_torch.core.sober")
    return timed_stages([(mod, "fit_gp_padded", "fit"),
                         (sober, "sampling_candidates", "candidates"),
                         (sober, "sampling_recombination", "recombination")], stages)


def phase_ising_step(counts: dict) -> None:
    """bench.py:bench_ising on the port at full width: the Ising edge masks
    (24 binary dimensions), 500 observations drawn from the prior with
    their objective on the host, the GP fitted on the first 400; then, per
    step, update_model(model) and step(x_all, y_all, 200000, 500, 100,
    warm_start=True), one warm-up and ITERS timed. Each step's stages are
    timed by host clock after a sync, its launches counted and its batch
    checked; one more step counts the host reads (sync debug mode) and one
    runs under torch.profiler for the device-busy share. pi's predict Gram
    over the last pool is held to its plain version (`hold_rbf`)."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.tasks import setup_ising
    from sober_tpu_torch.utils.prng import KeyRing

    n_rec, n_nys, batch, n_obs = ISING
    dev = torch.device("cuda")
    prior, objective = setup_ising(device=dev)
    x_all = prior.sample(KeyRing(0, device=dev).next(), n_obs)
    y_all = objective(x_all).cpu().numpy()          # the host's, as bench's
    model = fit_gp_padded(x_all[:n_obs - batch],
                          torch.as_tensor(y_all[:n_obs - batch], device=dev))
    sober = Sober(prior, model, seed=0)
    seen = capture_recombination(sober)
    legal = lambda xb: bool(((xb == 0) | (xb == 1)).all())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stages, totals, moms, path = {}, [], [], {}
    for it in range(1 + ITERS):                       # one warm-up
        sober.update_model(model)
        launches = {}
        with counted(launches), stage_clock(sober, stages):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xb = sober.step(x_all, y_all, n_rec, n_nys, batch, warm_start=True)
            torch.cuda.synchronize()
            totals.append(1e3 * (time.perf_counter() - t0))
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        moms.append(check_sober_batch(sober, seen, xb, legal, batch,
                                         f"ising step {it}")["moment_err"])
    peak = torch.cuda.max_memory_allocated() / 2**30
    pi_gram = hold_rbf(sober.pi.model.kernel.params, seen["x_cand"], sober.pi.model.x,
                       "ising step")

    def one_step():
        sober.update_model(model)
        return sober.step(x_all, y_all, n_rec, n_nys, batch, warm_start=True)
    with counted(path):
        with host_reads() as reads:
            one_step()
        profiled = busy_share(one_step)
    add_counts(counts, path, "ising_step")
    steps = 1 + ITERS + 2
    median = lambda v: statistics.median(v[1:])
    emit(phase="ising_step", n_rec=n_rec, n_nys=n_nys, batch=batch, n_obs=n_obs, d=24,
         step_ms_median=median(totals), step_ms=totals,
         stage_ms_median={k: median(v) for k, v in stages.items()}, stage_ms=stages,
         launches_per_step={k: v / steps for k, v in path.items()},
         host_reads_per_step=reads[0], pipeline_reads=sober.last_reads,
         peak_mem_gib=peak, profile_one_step=profiled, moment_err_max=max(moms),
         pi_gram=pi_gram, n_pos=int(sober.last_npos),
         probs_range=[float(sober.prior.probs.min()), float(sober.prior.probs.max())],
         best_observed=float(y_all.max()))


def acceptance_record(task: str, seed: int):
    """The JAX package's best value per iteration for (task, seed) in
    docs/acceptance_runs.jsonl, and the config it ran, or None."""
    path = Path(__file__).resolve().parent / "docs" / "acceptance_runs.jsonl"
    for line in path.read_text().splitlines():
        row = json.loads(line)
        if (row["task"], row["seed"]) == (task, seed):
            return {"cfg": row["cfg"], "best_per_iter": row["best_per_iter"][:FLOW_ITERS + 1]}
    return None


def phase_discrete_flows(counts: dict) -> None:
    """The other discrete and mixed configs of examples/ (FLOWS) on the
    card, FLOW_ITERS batches each of fit_gp_padded -> update_model ->
    next_batch, every batch checked: legal values (a binary block in {0, 1},
    categories among their values, a continuous block in the closed box),
    weights >= 0 summing to 1, the moment error below 5e-3. Ackley's
    continuous block must become a WKDE; Rosenbrock's best after its
    batches must exceed its initial best (tests/test_sober_e2e.py:188-209).
    Each run's best per batch is printed beside the JAX package's record,
    which is no gate."""
    import sober_tpu_torch.tasks as tasks
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.priors import WeightedKernelDensityEstimation
    from sober_tpu_torch.utils.prng import KeyRing

    dev = torch.device("cuda")
    zero_counts()
    path = {}
    for task, setup, seed, n_init, batch, n_rec, n_nys in FLOWS:
        prior, objective = getattr(tasks, setup)(device=dev)
        disc = getattr(prior, "prior_disc", prior)
        nc = getattr(prior, "n_dims_cont", 0)
        if hasattr(disc, "value_table"):
            legal_disc = lambda xd, disc=disc: bool(
                (xd[:, :, None] == disc.value_table[None]).any(-1).all())
        else:
            legal_disc = lambda xd: bool(((xd == 0) | (xd == 1)).all())
        if nc:
            lo, hi = prior.bounds
            legal = lambda xb, lo=lo, hi=hi, nc=nc, ld=legal_disc: (
                bool(((xb[:, :nc] >= lo) & (xb[:, :nc] <= hi)).all()) and ld(xb[:, nc:]))
        else:
            legal = legal_disc
        x = prior.sample(KeyRing(seed, device=dev).next(), n_init)
        y = objective(x)
        sober = Sober(prior, fit_gp_padded(x, y), seed=seed)
        seen = capture_recombination(sober)
        bests, moms, t0 = [float(y.max())], [], time.perf_counter()
        for it in range(FLOW_ITERS):
            with counted(path):
                sober.update_model(fit_gp_padded(x, y))
                xb = sober.next_batch(n_rec, n_nys, batch)
            moms.append(check_sober_batch(sober, seen, xb, legal, batch,
                                             f"{task} {seed} batch {it}")["moment_err"])
            x, y = torch.cat([x, xb]), torch.cat([y, objective(xb)])
            bests.append(float(y.max()))
        if task == "ackley":
            require(isinstance(sober.prior.prior_cont, WeightedKernelDensityEstimation),
                    "ackley: the continuous block never became a WKDE")
        if task == "rosenbrock":
            require(bests[-1] > bests[0], f"rosenbrock seed {seed}: best {bests}")
        emit(phase="discrete_flow", task=task, seed=seed, n_init=n_init, batch=batch,
             n_rec=n_rec, n_nys=n_nys, best_per_batch=bests, moment_err_max=max(moms),
             seconds=time.perf_counter() - t0, proposal=type(sober.prior).__name__,
             jax_record=acceptance_record(task, seed))
    add_counts(counts, path, "discrete_flows")
    emit(phase="discrete_flows", launches_on_path=path)


def fbgp_problem(dev):
    """bench.py's FBGP data: 100 points of [-1, 1]^3 from numpy seed 0 and
    their likelihood exp(-|x / 0.6|^2 / 2) (y on the host, as bench's)."""
    n_obs, d = FBGP[:2]
    x = np.random.default_rng(0).uniform(-1, 1, (n_obs, d)).astype(np.float32)
    y = np.exp(-0.5 * np.sum((x / 0.6) ** 2, axis=1)).astype(np.float32)
    return torch.as_tensor(x, device=dev), y


def refit_stages():
    """The stages of gp.fbgp.fbgp_refit, for timed_stages: the LML sweep
    (with its draw), the hyper-surrogate's MAP fit, the recombination and
    the chain caches."""
    mod = importlib.import_module("sober_tpu_torch.gp.fbgp")
    return [(mod, "sampling_hypers", "sweep"), (mod, "_surrogate_params", "surrogate_fit"),
            (mod, "recombination", "distillation"), (mod, "chain_caches", "chain_caches")]


def check_fbgp(model, n_qd, p, label) -> dict:
    """A refit FBGP: n_qd chains of p hypers, weights >= 0 summing to 1,
    finite caches. Returns its ESS."""
    w = model.w_qd
    require(tuple(model.Theta_qd.shape) == (n_qd, p), f"{label}: chains {model.Theta_qd.shape}")
    require(bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3,
            f"{label}: chain weights")
    require(all(bool(torch.isfinite(c).all()) for c in model._cache),
            f"{label}: caches finite")
    return {"ess": float(1.0 / torch.sum(w ** 2))}


def phase_fbgp_refit(counts: dict) -> dict:
    """bench.py:bench_fbgp on the port at its config: a FitboGP on 100
    points of [-1, 1]^3, then fbgp_refit(1000 hypersamples, n_nys 100,
    n_qd 50), a warm-up and ITERS timed by host clock after a sync, with its
    stages (the sweep, the surrogate fit, the distillation, the chain
    caches) each ended by a sync; the peak memory and host reads of one
    more refit. Each refit is checked, and the distilled marginal mean is
    held within 0.25 of the undistilled 1001-chain posterior's
    (tests/test_bq_fbgp.py's guard). Returns the launches per shape of one
    refit."""
    from sober_tpu_torch.gp.fbgp import (FitboGP, FullyBayesianGP, RBFHyperPrior,
                                         fbgp_refit, sampling_hypers)

    n_obs, d, n_hypers, n_nys, n_qd = FBGP[:5]
    dev = torch.device("cuda")
    x, y = fbgp_problem(dev)
    t0 = time.perf_counter()
    model = FitboGP(x, torch.as_tensor(y, device=dev))
    torch.cuda.synchronize()
    base_fit_ms = 1e3 * (time.perf_counter() - t0)
    hp = RBFHyperPrior(device=dev)
    refit = lambda: fbgp_refit(model, hp, n_hypers=n_hypers, n_nys=n_nys, n_qd=n_qd,
                               gen=torch.Generator(device=dev).manual_seed(0))
    zero_counts()
    stages, totals, path, shapes = {}, [], {}, {}
    for it in range(1 + ITERS):
        with counted(path, shapes if it == 0 else None), timed_stages(refit_stages(), stages):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fbgp = refit()
            torch.cuda.synchronize()
            totals.append(1e3 * (time.perf_counter() - t0))
        ess = check_fbgp(fbgp, n_qd, d + 1, f"fbgp_refit {it}")
    torch.cuda.reset_peak_memory_stats()
    with counted(path), host_reads() as reads:
        refit()
    peak = torch.cuda.max_memory_allocated() / 2**30
    add_counts(counts, path, "fbgp_refit")
    hy, lmls = sampling_hypers(model, hp, n_hypers, torch.Generator(device=dev).manual_seed(0))
    w_full = torch.exp(lmls - lmls.max())
    full = FullyBayesianGP(model, w_full / w_full.sum(), hy)
    xq = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (256, d)),
                         dtype=torch.float32, device=dev)
    gap = float((fbgp.marginal_predict(xq)[0] - full.marginal_predict(xq)[0]).abs().max())
    require(gap < 0.25, f"fbgp_refit: distilled mean {gap} from the full posterior")
    median = lambda v: statistics.median(v[1:])
    runs = 2 + ITERS
    emit(phase="fbgp_refit", n_obs=n_obs, d=d, n_hypers=n_hypers, n_nys=n_nys, n_qd=n_qd,
         refit_ms_median=median(totals), refit_ms=totals, base_fit_ms=base_fit_ms,
         stage_ms_median={k: median(v) for k, v in stages.items()}, stage_ms=stages,
         launches_per_refit={k: v / runs for k, v in path.items()},
         host_reads=reads[0], peak_mem_gib=peak, marginal_mean_gap=gap,
         lml_finite=int(torch.sum(lmls > -1e19)), **ess)
    return shapes


def phase_fbgp_sweep_factor() -> None:
    """The LML sweep's two batched factorizations at bench.py's shape
    ((1001, 128, 128) fp32, captured from one sweep): cholesky_ex with the
    (n, n) triangular solve (L^-1 K), and cholesky_ex with the vector solve
    and the log-diagonal, each with its bound; the whole sweep; and the
    sweep on the card against the sweep on the CPU (plain LAPACK) on the
    same inputs, within 2e-3 with EPS_LML on the same lanes."""
    from sober_tpu_torch.gp import fbgp as fb

    n_hypers = FBGP[2]
    dev = torch.device("cuda")
    x, y = fbgp_problem(dev)
    model = fb.FitboGP(x, torch.as_tensor(y, device=dev))
    hp = fb.RBFHyperPrior(device=dev)
    theta_map = fb._theta_map_of(model, hp)
    anchor = torch.cat([torch.full((1,), -10.0, device=dev), torch.log(theta_map)])
    thetas = torch.cat([anchor[None], hp.sample(torch.Generator(device=dev).manual_seed(0),
                                                n_hypers)])
    args = (model.model.x, model.fobs_padded, model.alpha, model.model.mask)
    captured, inner = [], fb._fixed_jitter_cholesky

    def capture(a):
        captured.append(a.clone())
        return inner(a)
    fb._fixed_jitter_cholesky = capture
    try:
        lmls = fb.fitbo_mll_batch(thetas, *args)
    finally:
        fb._fixed_jitter_cholesky = inner
    want = fb.fitbo_mll_batch(thetas.cpu(), *(a.cpu() for a in args))
    dead = want == fb.EPS_LML
    got = lmls.cpu()
    require(torch.equal(got == fb.EPS_LML, dead), "sweep: EPS_LML lanes differ from the CPU's")
    err = float(((got - want).abs() / (want.abs() + 1.0))[~dead].max())
    require(err <= 2e-3, f"sweep: card against CPU rel err {err}")
    # the matrices the sweep factors: symmetrized, at the fixed jitter
    eye = torch.eye(captured[0].shape[-1], device=dev)
    a1, a2 = (0.5 * (a + a.mT) + 1e-6 * torch.clamp_min(
        torch.diagonal(a, dim1=-2, dim2=-1).mean(-1), 1e-30)[:, None, None] * eye
        for a in captured)
    failed = [int((torch.linalg.cholesky_ex(a)[1] != 0).sum()) for a in (a1, a2)]
    t, n = a1.shape[0], a1.shape[-1]
    rhs = torch.randn((t, n, 1), generator=torch.Generator(device=dev).manual_seed(1),
                      device=dev)

    def factor_solve():
        c, _ = torch.linalg.cholesky_ex(a1)
        return torch.linalg.solve_triangular(c, a1, upper=False)

    def factor_vector():
        c, _ = torch.linalg.cholesky_ex(a2)
        w = torch.linalg.solve_triangular(c, rhs, upper=False)
        return w, torch.log(torch.diagonal(c, dim1=-2, dim2=-1))

    mat = 4.0 * t * n * n
    rows = {}
    for name, fn, n_bytes, ops in (
            # reads the matrix and the (n, n) right side, writes L and L^-1 K;
            # n^3 / 3 flops of the factor and n^3 of the solve a matrix
            ("cholesky_ex_solve_nn", factor_solve, 4 * mat, t * (n ** 3 / 3 + n ** 3)),
            # reads the matrix and a vector, writes L, w and the log-diagonal
            ("cholesky_ex_solve_vector", factor_vector, 2 * mat + 12.0 * t * n,
             t * (n ** 3 / 3 + n ** 2 + n)),
            ("cholesky_ex", lambda: torch.linalg.cholesky_ex(a1), 2 * mat, t * n ** 3 / 3)):
        bound, by = bound_ms(n_bytes, ops, FP32_PEAK)
        rows[name] = {"library_ms": cuda_ms(fn), "bound_ms": bound, "bound_by": by}
    sweep_ms = cuda_ms(lambda: fb.fitbo_mll_batch(thetas, *args), reps=5)
    emit(phase="fbgp_sweep_factor", shape=[t, n, n], factorizations=rows,
         sweep_ms=sweep_ms, cpu_max_rel_err=err, eps_lml_lanes=int(dead.sum()),
         failed_factorizations=failed)


def phase_fbgp_step(counts: dict) -> dict:
    """bench.py:bench_fbgp_step on the port at its config: the FBGP refit
    of bench's 100 points, Sober over Uniform([-1, 1]^3), then
    step_fbgp(x, y, hp, 8192, 256, 50) with 1000 hypersamples, n_nys_qd 100
    and n_qd 50: a warm-up and ITERS timed by host clock after a sync, with
    the stages (the base fit, the hyper pipeline, the candidates,
    recombination) each ended by a sync; every batch checked (inside the
    box, weights >= 0 summing to 1, moment error below 5e-3); the host
    reads of one more step and the busy share of one under torch.profiler.
    Returns the launches per shape of one step."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp.fbgp import FitboGP, RBFHyperPrior, fbgp_refit
    from sober_tpu_torch.priors import Uniform

    n_obs, d, n_hypers, n_nys_qd, n_qd, n_rec, n_nys, batch = FBGP
    dev = torch.device("cuda")
    x, y = fbgp_problem(dev)
    hp = RBFHyperPrior(device=dev)
    model = fbgp_refit(FitboGP(x, torch.as_tensor(y, device=dev)), hp, n_hypers=n_hypers,
                       n_nys=n_nys_qd, n_qd=n_qd,
                       gen=torch.Generator(device=dev).manual_seed(0))
    prior = Uniform([[-1.0] * d, [1.0] * d], device=dev)
    sober = Sober(prior, model, seed=0)
    seen = capture_recombination(sober)
    lo, hi = prior.bounds
    core = importlib.import_module("sober_tpu_torch.core.sober")
    step = lambda: sober.step_fbgp(x, y, hp, n_rec, n_nys, batch, n_hypers=n_hypers,
                                   n_nys_qd=n_nys_qd, n_qd=n_qd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    stages, totals, moms, path, shapes = {}, [], [], {}, {}
    targets = [(core, "FitboGP", "base_fit"), (core, "fbgp_refit", "hyper_pipeline"),
               (sober, "sampling_candidates", "candidates"),
               (sober, "sampling_recombination", "recombination")]
    for it in range(1 + ITERS):
        with counted(path, shapes if it == 0 else None), timed_stages(targets, stages):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xb = step()
            torch.cuda.synchronize()
            totals.append(1e3 * (time.perf_counter() - t0))
        moms.append(check_continuous_batch(sober, seen, xb, lo, hi, batch,
                                           f"fbgp step {it}")["moment_err"])
        check_fbgp(sober.pi.model, n_qd, d + 1, f"fbgp step {it}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    with counted(path):
        with host_reads() as reads:
            step()
        profiled = busy_share(step)
    add_counts(counts, path, "fbgp_step")
    steps = 1 + ITERS + 2
    median = lambda v: statistics.median(v[1:])
    emit(phase="fbgp_step", n_obs=n_obs, d=d, n_hypers=n_hypers, n_nys_qd=n_nys_qd,
         n_qd=n_qd, n_rec=n_rec, n_nys=n_nys, batch=batch,
         step_ms_median=median(totals), step_ms=totals,
         stage_ms_median={k: median(v) for k, v in stages.items()}, stage_ms=stages,
         launches_per_step={k: v / steps for k, v in path.items()},
         launches_by_shape={"|".join(map(str, k)): v for k, v in sorted(shapes.items())},
         host_reads_per_step=reads[0], peak_mem_gib=peak, profile_one_step=profiled,
         moment_err_max=max(moms), n_pos=int(sober.last_npos))
    return shapes


def phase_rbf_busiest(summary: dict, shapes: dict, config: str, per: int = 1,
                      top: int = 4) -> None:
    """The RBF kernel at the `top` shapes of a path that carry the most
    work (n m launches), timed beside its plain version with their bounds
    and launches per iteration (time_rbf; `shapes` counted over `per`
    iterations), into summary["rbf_gram_" + config]."""
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    rbf = [(key[1:], k) for key, k in shapes.items() if key[0] == "rbf_gram"]
    rbf = sorted(rbf, key=lambda r: r[0][0] * r[0][1] * r[1], reverse=True)[:top]
    rows = []
    for (n, m, d), k in rbf:
        scalar, _ = time_rbf(config, d, n, m, k / per, rng, dev)
        rows.append({key: scalar[key] for key in ("shape", "launches_per_iteration", "ms",
                                                  "plain_ms", "bound_ms", "bound_by")})
    summary["rbf_gram_" + config] = rows


def phase_fbgp_hartmann(counts: dict) -> None:
    """examples/fbgp_hartmann.py on the card at its config for HARTMANN's
    iterations: 50 Sobol points of Hartmann-6, an FBGP refit, Sober, then
    step_fbgp(..., calc_obj="MES") per batch. Every batch must be legal
    (finite, inside [0, 1]^6) with weights >= 0 summing to 1, and the best
    must rise; the bests are printed, with no gate against JAX."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.gp.fbgp import FitboGP, RBFHyperPrior, fbgp_refit
    from sober_tpu_torch.tasks.synthetic import setup_hartmann
    from sober_tpu_torch.utils.prng import KeyRing

    n_init, n_hypers, n_nys_qd, n_qd, n_rec, n_nys, batch, iters = HARTMANN
    dev = torch.device("cuda")
    keys = KeyRing(0, device=dev)
    prior, fn = setup_hartmann(device=dev)
    x = prior.sample(keys.next(), n_init)
    y = fn(x)
    hp = RBFHyperPrior(device=dev)
    zero_counts()
    path, t0 = {}, time.perf_counter()
    with counted(path):
        model = fbgp_refit(FitboGP(x, y), hp, n_hypers=n_hypers, n_nys=n_nys_qd,
                           n_qd=n_qd, gen=keys.next())
    sober = Sober(prior, model, seed=0)
    seen = capture_recombination(sober)
    lo, hi = prior.bounds
    bests, steps_ms = [float(y.max())], []
    for it in range(iters):
        t1 = time.perf_counter()
        with counted(path):
            xb = sober.step_fbgp(x, y, hp, n_rec, n_nys, batch, n_hypers=n_hypers,
                                 n_nys_qd=n_nys_qd, n_qd=n_qd, calc_obj="MES")
        torch.cuda.synchronize()
        steps_ms.append(1e3 * (time.perf_counter() - t1))
        require(tuple(xb.shape) == (batch, 6) and bool(torch.isfinite(xb).all())
                and bool(((xb >= lo) & (xb <= hi)).all()), f"hartmann {it}: batch")
        check_batch(seen["idx"], seen["w"], seen["x_cand"].shape[0], batch,
                    f"hartmann {it}")
        x, y = torch.cat([x, xb]), torch.cat([y, fn(xb)])
        bests.append(float(y.max()))
    require(bests[-1] > bests[0], f"hartmann: best {bests}")
    add_counts(counts, path, "fbgp_hartmann")
    emit(phase="fbgp_hartmann", n_init=n_init, n_hypers=n_hypers, n_qd=n_qd, n_rec=n_rec,
         n_nys=n_nys, batch=batch, calc_obj="MES", best_per_batch=bests,
         step_ms=steps_ms, truth=3.32237, launches_on_path=path,
         seconds=time.perf_counter() - t0)


def phase_basq_evidence(counts: dict) -> None:
    """tests/test_bq_fbgp.py:69-95 on the card at tutorial 05's quadrature
    sizes: 100 Sobol points of U(-3, 3), a ScaleMmltGP on the log-likelihood
    of N(0, 0.7^2), Sober's proposal learned from one next_batch(512, 64,
    8), then BASQ.quadrature(8192, 256, 64): the evidence must be within
    0.15 of log(sqrt(2 pi) 0.7 / 6) in log space; posterior draws and the
    MAP must lie near 0."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.apps.basq import BASQ
    from sober_tpu_torch.gp.warped import ScaleMmltGP
    from sober_tpu_torch.priors import Uniform
    from sober_tpu_torch.utils.prng import KeyRing

    n_quad, n_nys, n_nodes = BASQ_QUAD
    dev = torch.device("cuda")
    keys = KeyRing(0, device=dev)
    prior = Uniform([[-3.0], [3.0]], device=dev)
    x = prior.sample(keys.next(), 100)
    zero_counts()
    path = {}
    with counted(path):
        model = ScaleMmltGP(x, -0.5 * (x[:, 0] / 0.7) ** 2)
        sober = Sober(prior, model)
        sober.next_batch(512, 64, 8)
        basq = BASQ(prior, model, sober, verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        elml, avlml = basq.quadrature(n_quad, n_nys, n_nodes)
        quad_ms = 1e3 * (time.perf_counter() - t0)
        samples = basq.sampling_posterior(200)
        map_x = float(basq.MAP(500)[0])
    add_counts(counts, path, "basq_evidence")
    require(abs(elml - BASQ_TRUTH) < BASQ_TOL, f"basq: elml {elml}, truth {BASQ_TRUTH}")
    post_mean = float(samples.mean())
    require(abs(post_mean) < 0.3 and abs(map_x) < 0.5,
            f"basq: posterior mean {post_mean}, MAP {map_x}")
    emit(phase="basq_evidence", n_quad=n_quad, n_nys=n_nys, n_nodes=n_nodes, elml=elml,
         avlml=avlml, truth=BASQ_TRUTH, tol=BASQ_TOL, quadrature_ms=quad_ms,
         posterior_mean=post_mean, map=map_x, launches_on_path=path)


def ecm_spectrum(theta, omega, log_mu, log_sd):
    """The two-RC ECM's impedance spectrum [Re Z, Im Z] (B, 2n) of parameter
    rows (or one row) in numpy, as sober_tpu_torch/tasks/ecm.py computes it:
    the host model that phase_sober_wrapper's SoberWrapper calls, one row a
    pool worker."""
    theta = np.atleast_2d(np.asarray(theta, np.float64))
    rt, r1_, t1, r2_, t2 = (theta[:, k:k + 1] for k in range(5))
    r1, r2 = np.exp(-np.exp(r1_)), np.exp(-np.exp(r2_))
    z1 = np.log(omega)[None, :] - (log_sd * t1 + log_mu)
    z2 = np.log(omega)[None, :] - (log_sd * t2 + log_mu)
    big_rt = np.exp(rt)
    re = big_rt * ((1.0 - r1 - r2) + r1 / 2 * (1 - np.tanh(z1)) + r2 / 2 * (1 - np.tanh(z2)))
    im = big_rt * ((r1 / 2) / np.cosh(z1) + (r2 / 2) / np.cosh(z2))
    return np.concatenate([re, im], axis=1)


def capture_every_recombination(sober) -> list:
    """Like capture_recombination, but keeps every call's inputs, outputs
    and the recombination kernel of its iteration."""
    seen, inner = [], sober.sampling_recombination

    def run(x_cand, x_nys, weights, batch, calc_obj=None):
        idx, w = inner(x_cand, x_nys, weights, batch, calc_obj=calc_obj)
        seen.append(dict(x_cand=x_cand, x_nys=x_nys, weights=weights, idx=idx, w=w,
                         kernel=sober.kernel))
        return idx, w

    sober.sampling_recombination = run
    return seen


def phase_small_ecm_vs_cpu() -> dict:
    """The ECM task's deterministic stages on the card against the CPU:
    the prior's Genz constant, its density at 256 rows and the simulator's
    discrepancy and log-likelihood, each within 1e-5 relative, and the
    observed spectrum (its noise drawn on the CPU from the seed on both)
    within 1e-5 of its largest value: a noise drawn apart would differ by
    its sd, 0.26, while the float32 spectrum differs by the ulps of tanh
    and exp (elementwise up to 1.04e-5 relative at its smallest values on
    an H100)."""
    from sober_tpu_torch.tasks import setup_ecm_two

    dev = torch.device("cuda")
    prior_c, sim_c = setup_ecm_two(device="cpu")
    prior_g, sim_g = setup_ecm_two(device=dev)
    lo, hi = np.asarray(ECM_BOUNDS)
    theta = np.random.default_rng(9).uniform(lo - 0.2, hi + 0.2, (256, 5)).astype(np.float32)
    rel = lambda g, c: float(((g.cpu() - c).abs() / c.abs().clamp_min(1e-30)).max())
    scaled = lambda g, c: float((g.cpu() - c).abs().max() / c.abs().max())
    t_c, t_g = torch.as_tensor(theta), torch.as_tensor(theta, device=dev)
    inside = prior_c.pdf(t_c) > 0
    errs = {"constant": rel(prior_g.constant, prior_c.constant),
            "pdf": rel(prior_g.pdf(t_g)[inside.to(dev)], prior_c.pdf(t_c)[inside]),
            "pdf_zeros_agree": bool(torch.equal(prior_g.pdf(t_g).cpu() == 0, ~inside)),
            "reZ": scaled(sim_g.reZ, sim_c.reZ), "imZ": scaled(sim_g.imZ, sim_c.imZ)}
    for name, g, c in zip(("discrepancy", "loglik"), sim_g(t_g), sim_c(t_c)):
        errs[name] = rel(g, c)
    require(all(v < 1e-5 for k, v in errs.items() if k != "pdf_zeros_agree")
            and errs["pdf_zeros_agree"], f"small ecm: card against cpu {errs}")
    return errs


def phase_sbi_ecm(counts: dict) -> tuple[dict, dict]:
    """tutorials/05_simulation_based_inference.py on the card at its sizes
    (SBI_ECM): setup_ecm_two, 100 draws of its truncated Gaussian, then 5 x
    (fit_gp_padded -> update_model -> next_batch(4096, 256, 50)) on the
    discrepancy, each batch checked (legal, inside the prior's box, moment
    error below 5e-3) with its stages by host clock after a sync, launches,
    host reads and peak memory; one more iteration under torch.profiler for
    the busy share; then ScaleMmltGP on the log-likelihoods,
    BASQ.quadrature(8192, 256, 64), sampling_posterior(500) and MAP(2000),
    the MAP's distance to the truth reported, not gated. First the small
    problem on the card against the CPU (phase_small_ecm_vs_cpu). Returns
    the RBF and CAR launches by shape over the 5 iterations, and in the
    BQ model's fit and BASQ (quadrature, posterior draws, MAP)."""
    from sober_tpu_torch import Sober
    from sober_tpu_torch.apps.basq import BASQ
    from sober_tpu_torch.gp.exact import fit_gp_padded
    from sober_tpu_torch.gp.warped import ScaleMmltGP
    from sober_tpu_torch.tasks import setup_ecm_two
    from sober_tpu_torch.utils.prng import KeyRing

    small = phase_small_ecm_vs_cpu()
    n_init, iters, n_rec, n_nys, batch, n_quad, n_qnys, n_nodes, n_post, n_map = SBI_ECM
    dev = torch.device("cuda")
    with host_reads() as probe_sync:
        torch.cuda.synchronize()
    keys = KeyRing(0, device=dev)
    prior, sim = setup_ecm_two(device=dev)
    lo, hi = prior.bounds[0], prior.bounds[1]
    x = prior.sample(keys.next(), n_init)
    d, ll = sim(x)
    sober = Sober(prior, fit_gp_padded(x, d))
    seen = capture_recombination(sober)
    torch.cuda.synchronize()
    zero_counts()
    rows, path, shapes = [], {}, {}
    for it in range(iters):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launches = {}
        with counted(launches, shapes):
            t0 = time.perf_counter()
            model = fit_gp_padded(x, d)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            sober.update_model(model)
            with host_reads() as reads:
                xb = sober.next_batch(n_rec, n_nys, batch, verbose=True)
        for k, v in launches.items():
            path[k] = path.get(k, 0) + v
        checked = check_continuous_batch(sober, seen, xb, lo, hi, batch, f"sbi_ecm {it}")
        db, llb = sim(xb)
        x, d, ll = torch.cat([x, xb]), torch.cat([d, db]), torch.cat([ll, llb])
        t = sober.last_timings
        rows.append({"iteration": it, "proposal": type(sober.prior).__name__,
                     "n_obs": int(model.mask.sum()), "fit_ms": 1e3 * fit_s,
                     "candidates_ms": 1e3 * t["candidates"],
                     "recombination_ms": 1e3 * t["recombination"],
                     "next_batch_ms": 1e3 * t["total"], "launches": launches,
                     # verbose syncs the device three times
                     "host_reads": reads[0] - 3 * probe_sync[0],
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     **checked, "best_discrepancy": float(d.max())})
        emit(phase="sbi_ecm_iteration", **rows[-1])
    median = {k: statistics.median(r[k] for r in rows[1:4]) for k in
              ("fit_ms", "candidates_ms", "recombination_ms", "next_batch_ms",
               "host_reads", "peak_mem_gib")}

    def one_more():
        sober.update_model(fit_gp_padded(x, d))
        sober.next_batch(n_rec, n_nys, batch)
    with counted(path):
        profiled = busy_share(one_more)
    quad_shapes = {}
    with counted(path, quad_shapes):
        bq_model = ScaleMmltGP(x, ll)
        basq = BASQ(prior, bq_model, sober, verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        elml, avlml = basq.quadrature(n_quad, n_qnys, n_nodes)
        torch.cuda.synchronize()
        quad_ms = 1e3 * (time.perf_counter() - t0)
        post = basq.sampling_posterior(n_post)
        map_est = basq.MAP(n_map)
    require(bool(torch.isfinite(post).all()) and bool(((post >= lo) & (post <= hi)).all())
            and np.isfinite(elml), f"sbi_ecm: posterior draws or evidence {elml}")
    add_counts(counts, path, "sbi_ecm")
    truth = torch.tensor(ECM_TRUTH, device=dev)
    emit(phase="sbi_ecm", n_init=n_init, iterations=iters, n_rec=n_rec, n_nys=n_nys,
         batch=batch, d=5, prior_constant=float(prior.constant), gibbs=prior._use_gibbs,
         median_iterations_2_to_4=median, launches_on_path=path,
         profile_one_iteration=profiled, small_vs_cpu=small, quadrature=[n_quad, n_qnys, n_nodes],
         quadrature_ms=quad_ms, elml=elml, avlml=avlml,
         posterior_mean=post.mean(0).tolist(), map=map_est.tolist(), truth=list(ECM_TRUTH),
         map_distance=float(torch.linalg.norm(map_est - truth)),
         best_discrepancy=float(d.max()),
         launches_by_shape={" ".join(map(str, k)): v for k, v in shapes.items()},
         basq_launches_by_shape={" ".join(map(str, k)): v for k, v in quad_shapes.items()})
    return shapes, quad_shapes


class PhaseTimeout(Exception):
    pass


@contextlib.contextmanager
def time_limit(seconds: int, label: str):
    """Raises PhaseTimeout in the block after `seconds` (SIGALRM); a pool
    the block holds is terminated as its `with` unwinds."""
    import signal

    def expire(signum, frame):
        raise PhaseTimeout(f"{label}: over its limit of {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def phase_sober_wrapper(counts: dict) -> None:
    """README.md:60-67's guided interface on the card at its sizes
    (WRAPPER): SoberWrapper(model, data, bounds, model_initial_samples=100)
    on the ECM spectrum as a numpy simulator (`ecm_spectrum`) with the
    observed spectrum as data, prior="TruncatedGaussian" and use_bolfi=True
    (the parabolic-mean GP and SOBERUCB on the card) and
    parallelization=True (multiprocessing.Pool() forked after CUDA is up), then
    run_SOBER(3 of its 10 iterations, model_samples_per_iteration=100, so
    next_batch(400, 200, 100)) and run_BASQ(100), under a time limit. Every
    batch legal and inside the unit cube, the diagonalization equal to the
    CPU wrapper's; the moment errors are reported (calc_obj spends the
    batch's freedom, so they are not gated)."""
    from sober_tpu_torch.apps import SoberWrapper
    from sober_tpu_torch.tasks import setup_ecm_two

    n_init, per_iter, iters, nodes = WRAPPER
    dev = torch.device("cuda")
    _, sim = setup_ecm_two(device="cpu")
    omega = sim.omega.double().numpy()
    kw = dict(model=ecm_spectrum, data=torch.cat([sim.reZ, sim.imZ]).numpy(),
              bounds=[list(ECM_BOUNDS[0]), list(ECM_BOUNDS[1])],
              prior="TruncatedGaussian", use_bolfi=True, parallelization=True, seed=0,
              omega=omega, log_mu=float(sim.mu), log_sd=float(sim.sigma))
    cpu = SoberWrapper(**kw, model_initial_samples=4, standalone=False, device="cpu")
    zero_counts()
    path, t0 = {}, time.perf_counter()
    with time_limit(WRAPPER_SECONDS, "sober_wrapper"), counted(path):
        w = SoberWrapper(**kw, model_initial_samples=n_init, device=dev)
        t_init = time.perf_counter()
        seen = capture_every_recombination(w.sober)
        w.run_SOBER(sober_iterations=iters, model_samples_per_iteration=per_iter,
                    verbose=False)
        t_sober = time.perf_counter()
        samples, map_params, best, elml, avlml = w.run_BASQ(nodes, verbose=False)
        t_basq = time.perf_counter()
    require(torch.equal(w.diagonalization.cpu(), cpu.diagonalization),
            "sober_wrapper: diagonalization differs from the CPU's")
    require(len(seen) == iters, f"sober_wrapper: {len(seen)} batches")
    moms = []
    for it, rec in enumerate(seen):
        check_batch(rec["idx"], rec["w"], rec["x_cand"].shape[0], per_iter,
                    f"sober_wrapper {it}")
        xb = rec["x_cand"][rec["idx"]]
        require(bool(torch.isfinite(xb).all()) and bool(((xb >= 0) & (xb <= 1)).all()),
                f"sober_wrapper {it}: batch outside the unit cube")
        moms.append(moment_error(rec["kernel"], rec["x_cand"], rec["x_nys"],
                                 rec["weights"], rec["idx"], rec["w"], per_iter))
    require(w.X_all.shape[0] == n_init + iters * per_iter and np.isfinite(elml),
            f"sober_wrapper: {w.X_all.shape[0]} evaluations, evidence {elml}")
    add_counts(counts, path, "sober_wrapper")
    emit(phase="sober_wrapper", model_initial_samples=n_init,
         model_samples_per_iteration=per_iter, iterations=iters, basq_nodes=nodes,
         prior=type(w.prior).__name__, gibbs=w.prior._use_gibbs,
         surrogate_mean=w.surrogate_model.config.mean, pool_start_method=multiprocessing.get_start_method(),
         pool_workers=os.cpu_count(),
         init_s=t_init - t0, run_sober_s=t_sober - t_init, run_basq_s=t_basq - t_sober,
         iteration_s=[r[0] for r in w.results], best_per_iteration=[r[1] for r in w.results],
         moment_err=moms, elml=elml, avlml=avlml, map=map_params.tolist(),
         best_observed=best.tolist(), truth=list(ECM_TRUTH), launches_on_path=path,
         diag_order=w.diag_order)


def ep_simulator(x, **kwargs):
    """tests/test_apps.py:261's identity simulator."""
    x = np.atleast_2d(np.asarray(x))
    return np.stack([x[:, 0], x[:, 1]], axis=1)


def ep_features(obs):
    obs = np.asarray(obs)
    return [obs[..., 0], obs[..., 1]]


def phase_ep_flow(counts: dict) -> None:
    """tests/test_apps.py:261's expectation propagation on the card: the
    identity simulator, theta* = (0.6, -0.4), 20 initial samples, one sweep
    of 2 SOBER iterations at batch 16 a site (EP_RUN). The posterior mean
    must land within 0.15 of theta* and closer than the prior's, the
    posterior tighter than the prior, as the JAX test asserts."""
    from sober_tpu_torch.apps import ExpectationPropagation

    dev = torch.device("cuda")
    theta = np.asarray(EP_THETA)
    zero_counts()
    path, t0 = {}, time.perf_counter()
    with counted(path):
        ep = ExpectationPropagation(model=ep_simulator, data=theta,
                                    feature_extractor=ep_features, model_initial_samples=20,
                                    bounds=[[-1.0, -1.0], [1.0, 1.0]], parallelization=False,
                                    seed=0, device=dev)

        def original(m):
            return ep.reverse_transform(ep.denormalize_input(torch.atleast_2d(m)))[0].cpu().numpy()

        prior_err = float(np.abs(original(ep.normalized_mean) - theta).max())
        ep.run_Expectation_Propagation(**EP_RUN)
    post_cov = torch.linalg.inv(ep.Q)
    post_mean = original(post_cov @ ep.r)
    err = float(np.abs(post_mean - theta).max())
    tighter = bool((torch.diag(post_cov) < torch.diag(ep.normalized_covariance)).all())
    require(err < 0.15 and err < prior_err and tighter,
            f"ep_flow: error {err} (prior {prior_err}), tighter {tighter}")
    add_counts(counts, path, "ep_flow")
    emit(phase="ep_flow", theta_star=list(EP_THETA), posterior_mean=post_mean.tolist(),
         error=err, prior_error=prior_err, posterior_var=torch.diag(post_cov).tolist(),
         seconds=time.perf_counter() - t0, launches_on_path=path)


def phase_tmvn_tail() -> None:
    """The Gibbs and tilting samplers on the card at tests/test_mvn.py's
    tail box (rho 0.8 on [2, 4]^2, truth by 6,000,000 numpy rejection
    proposals) and low-acceptance box (identity on [3, 4]^2, truth by
    scipy's truncnorm): 20,000 draws inside the box, marginal means and sds
    within that file's tolerances in sd units (TMVN_TOL)."""
    from scipy.stats import truncnorm

    from sober_tpu_torch.priors import TruncatedMVN
    from sober_tpu_torch.utils.prng import KeyRing

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rho = np.array([[1.0, 0.8], [0.8, 1.0]])
    keep = []
    for _ in range(12):
        raw = rng.standard_normal((500_000, 2)) @ np.linalg.cholesky(rho).T
        keep.append(raw[((raw > 2.0) & (raw < 4.0)).all(axis=1)])
    keep = np.concatenate(keep)
    tn = truncnorm(3.0, 4.0)
    boxes = {"tail": (rho, 2.0, 4.0, keep.mean(0), keep.std(0)),
             "low_acceptance": (np.eye(2), 3.0, 4.0, np.full(2, tn.mean()), np.full(2, tn.std()))}
    keys, out = KeyRing(0, device=dev), {}
    for name, (cov, a, b, mean, sd) in boxes.items():
        bounds = np.array([[a, a], [b, b]])
        for method, (mean_tol, sd_tol) in TMVN_TOL.items():
            sampler = TruncatedMVN(np.zeros(2), cov, bounds, method=method, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = sampler.sample(keys.next(), TMVN_DRAWS)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            xs = x.double().cpu().numpy()
            mean_err = np.abs(xs.mean(0) - mean) / sd
            sd_err = np.abs(xs.std(0) - sd) / sd
            label = f"tmvn_tail {name} {method}"
            require(bool(((xs >= a - 1e-4) & (xs <= b + 1e-4)).all()), f"{label}: outside")
            require(bool((mean_err < mean_tol).all() and (sd_err < sd_tol).all()),
                    f"{label}: mean err {mean_err}, sd err {sd_err}")
            out[f"{name}_{method}"] = {"mean_err_sd": mean_err.tolist(),
                                       "sd_err_rel": sd_err.tolist(), "ms": ms,
                                       "burn_in": sampler.burn_in,
                                       "accept_rate": sampler.last_accept_rate}
    emit(phase="tmvn_tail", draws=TMVN_DRAWS, tolerances=TMVN_TOL, **out)


def main() -> None:
    smi, sm_clock = phase_device()
    phase_build()
    summary, counts = {}, {}
    phase_rbf(summary)
    phase_rbf_backward()
    phase_car(summary, sm_clock)
    t0 = time.perf_counter()
    pool, targets = make_pool()
    emit(phase="dataset_pool", shape=list(pool.shape),
         density=float(pool.mean()), seconds=time.perf_counter() - t0)
    phase_tanimoto(summary, pool)
    phase_small_vs_cpu()
    phase_small_dataset_vs_cpu()
    for row in CONFIGS:
        phase_iteration(row, counts)
    phase_dataset_iteration(pool, targets, counts)
    phase_sober_loop(counts)
    phase_branin_gate(counts)
    phase_ising_step(counts)
    phase_discrete_flows(counts)
    phase_fbgp_refit(counts)
    phase_fbgp_sweep_factor()
    phase_rbf_busiest(summary, phase_fbgp_step(counts), "fbgp_step")
    phase_fbgp_hartmann(counts)
    phase_basq_evidence(counts)
    ecm_shapes, quad_shapes = phase_sbi_ecm(counts)
    phase_rbf_busiest(summary, ecm_shapes, "sbi_ecm", SBI_ECM[1])
    phase_rbf_busiest(summary, quad_shapes, "sbi_quadrature", top=2)
    phase_sober_wrapper(counts)
    phase_ep_flow(counts)
    phase_tmvn_tail()
    phase_path_shapes()
    kernels = []
    for name in ("rbf_gram", "car_eliminate", "tanimoto_gram", "pack_bits"):
        s = summary[name]
        require(counts[name] > 0, f"{name} not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": counts[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        # no single PyTorch call computes any of the four
                        "library_ms": None, "shape": s["shape"],
                        **{k: s[k] for k in ("gram_ms", "product_library_ms",
                                             "store_library_ms", "step_floor_ms")
                           if k in s}})
    # the RBF Gram at the Ising step's d = 24 strips and the FBGP step's and
    # tutorial 05's busiest shapes
    kernels[0]["ising_d24_strips"] = summary["rbf_gram_ising_d24"]
    kernels[0]["fbgp_step_shapes"] = summary["rbf_gram_fbgp_step"]
    kernels[0]["sbi_ecm_shapes"] = summary["rbf_gram_sbi_ecm"]
    kernels[0]["sbi_quadrature_shapes"] = summary["rbf_gram_sbi_quadrature"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
