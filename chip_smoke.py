"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Four paths. The first is one exact-GP batch-BO iteration on a continuous
domain: a warm-started MAP refit of the GP hypers, the posterior cache, the
incumbent eta, and the fused acquisition (pi weights, Nystrom features, the
halving tree of Caratheodory eliminations). The second is one
dataset-domain screening iteration, Sober.next_batch over a pool of
133,303 x 2048-bit fingerprints with a Tanimoto GP (bench.py:bench_dataset).
The third is the continuous Sober loop at examples/shekel.py's width:
fit_gp_padded -> update_model -> Sober.next_batch(200000, 500, 100) on
Shekel over [0, 10]^4 from a Sobol Uniform proposal that becomes a WKDE,
then Sober.step with a warm start and a polished batch. The fourth is the
quick-start Branin gate of tests/test_acceptance.py. The script

  0. requires a CUDA device and prints it (name and power limit from
     nvidia-smi), the torch and CUDA versions;
  1. builds the hand-written kernels from sober_tpu_torch/csrc;
  2. holds the RBF Gram kernel to its plain PyTorch reference at every
     shape the continuous iterations launch it at (and at d = 100), and
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

and prints one JSON line per phase, the kernels' summary, the card, and as
its last line {"ok": true, "device": {...}}. Any failed check raises, so the
exit code is non-zero and no result line is printed. Inputs are made from
numpy seeds; nothing is read from outside the repository.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import statistics
import subprocess
import sys
import time
import warnings

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
    continuous iterations launch, scalar and ARD lengthscales, and at
    d = 100 (the first port refused d > 64); device time per iteration of
    each config, summed over its launches."""
    from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    cases = [(name, d, n, m, k) for name, _, _, _, d, _, _ in CONFIGS
             for n, m, k in RBF_SHAPES[name]]
    cases.append(("width", 100, 512, 65_536, 0))
    per_iteration = {}
    for config, d, n, m, launches in cases:
        # at d = 100, coordinates in [-0.3, 0.3] keep the entries far from 0
        # and the reference's norm trick accurate
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
        for ard in (False, True):
            ls = (torch.as_tensor(rng.uniform(0.5, 1.5, d), dtype=torch.float32, device=dev)
                  if ard else torch.tensor(0.8, device=dev))
            os_ = torch.tensor(1.3, device=dev)
            params = {"lengthscale": ls, "outputscale": os_}
            got = rbf_gram(params, x, y)
            want = rbf_gram_reference(params, x, y)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # float64 direct differences on the first rows
            xs, ys = x[:64].double() / ls.double(), y.double() / ls.double()
            exact = float(os_) * torch.exp(-0.5 * ((xs[:, None] - ys[None]) ** 2).sum(-1))
            oracle_err = float((got[:64].double() - exact).abs().max())
            del xs, ys, exact
            # the kernel sums squared differences directly, the reference
            # uses the norm trick: they differ by the latter's cancellation
            require(err <= 1e-5 * float(os_) and oracle_err <= 1e-5 * float(os_),
                    f"rbf {n}x{m} d={d} ard={ard}: err {err}, oracle {oracle_err}")
            ms = cuda_ms(lambda: rbf_gram(params, x, y))
            plain_ms = cuda_ms(lambda: rbf_gram_reference(params, x, y))
            emit(phase="rbf_gram", config=config, shape=[n, m, d], ard=ard,
                 launches_per_iteration=launches, max_abs_err=err,
                 oracle_max_abs_err=oracle_err, tol=1e-5 * float(os_), ms=ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 store_library_ms=store_ms)
            if not ard and launches:
                acc = per_iteration.setdefault(config, {"ms": 0.0, "bound_ms": 0.0})
                acc["ms"] += launches * ms
                acc["bound_ms"] += launches * bound
            if (n, m, d, ard) == (512, 65_536, 10, False):
                summary["rbf_gram"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain_ms, "bound_ms": bound,
                                       "bound_by": by, "store_library_ms": store_ms,
                                       "shape": [n, m, d]}
    emit(phase="rbf_gram_per_iteration", device_ms=per_iteration)


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
    # the main path's shapes (a cluster at m=400, one block at m=200) and
    # the L2 variant's; beside the chosen plan, the alternatives are timed
    # on the same inputs: every other cluster size that holds the basis, and
    # the L2 kernel (the first port's design)
    for m, q in ((400, 200), (200, 100), (1000, 500)):
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
    from sober_tpu_torch.gp.exact import (GPConfig, GPParams, build_state,
                                          fit_params, posterior_max_mean,
                                          predictive_covariance)

    cfg = GPConfig(fit_iters=100)
    n_cand, n_nys, batch = 2048, 64, 16
    out = {}
    for dev in ("cpu", "cuda"):
        x_obs, y_obs, x_cand, x_nys, pdf = make_problem(n_cand, n_nys, batch, 3, 40, dev)
        if dev == "cpu":
            params = fit_params(x_obs, (y_obs - y_obs.mean()) / y_obs.std(), cfg)
        state = build_state(GPParams(*(p.to(dev) for p in params)), x_obs, y_obs, cfg)
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
               if f not in ("config", "kernel")}
    return state._replace(kernel=kernel, **{
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
    recombination weights >= 0 summing to 1, and the moment error below
    5e-3. Returns the moment error and the count of points on the
    boundary."""
    require(tuple(xb.shape) == (batch, lo.shape[0]), f"{label}: batch shape")
    require(bool(torch.isfinite(xb).all()), f"{label}: finite")
    require(bool(((xb >= lo) & (xb <= hi)).all()), f"{label}: inside the box")
    w = seen["w"]
    require(bool((w >= 0).all()) and abs(float(w.sum()) - 1.0) < 1e-3,
            f"{label}: w >= 0, sum w = {float(w.sum())}")
    mom = moment_error(sober.kernel, seen["x_cand"], seen["x_nys"], seen["weights"],
                       seen["idx"], w, batch)
    require(mom < 5e-3, f"{label}: moment error {mom}")
    on_boundary = int(((xb == lo) | (xb == hi)).any(dim=1).sum())
    return {"moment_err": mom, "on_boundary": on_boundary}


def launch_counts() -> dict:
    from sober_tpu_torch.ops.car import car_eliminate
    from sober_tpu_torch.ops.rbf_gram import rbf_gram

    return {"rbf_gram": rbf_gram.launches, "car_eliminate": car_eliminate.launches}


def zero_counts() -> None:
    from sober_tpu_torch.ops.car import car_eliminate
    from sober_tpu_torch.ops.rbf_gram import rbf_gram

    rbf_gram.launches = car_eliminate.launches = 0


# (n, m, d, ard) of every RBF Gram and (m, q) of every CAR basis that the
# Sober loop and the Branin gate launch
PATH_RBF_SHAPES, PATH_CAR_SHAPES = set(), set()


@contextlib.contextmanager
def counted(path: dict):
    """Adds the RBF and CAR launches made inside the block to `path`, and
    their shapes to PATH_RBF_SHAPES and PATH_CAR_SHAPES."""
    # the modules, not the functions of the same names that ops/ exports
    rbf = importlib.import_module("sober_tpu_torch.ops.rbf_gram")
    car = importlib.import_module("sober_tpu_torch.ops.car")
    rbf_inner, car_inner = rbf._launch, car._launch

    def rbf_launch(x, y, ls, os_):
        PATH_RBF_SHAPES.add((x.shape[0], y.shape[0], x.shape[1], ls.numel() > 1))
        return rbf_inner(x, y, ls, os_)

    def car_launch(mu, big_n, row_mask, n_take, plan):
        PATH_CAR_SHAPES.add(tuple(big_n.shape[-2:]))
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
    the Sober loop and the Branin gate launched, so every tile and variant
    the host picked on that path is held on the card: each (n, m, d, ard)
    Gram on coordinates in [-1, 1] (phase_rbf's draw), each (m, q) basis
    on car_problem's."""
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
    device time over the run's host-clock time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
