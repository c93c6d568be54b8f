"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

The main path is one exact-GP batch-BO iteration on a continuous domain:
a warm-started MAP refit of the GP hypers, the posterior cache, the
incumbent eta, and the fused acquisition (pi weights, Nystrom features,
the halving tree of Caratheodory eliminations). The script

  0. requires a CUDA device and prints it (name and power limit from
     nvidia-smi), the torch and CUDA versions;
  1. builds the hand-written kernels from sober_tpu_torch/csrc;
  2. holds the RBF Gram kernel to its plain PyTorch reference at the main
     path's shapes, and times both;
  3. holds the Caratheodory kernel to its reference at both configs'
     shapes, and times both;
  4. checks the port on the card against the port on the CPU (plain
     PyTorch references) on a small iteration;
  5. runs the full iteration at 65k/200 and 6. at 200k/100 (the
     configurations of bench.py), with the kernels' launch counts;

and prints one JSON line per phase, the kernels' summary, the card, and as
its last line {"ok": true, "device": {...}}. Any failed check raises, so the
exit code is non-zero and no result line is printed. Inputs are made from
numpy seeds; nothing is read from outside the repository.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# (name, n_cand, batch, n_nys, d, n_obs, CAR launches per iteration)
CONFIGS = (("65k/200", 65_536, 200, 512, 10, 500, 9),
           ("200k/100", 200_000, 100, 500, 4, 500, 11))
ITERS = 5
# where the TPU kernels live that the two CUDA kernels replace
REPLACES = {"rbf_gram": "sober_tpu/ops/pallas_kernels.py:131",
            "car_eliminate": "sober_tpu/ops/pallas_car.py:99"}


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of `reps` runs of fn, each timed by CUDA events after a
    warm-up, in ms."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    from sober_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    emit(phase="build", seconds=time.perf_counter() - t0, library=so.name)


def phase_rbf(summary: dict) -> None:
    from sober_tpu_torch.ops.rbf_gram import rbf_gram, rbf_gram_reference

    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    shapes = (("feature strip K(nys, pool)", 512, 65_536),
              ("K(pool, X) in predict", 65_536, 500))
    for label, n, m in shapes:
        d = 10
        x = torch.as_tensor(rng.uniform(-1, 1, (n, d)), dtype=torch.float32, device=dev)
        y = torch.as_tensor(rng.uniform(-1, 1, (m, d)), dtype=torch.float32, device=dev)
        for ard in (False, True):
            ls = (torch.as_tensor(rng.uniform(0.5, 1.5, d), dtype=torch.float32, device=dev)
                  if ard else torch.tensor(0.8, device=dev))
            os_ = torch.tensor(1.3, device=dev)
            params = {"lengthscale": ls, "outputscale": os_}
            got = rbf_gram(params, x, y)
            want = rbf_gram_reference(params, x, y)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # the kernel sums squared differences directly, the reference
            # uses the norm trick: they differ by the latter's cancellation
            require(err <= 1e-5 * float(os_), f"rbf {label} ard={ard}: err {err}")
            ms = cuda_ms(lambda: rbf_gram(params, x, y))
            plain_ms = cuda_ms(lambda: rbf_gram_reference(params, x, y))
            emit(phase="rbf_gram", shape=[n, m, d], ard=ard, label=label,
                 max_abs_err=err, tol=1e-5 * float(os_), ms=ms, plain_ms=plain_ms)
            if n == 512 and not ard:
                summary["rbf_gram"] = {"max_abs_err": err, "ms": ms,
                                       "plain_ms": plain_ms, "shape": [n, m, d]}


def phase_car(summary: dict) -> None:
    from sober_tpu_torch.core.rchq import null_basis
    from sober_tpu_torch.ops.car import (car_eliminate, car_eliminate_reference,
                                         reference_horizon)

    dev = torch.device("cuda")
    for m, q in ((400, 200), (200, 100)):
        rng = np.random.default_rng(m)
        p = m - q
        x = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32, device=dev)
        mu = rng.uniform(0.1, 1.0, m)
        mask = np.ones(m)
        mask[-7:] = 0.0                       # padding rows
        mu[-7:] = 0.0
        mu = torch.as_tensor(mu / mu.sum(), dtype=torch.float32, device=dev)
        mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
        big_n, n_take, active0 = null_basis(x, mu, m - p, mask)

        # full run: the invariants, for both
        mu_k, el_k = car_eliminate(mu, big_n, mask, n_take)
        mu_r, el_r = car_eliminate_reference(mu, big_n, mask, n_take)
        w_k, w_r = mu_k * (1 - el_k) * active0, mu_r * (1 - el_r) * active0
        moment = x.T @ mu
        mom_k = float((x.T @ w_k - moment).abs().max())
        mom_r = float((x.T @ w_r - moment).abs().max())
        n_k, n_r = int(el_k.sum()), int(el_r.sum())
        require(bool((w_k >= 0).all()) and bool((w_k[-7:] == 0).all()),
                f"car m={m}: w >= 0 and empty padding")
        require(mom_k < 1e-4 and mom_r < 1e-4, f"car m={m}: moments {mom_k} {mom_r}")
        require(n_k == n_r, f"car m={m}: {n_k} vs {n_r} eliminations")
        # exact agreement over the steps where fp32 rounding does not yet
        # decide the path (see reference_horizon)
        k = reference_horizon(mu, big_n, mask, n_take)
        require(k >= 10, f"car m={m}: reference horizon only {k} steps")
        mu_kh, el_kh = car_eliminate(mu, big_n, mask, k)
        mu_rh, el_rh = car_eliminate_reference(mu, big_n, mask, k)
        same = bool(torch.equal(el_kh, el_rh))
        dmu = float((mu_kh - mu_rh).abs().max())
        require(same and dmu <= 1e-5, f"car m={m} k={k}: same={same} dmu={dmu}")
        full_same = bool(torch.equal(el_k, el_r))
        ms = cuda_ms(lambda: car_eliminate(mu, big_n, mask, n_take))
        plain_ms = cuda_ms(lambda: car_eliminate_reference(mu, big_n, mask, n_take))
        emit(phase="car_eliminate", m=m, q=q, n_take=n_take, eliminated=n_k,
             horizon=k, same_set_at_horizon=same, max_abs_err=dmu,
             same_set_full_run=full_same, moment_err=mom_k,
             moment_err_reference=mom_r, ms=ms, plain_ms=plain_ms)
        if m == 400:
            summary["car_eliminate"] = {"max_abs_err": dmu, "ms": ms,
                                        "plain_ms": plain_ms, "shape": [m, q]}


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


def moment_error(state, x_cand, x_nys, weights, idx, w, batch) -> float:
    """Moment error of the batch on the port's own normalized feature strip
    (the same Gram, basis and scale that recombination used)."""
    from sober_tpu_torch.core.rchq import nystrom_basis
    from sober_tpu_torch.gp.exact import predictive_covariance
    from sober_tpu_torch.utils.linalg import symmetrize

    k_nys = symmetrize(torch.nan_to_num(predictive_covariance(state, x_nys, x_nys)))
    u = nystrom_basis(k_nys, batch - 1)
    phi = u @ predictive_covariance(state, x_nys, x_cand)
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
                                          fit_params, posterior_max_mean)

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
        out[dev] = (float(eta), weights.cpu(),
                    moment_error(state, x_cand, x_nys, weights, idx, w, batch))
    eta_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    w_err = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    require(eta_err < 1e-4, f"small: eta rel err {eta_err}")
    require(w_err < 1e-6, f"small: weights err {w_err}")
    require(out["cuda"][2] < 5e-3, f"small: moment err {out['cuda'][2]}")
    emit(phase="small_iteration_cuda_vs_cpu", eta_rel_err=eta_err,
         weights_max_abs_err=w_err, moment_err_cuda=out["cuda"][2],
         moment_err_cpu=out["cpu"][2])


def phase_iteration(cfg_row, counts: dict) -> None:
    from sober_tpu_torch.gp.exact import GPConfig, fit_params
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
    counts["rbf_gram"] = counts.get("rbf_gram", 0) + n_rbf
    counts["car_eliminate"] = counts.get("car_eliminate", 0) + n_car
    require(n_car == car_per_iter * (1 + ITERS),
            f"{name}: {n_car} CAR launches, want {car_per_iter} per iteration")
    require(n_rbf > 0, f"{name}: the RBF kernel never launched")

    check_batch(idx, w, n_cand, batch, name)
    mom = moment_error(state, x_cand, x_nys, weights, idx, w, batch)
    require(mom < 5e-3, f"{name}: moment error {mom}")
    emit(phase="iteration", config=name, n_cand=n_cand, batch=batch, n_nys=n_nys,
         d=d, n_obs=n_obs, iteration_s_median=statistics.median(times),
         iteration_s=times,
         stage_ms_median={k: statistics.median(v[1:]) for k, v in stages.items()},
         launches_per_iteration={"rbf_gram": n_rbf / (1 + ITERS),
                                 "car_eliminate": n_car / (1 + ITERS)},
         moment_err=mom, w_sum=float(w.sum()),
         lengthscale=float(state.kernel.params["lengthscale"]),
         noise=float(state.noise),
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def main() -> None:
    smi = phase_device()
    phase_build()
    summary, counts = {}, {}
    phase_rbf(summary)
    phase_car(summary)
    phase_small_vs_cpu()
    for row in CONFIGS:
        phase_iteration(row, counts)
    kernels = []
    for name, route_src in (("rbf_gram", "sober_tpu_torch/csrc/rbf_gram.cu"),
                            ("car_eliminate", "sober_tpu_torch/csrc/car_eliminate.cu")):
        s = summary[name]
        require(counts[name] > 0, f"{name} not launched on the main path")
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": REPLACES[name], "launches": counts[name],
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "shape": s["shape"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
