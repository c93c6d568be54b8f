"""Tutorial 08 — Benchmarking against batch BO methods, with the port (the
torch twin of tutorials/08_benchmark_batch_bo.py): SOBER vs the full
baseline zoo on Branin.

TurBO's trust region is updated with each batch's values; the JAX twin's
loop tests a key its state dict never holds, so there TurBO keeps its first
region.

Run on the GPU: python tutorials_torch/08_benchmark_batch_bo.py; on the
CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.benchmarks import (TurboState,  # noqa: E402
                                        decoupled_thompson_sampling, dpp_ts,
                                        gibbon, hallucination,
                                        local_penalisation, sober_ts,
                                        thompson_sampling, turbo,
                                        update_turbo_state)
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp.exact import fit_gp_padded  # noqa: E402
from sober_tpu_torch.tasks import setup_branin  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402

BATCH, POOL, ITERS = 20, 4096, 3


def loop(acquire, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, f = setup_branin(device=device)
    x = prior.sample(keys.next(), 10)
    y = f(x)
    state = {"turbo": TurboState(dim=2, batch_size=BATCH)}
    for _ in range(ITERS):
        model = fit_gp_padded(x, y)
        xb = acquire(keys.next(), model, prior, state)
        yb = f(xb)
        x, y = torch.cat([x, xb]), torch.cat([y, yb])
        state["turbo"] = update_turbo_state(state["turbo"], yb)
    return float(y.max())


METHODS = {
    "SOBER": lambda k, m, p, s: Sober(p, m).next_batch(POOL, 200, BATCH),
    "TS": lambda k, m, p, s: thompson_sampling(k, m, p, POOL, BATCH),
    "decoupled TS": lambda k, m, p, s: decoupled_thompson_sampling(
        k, m, p, POOL, BATCH),
    "DPP-TS": lambda k, m, p, s: dpp_ts(k, m, p, 2048, BATCH, n_mcmc=20),
    "GIBBON": lambda k, m, p, s: gibbon(k, m, p, 2048, BATCH),
    "hallucination": lambda k, m, p, s: hallucination(
        k, m, lambda xx, yy: fit_gp_padded(xx, yy), p, BATCH),
    "local penal.": lambda k, m, p, s: local_penalisation(k, m, p, BATCH),
    "TurBO": lambda k, m, p, s: turbo(k, s["turbo"], m, p, BATCH),
    "SOBER-TS": lambda k, m, p, s: sober_ts(k, m, p, BATCH,
                                            n_cand_super=POOL,
                                            n_cand=1024, n_nys=128),
}


def main(batch=None, pool=None, iters=None, methods=None, device=None):
    global BATCH, POOL, ITERS
    if batch is not None:
        BATCH = batch
    if pool is not None:
        POOL = pool
    if iters is not None:
        ITERS = iters
    results = {}
    for name, acq in METHODS.items():
        if methods is not None and name not in methods:
            continue
        results[name] = loop(acq, device)
        print(f"{name:>14}: best = {results[name]:.4f}  (truth 10.6043)")
    return results


if __name__ == "__main__":
    main()
