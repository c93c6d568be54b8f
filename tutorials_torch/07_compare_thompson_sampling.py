"""Tutorial 07 — Compare with Thompson sampling, with the port (the torch
twin of tutorials/07_compare_thompson_sampling.py).

Head-to-head on Branin: SOBER vs joint-draw TS vs pathwise (decoupled) TS
vs the SOBER-TS hybrid, same budget.

Run on the GPU: python tutorials_torch/07_compare_thompson_sampling.py; on
the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.benchmarks import (decoupled_thompson_sampling,  # noqa: E402
                                        sober_ts, thompson_sampling)
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp.exact import fit_gp_padded  # noqa: E402
from sober_tpu_torch.tasks import setup_branin  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def run(method, n_iter=4, batch=25, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, f = setup_branin(device=device)
    x = prior.sample(keys.next(), 10)
    y = f(x)
    for it in range(n_iter):
        model = fit_gp_padded(x, y)
        if method == "sober":
            sober = Sober(prior, model, seed=it)
            xb = sober.next_batch(8192, 256, batch)
        elif method == "ts":
            xb = thompson_sampling(keys.next(), model, prior, 4096, batch)
        elif method == "dts":
            xb = decoupled_thompson_sampling(keys.next(), model, prior,
                                             8192, batch)
        else:
            xb = sober_ts(keys.next(), model, prior, batch,
                          n_cand_super=8192, n_cand=1024, n_nys=128)
        x, y = torch.cat([x, xb]), torch.cat([y, f(xb)])
    return float(y.max())


def main(n_iter=4, batch=25, device=None):
    results = {}
    for m in ["sober", "ts", "dts", "sober_ts"]:
        results[m] = run(m, n_iter=n_iter, batch=batch, device=device)
        print(f"{m:>9}: best = {results[m]:.4f}  (truth 10.6043)")
    return results


if __name__ == "__main__":
    main()
