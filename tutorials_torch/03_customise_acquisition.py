"""Tutorial 03 — Customise acquisition functions, with the port (the torch
twin of tutorials/03_customise_acquisition.py).

SOBER's batch selection is quadrature-constrained, so any pointwise
acquisition can be layered on top via `calc_obj`: the recombination picks a
batch that satisfies the quadrature constraints while maximizing the
acquisition (the null-space push, core/rchq.py).

Run on the GPU: python tutorials_torch/03_customise_acquisition.py; on the
CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.benchmarks import expected_improvement  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp import predict  # noqa: E402
from sober_tpu_torch.gp.exact import fit_gp_padded  # noqa: E402
from sober_tpu_torch.tasks import setup_branin  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=50, n_rec=5000, n_nys=200, batch_size=16, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, f = setup_branin(device=device)
    x = prior.sample(keys.next(), n_init)
    y = f(x)
    model = fit_gp_padded(x, y)
    sober = Sober(prior, model)

    # Any callable X -> scores (a tensor on X's device) works as calc_obj:
    def ucb(x_cand):
        mu, var = predict(model, x_cand)
        return mu + 2.0 * torch.sqrt(var)

    # read the incumbent once, here: the recombination calls calc_obj on the
    # candidate pool, and a float() inside the callable would wait for the
    # device at every call. eta may stay a tensor on the device as well.
    eta = float(model.y.max())

    def ei(x_cand):
        return expected_improvement(model, eta, x_cand)

    for name, acq in [("none", None), ("UCB", ucb), ("EI", ei)]:
        xb = sober.next_batch(n_rec, n_nys, batch_size, calc_obj=acq)
        yb = f(xb)
        print(f"calc_obj={name:<5} batch max objective: {float(yb.max()):.4f}")


if __name__ == "__main__":
    main()
