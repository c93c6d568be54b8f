"""Fully Bayesian GP batch BO on Hartmann6 (tutorial 04 flow) with the port:
the WSABI warp -> the batched hyperposterior sweep -> quadrature
distillation -> the FBGP-marginal SOBER acquisition with MES.

The torch twin of examples/fbgp_hartmann.py. On the GPU: python
examples_torch/fbgp_hartmann.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp import FitboGP, RBFHyperPrior, fbgp_refit  # noqa: E402
from sober_tpu_torch.tasks import setup_hartmann  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=50, n_iterations=10, n_hypers=1000, n_nys_qd=100, n_qd=50,
         n_rec=8192, n_nys=256, batch_size=50, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, fn = setup_hartmann(device=device)
    x_all = prior.sample(keys.next(), n_init)
    y_all = fn(x_all)
    hp = RBFHyperPrior(device=device)
    gp = FitboGP(x_all, y_all)
    fbgp = fbgp_refit(gp, hp, n_hypers=n_hypers, n_nys=n_nys_qd,
                      n_qd=n_qd, gen=keys.next())
    sober = Sober(prior, fbgp, seed=0)
    for _ in range(n_iterations):
        # one fully-Bayesian iteration: the WSABI base refit, the
        # hyperposterior sweep, the distillation, the chain caches, the
        # candidates and the recombination with the MES row computed on the
        # refit hyperposterior. The staged flow (FitboGP + fbgp_refit +
        # update_model + next_batch with
        # calc_obj=FBGPAcquisitionFunction(fbgp, "MES")) computes the same.
        xb = sober.step_fbgp(x_all, y_all, hp, n_rec, n_nys, batch_size,
                             n_hypers=n_hypers, n_nys_qd=n_nys_qd,
                             n_qd=n_qd, calc_obj="MES")
        x_all = torch.cat([x_all, xb])
        y_all = torch.cat([y_all, fn(xb)])
        print(f"{len(x_all)}) best: {float(y_all.max()):.5f} (truth 3.32237)")
    return x_all, y_all


if __name__ == "__main__":
    main()
