"""Tutorial 04 — Fast fully Bayesian GP modelling, with the port (the torch
twin of tutorials/04_fully_bayesian_gp.py).

Instead of a point estimate of the GP hyperparameters, FBGP marginalizes
over a hyperposterior WITHOUT MCMC: 1000 hypersamples are scored with the
FITBO marginal likelihood in ONE batched sweep of Cholesky factorizations,
then compressed to ~50 weighted support hypersamples by quadrature
distillation (RCHQ over hyperparameter space). Ground truth for Hartmann6:
3.32237.

Run on the GPU: python tutorials_torch/04_fully_bayesian_gp.py; on the CPU:
main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp import (FBGPAcquisitionFunction, FitboGP,  # noqa: E402
                                FullyBayesianGP, RBFHyperPrior,
                                quadrature_distillation, sampling_hypers)
from sober_tpu_torch.tasks import setup_hartmann  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=50, n_iterations=5, n_hypers=1000, n_nys_qd=100,
         n_qd=50, n_rec=8192, n_nys=256, batch_size=50, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, f = setup_hartmann(device=device)
    x_all = prior.sample(keys.next(), n_init)
    y_all = f(x_all)

    for it in range(n_iterations):
        gp = FitboGP(x_all, y_all)                       # WSABI-M warp
        hypers, lmls = sampling_hypers(gp, RBFHyperPrior(device=device),
                                       n_hypers=n_hypers,
                                       gen=keys.next())   # batched LML sweep
        w_qd, theta_qd = quadrature_distillation(hypers, lmls, n_nys=n_nys_qd,
                                                 n_qd=n_qd, gen=keys.next())
        fbgp = FullyBayesianGP(gp, w_qd, theta_qd)
        sober = Sober(prior, fbgp, seed=it)
        af = FBGPAcquisitionFunction(fbgp, "MES")         # or EI/UCB/BQBC/QBMGP
        xb = sober.next_batch(n_rec, n_nys, batch_size, calc_obj=af)
        x_all = torch.cat([x_all, xb])
        y_all = torch.cat([y_all, f(xb)])
        print(f"{len(x_all)}) best: {float(y_all.max()):.5f} (truth 3.32237)")
    return float(y_all.max())


if __name__ == "__main__":
    main()
