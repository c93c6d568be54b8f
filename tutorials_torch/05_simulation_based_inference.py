"""Tutorial 05 — Fast Bayesian inference for SBI, with the port (the torch
twin of tutorials/05_simulation_based_inference.py).

Posterior + evidence for a battery equivalent-circuit model: SOBER explores
the discrepancy surface, then BASQ turns the collected log-likelihoods into
a quadrature evidence estimate, posterior samples (SIR), and a MAP.

Run on the GPU: python tutorials_torch/05_simulation_based_inference.py; on
the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.apps.basq import BASQ  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp.exact import fit_gp_padded  # noqa: E402
from sober_tpu_torch.gp.warped import ScaleMmltGP  # noqa: E402
from sober_tpu_torch.tasks import setup_ecm_two  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=100, n_iterations=5, n_rec=4096, n_nys=256,
         batch_size=50, n_quad=8192, n_quad_nys=256, n_nodes=64,
         n_post=500, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, simulator = setup_ecm_two(device=device)  # (discrepancy, loglik)
    x_all = prior.sample(keys.next(), n_init)
    d_all, ll_all = simulator(x_all)

    model = fit_gp_padded(x_all, d_all)
    sober = Sober(prior, model)
    for _ in range(n_iterations):
        model = fit_gp_padded(x_all, d_all)
        sober.update_model(model)
        xb = sober.next_batch(n_rec, n_nys, batch_size)
        db, llb = simulator(xb)
        x_all = torch.cat([x_all, xb])
        d_all = torch.cat([d_all, db])
        ll_all = torch.cat([ll_all, llb])

    bq_model = ScaleMmltGP(x_all, ll_all)     # doubly-warped GP on log-lik
    basq = BASQ(prior, bq_model, sober)
    basq.quadrature(n_quad, n_quad_nys, n_nodes)   # (log evidence, its variance)
    posterior_samples = basq.sampling_posterior(n_post)
    map_est = basq.MAP(2000)
    print("posterior mean:", posterior_samples.mean(0).cpu().numpy().round(2))
    print("MAP:", map_est.cpu().numpy().round(2))
    print("truth: [ 2.  -0.5 -1.   0.   0.5]")
    return map_est


if __name__ == "__main__":
    main()
