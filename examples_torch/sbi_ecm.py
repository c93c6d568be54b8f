"""Simulation-based inference on the 2-RC battery ECM (tutorial 05 flow)
with the port: the SOBER acquisition on the discrepancy, then BASQ's
evidence and posterior.

The torch twin of examples/sbi_ecm.py. On the GPU: python
examples_torch/sbi_ecm.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.apps.basq import BASQ  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp import fit_gp  # noqa: E402
from sober_tpu_torch.gp.warped import ScaleMmltGP  # noqa: E402
from sober_tpu_torch.tasks import setup_ecm_two  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=100, n_iterations=10, n_rec=4096, n_nys=256, batch_size=50,
         n_quad=8192, n_quad_nys=256, n_nodes=64, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, sim = setup_ecm_two(device=device)
    x_all = prior.sample(keys.next(), n_init)
    d_all, ll_all = sim(x_all)
    model = fit_gp(x_all, d_all)
    sober = Sober(prior, model)
    for _ in range(n_iterations):
        model = fit_gp(x_all, d_all)
        sober.update_model(model)
        xb = sober.next_batch(n_rec, n_nys, batch_size)
        db, llb = sim(xb)
        x_all = torch.cat([x_all, xb])
        d_all = torch.cat([d_all, db])
        ll_all = torch.cat([ll_all, llb])
        print(f"{len(x_all)}) best discrepancy: {float(d_all.max()):.4f}")
    bq_model = ScaleMmltGP(x_all, ll_all)
    basq = BASQ(prior, bq_model, sober)
    basq.quadrature(n_quad, n_quad_nys, n_nodes)
    basq.sampling_posterior(500)
    map_est = basq.MAP(2000)
    print("MAP estimate:", map_est.cpu().numpy())
    print("true params:  [ 2.  -0.5 -1.   0.   0.5]")
    return map_est


if __name__ == "__main__":
    main()
