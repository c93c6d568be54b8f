"""Tutorial 01 — How SOBER works, with the port (the torch twin of
tutorials/01_how_sober_works.py): the algorithm's internals, stage by
stage.

SOBER reframes batch BO as kernel quadrature:
  1. pi-measure: pi(x) = Phi((mu(x) - eta)/sigma(x)) is the probability the
     GP assigns to x improving on the incumbent eta.
  2. Importance sampling: draw n_rec candidates from the proposal (prior or
     learned WKDE) and weight them by pi/proposal.
  3. Proposal update: fit a weighted KDE (continuous dims) / weighted MLE
     (discrete dims) to the weights, and resample.
  4. Nystrom subset: KMeans centroids (continuous) summarize the pool.
  5. Kernel recombination: pick batch_size points whose weighted empirical
     measure matches the pool's mean embedding under the posterior
     covariance kernel — maximally informative AND diverse.

Run on the GPU: python tutorials_torch/01_how_sober_works.py; on the CPU:
main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.core import (PI, RecombinationKernel, Sober,  # noqa: E402
                                  recombination)
from sober_tpu_torch.gp import fit_gp_padded  # noqa: E402
from sober_tpu_torch.tasks import setup_branin  # noqa: E402
from sober_tpu_torch.utils import KeyRing, cleansing_weights  # noqa: E402


def main(n_init=50, n_rec=5000, n_nys=200, batch_size=20, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, f = setup_branin(device=device)
    x_obs = prior.sample(keys.next(), n_init)
    model = fit_gp_padded(x_obs, f(x_obs))

    # Stage 1-2: pi-importance weights over a candidate pool
    pi = PI(model)
    x_cand = prior.sample(keys.next(), n_rec)
    weights = cleansing_weights(pi(x_cand) / prior.pdf(x_cand))
    print(f"pi weights: {int((weights > 0).sum())} of {len(weights)} nonzero, "
          f"eta = {float(pi.eta):.3f}")

    # Stage 4-5: Nystrom subset + recombination
    kernel = RecombinationKernel(model, mode="predictive_covariance")
    x_nys = x_cand[torch.argsort(weights, descending=True)[:n_nys]]
    idx, w = recombination(x_cand, x_nys, batch_size, kernel,
                           init_weights=weights)
    print(f"batch of {int((w > 0).sum())} points, sum of quadrature weights = "
          f"{float(w.sum()):.4f}")
    print("batch spread (std):",
          x_cand[idx].std(0, correction=0).cpu().numpy().round(2))

    # The full pipeline is Sober.next_batch:
    sober = Sober(prior, model)
    x_batch = sober.next_batch(n_rec, n_nys, batch_size)
    print("next_batch:", tuple(x_batch.shape))
    return x_batch


if __name__ == "__main__":
    main()
