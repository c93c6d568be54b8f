"""Tutorial 06 — Tips for drug discovery, with the port (the torch twin of
tutorials/06_drug_discovery.py).

Dataset-as-domain optimization over 2048-bit molecular fingerprints with a
Tanimoto-kernel GP: the candidate pool is the dataset itself, queried rows
are consumed, and the recombination kernel is the mean-weighted predictive
covariance (right for non-negative activity targets). On the GPU the
Tanimoto Grams run on packed fingerprint words (ops/tanimoto_gram.py).

Run on the GPU: python tutorials_torch/06_drug_discovery.py; on the CPU:
main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp import fit_tanimoto_gp  # noqa: E402
from sober_tpu_torch.tasks import fingerprint_route, setup_malaria  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=100, n_iterations=3, n_rec=2000, n_nys=500,
         batch_size=100, device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior = setup_malaria(device=device)     # ~19k molecules
    print(f"dataset: {prior.n_total} molecules x {prior.features.shape[1]} bits "
          f"({fingerprint_route()} fingerprints)")
    x_all, y_all = prior.sample(keys.next(), n_init)

    for _ in range(n_iterations):
        model = fit_tanimoto_gp(x_all, y_all)
        sober = Sober(prior, model,
                      kernel_type="weighted_predictive_covariance")
        idx_batch, x_batch = sober.next_batch(n_rec, n_nys, batch_size)
        y_batch = prior.query(idx_batch)     # consume the queried rows
        x_all = torch.cat([x_all, x_batch])
        y_all = torch.cat([y_all, y_batch])
        print(f"{len(x_all)}) best activity: {float(y_all.max()):.4f} "
              f"(remaining pool: {prior.n_available})")
    return float(y_all.max())


if __name__ == "__main__":
    main()
