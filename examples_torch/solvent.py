"""Dataset-domain drug discovery: solvent (dipole) screening, 133k molecules.

The torch twin of examples/solvent.py: a DatasetPrior over 2048-bit
fingerprints, a Tanimoto GP, the weighted-predictive-covariance
recombination kernel, the queried rows consumed. It prints which
fingerprints were made (RDKit's Morgan fingerprints, or the hashed
character n-grams without RDKit). On the GPU: python
examples_torch/solvent.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_dataset_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import fingerprint_route, setup_solvent  # noqa: E402


def main(n_init=100, batch_size=100, n_rec=2000, n_nys=500,
         n_iterations=15, n_pool=None, device=None):
    print(f"fingerprints: {fingerprint_route()}")
    prior = setup_solvent(n_pool=n_pool, device=resolve_device(device))
    return run_dataset_loop(prior, n_init, batch_size, n_rec, n_nys,
                            n_iterations)


if __name__ == "__main__":
    main()
