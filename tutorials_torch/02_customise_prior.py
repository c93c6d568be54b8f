"""Tutorial 02 — Customise the prior for various domain types, with the
port (the torch twin of tutorials/02_customise_prior.py; the reference's
notebook 02 is missing from its repo, and this reconstructs it from the
prior zoo).

SOBER supports continuous / binary / categorical / mixed / dataset domains.
Every prior lives on the device it is given (CUDA unless another is named).

Run on the GPU: python tutorials_torch/02_customise_prior.py; on the CPU:
main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import torch  # noqa: E402

from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.priors import (BinaryPrior, CategoricalPrior,  # noqa: E402
                                    DatasetPrior, Gaussian, MixedBinaryPrior,
                                    TruncatedGaussian, Uniform)
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(device=None):
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    show = lambda t: t.cpu().numpy()

    # Continuous box with Sobol QMC sampling
    uniform = Uniform([[-1.0, 0.0], [1.0, 2.0]], device=device)
    print("uniform:", show(uniform.sample(keys.next(), 4)))

    # Correlated Gaussian
    gauss = Gaussian(torch.zeros(2), [[1.0, 0.5], [0.5, 1.0]], device=device)
    pdf0 = float(gauss.pdf(torch.zeros((1, 2), device=device))[0])
    print("gaussian pdf at 0:", pdf0)

    # Truncated Gaussian (Genz-normalized, Gibbs-sampled in the tails)
    tg = TruncatedGaussian(torch.zeros(2), torch.eye(2),
                           [[-1.0, -1.0], [1.0, 1.0]], device=device)
    print("truncated constant:", float(tg.constant))

    # 20 binary dims; categorical with ragged category values
    binary = BinaryPrior(20, device=device)
    cats = CategoricalPrior([[0.0, 1.0, 2.0], [10.0, 20.0]], device=device)
    print("binary:", show(binary.sample(keys.next(), 2)[0][:5]))
    print("categorical:", show(cats.sample(keys.next(), 3)))

    # Mixed domains: [continuous | discrete] blocks
    mixed = MixedBinaryPrior(2, 3, [[-1.0, -1.0], [1.0, 1.0]], device=device)
    print("mixed:", show(mixed.sample(keys.next(), 2)))

    # Dataset-as-domain: a consumable pool of candidates (drug discovery)
    ds = DatasetPrior(torch.arange(20.0).reshape(10, 2), torch.arange(10.0),
                      device=device)
    y = ds.query(torch.tensor([3, 5]))
    print("dataset queried:", show(y), "| remaining:", ds.n_available)
    return {"gaussian_pdf_at_0": pdf0, "truncated_constant": float(tg.constant),
            "dataset_queried": show(y).tolist(), "n_available": ds.n_available}


if __name__ == "__main__":
    main()
