"""Tutorial 00 — Quick start, with the port (the torch twin of
tutorials/00_quick_start.py).

Batch Bayesian optimization of the product-Branin function on [-2, 3]^2
(ground-truth maximum 10.6043 at (-1.0254, -1.0254)) in five batches of 30,
the reference notebook's config (n_init=10, n_rec=20000, n_nys=500).

Run on the GPU: python tutorials_torch/00_quick_start.py; on the CPU:
main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time  # noqa: E402

import torch  # noqa: E402

from sober_tpu_torch import Sober  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.gp.exact import fit_gp_padded  # noqa: E402
from sober_tpu_torch.tasks import setup_branin  # noqa: E402
from sober_tpu_torch.utils.prng import KeyRing  # noqa: E402


def main(n_init=10, n_iterations=5, n_rec=20000, n_nys=500, batch_size=30,
         device=None):
    # 1. The task: a prior over the domain and a black-box objective, both
    #    on the device (CUDA unless another is named).
    device = resolve_device(device)
    keys = KeyRing(0, device=device)
    prior, true_function = setup_branin(device=device)

    # 2. Initial design: quasi-random (Sobol) samples.
    x_all = prior.sample(keys.next(), n_init)
    y_all = true_function(x_all)

    # 3. The loop: fit a GP surrogate, ask SOBER for a diverse batch,
    #    evaluate, repeat. next_batch draws n_rec candidates from the
    #    learned pi-measure and sparsifies them by kernel recombination.
    model = fit_gp_padded(x_all, y_all)
    sober = Sober(prior, model)
    for _ in range(n_iterations):
        t0 = time.monotonic()
        model = fit_gp_padded(x_all, y_all)
        sober.update_model(model)
        x_batch = sober.next_batch(n_rec=n_rec, n_nys=n_nys,
                                   batch_size=batch_size)
        y_batch = true_function(x_batch)
        x_all = torch.cat([x_all, x_batch])
        y_all = torch.cat([y_all, y_batch])
        print(f"{len(x_all)}) Best value: {float(y_all.max()):.5e} "
              f"({time.monotonic()-t0:.2f}s)")

    print("Ground truth: 1.06043e+01")
    return float(y_all.max())


if __name__ == "__main__":
    main()
