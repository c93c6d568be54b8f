"""Advanced 01 — BOLFI modelling, with the port (the torch twin of
tutorials/advanced_01_bolfi.py).

BOLFI structures the surrogate for likelihood-free inference: a learned
per-dimension parabolic mean (seeded from a parabolic fit of the initial
data) + Gamma-hyperprior RBF kernel, with the BOLFI UCB schedule as the
recombination acquisition. Available directly or via
SoberWrapper(use_bolfi=True).

Run on the GPU: python tutorials_torch/advanced_01_bolfi.py; on the CPU:
main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import numpy as np  # noqa: E402

from sober_tpu_torch.apps import SoberWrapper  # noqa: E402

# the simulator's parameter box, rows lower and upper
BOUNDS = np.array([[-2.0, -2.0], [2.0, 2.0]])


def model_fn(theta, **kwargs):
    theta = np.atleast_2d(np.asarray(theta))
    return (theta**2).sum(axis=1)          # pretend simulator


def main(n_init=30, n_iterations=3, batch_size=16, n_rec=2048,
         n_nys=64, n_nodes=32, device=None):
    wrapper = SoberWrapper(model=model_fn, data=np.zeros(1),
                           model_initial_samples=n_init, bounds=BOUNDS,
                           use_bolfi=True, parallelization=False, seed=0,
                           device=device)
    wrapper.run_SOBER(sober_iterations=n_iterations,
                      model_samples_per_iteration=batch_size,
                      surrogate_samples=n_rec,
                      surrogate_effective_samples=n_nys,
                      verbose=True)
    samples, MAP, best, elml, avlml = wrapper.run_BASQ(n_nodes, verbose=False)
    print("MAP (should be near the origin):", MAP.cpu().numpy().round(3))
    return MAP


if __name__ == "__main__":
    main()
