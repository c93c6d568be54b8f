"""Batch BO on SVM feature selection (20 binary + 3 continuous).

The objective trains scikit-learn's SVR; without scikit-learn main raises
ImportError.

The torch twin of examples/svm.py. On the GPU:
python examples_torch/svm.py; on the CPU: main(device="cpu").
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from examples_torch.common import run_bo_loop  # noqa: E402
from sober_tpu_torch.config import resolve_device  # noqa: E402
from sober_tpu_torch.tasks import setup_svm  # noqa: E402


def main(device=None, **overrides):
    try:
        import sklearn  # noqa: F401
    except ImportError as e:
        raise ImportError("examples_torch/svm.py needs scikit-learn for its "
                          "objective (sklearn.svm.SVR)") from e
    cfg = dict(n_init=50, batch_size=50, n_rec=5000, n_nys=200, n_iterations=10)
    cfg.update(overrides)
    prior, fn = setup_svm(device=resolve_device(device))
    return run_bo_loop(prior, fn, **cfg)


if __name__ == "__main__":
    main()
