"""sober_tpu_torch: the PyTorch/CUDA port of sober_tpu for NVIDIA Hopper.

Module names mirror `sober_tpu/`. The package imports torch and never jax.
Its hand-written CUDA kernels (`csrc/`) are built at first use by
`ops/_build.py`; on CPU tensors every kernel wrapper computes its plain
PyTorch reference instead.
"""

__version__ = "0.1.0"

import torch as _torch

# Quadrature weights, GP posteriors and Caratheodory eliminations are
# precision-critical: lower-precision matmuls measurably degrade batch
# selection (sober_tpu/__init__.py). TF32 keeps ~3 decimal digits, so it is
# off for matmuls and convolutions alike.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .config import Settings, set_settings, settings  # noqa: E402
from .core.sober import Sober  # noqa: E402
from .gp.tanimoto import fit_tanimoto_gp  # noqa: E402
from .priors.dataset import DatasetPrior  # noqa: E402
from .utils.prng import KeyRing  # noqa: E402

# the reference's export name (SOBER/__init__.py:1-6)
setting_parameters = set_settings


def __getattr__(name):
    # lazy: SoberWrapper pulls in the apps stack
    if name == "SoberWrapper":
        from .apps.wrapper import SoberWrapper

        return SoberWrapper
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["DatasetPrior", "KeyRing", "Settings", "Sober", "SoberWrapper",
           "fit_tanimoto_gp", "set_settings", "setting_parameters", "settings",
           "__version__"]
