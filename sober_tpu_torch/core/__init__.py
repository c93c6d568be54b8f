"""pi, kernel recombination, the samplers and Sober of the port; the names
of sober_tpu.core.__all__."""
# Sober first: gp/ imports core.pi and core.rchq, and core.sober loads gp/
# whole before core.pi's own import of gp.exact could meet a half-loaded gp/
from .sober import Sober  # noqa: I001
from .pi import PI, lfi
from .prior_update import (bernoulli_mle, categorical_mle, update_binary_prior,
                           update_categorical_prior, update_continuous_prior,
                           update_mixed_prior)
from .rchq import RecombinationResult, recombination
from .rckernel import RecombinationKernel
from .sampler import EmpiricalSampler, MixtureSampler, RecombinationSampler

__all__ = [
    "recombination",
    "RecombinationResult",
    "PI",
    "lfi",
    "RecombinationKernel",
    "EmpiricalSampler",
    "RecombinationSampler",
    "MixtureSampler",
    "Sober",
    "update_binary_prior",
    "update_categorical_prior",
    "update_continuous_prior",
    "update_mixed_prior",
    "bernoulli_mle",
    "categorical_mle",
]
