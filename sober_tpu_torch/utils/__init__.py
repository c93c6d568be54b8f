"""Numerics helpers of the port; the names of sober_tpu.utils.__all__."""
from .linalg import (jitter_cholesky, make_psd, mvn_logpdf, remove_anomalies,
                     safe_mvn_prob, solve_psd, symmetrize)
from .prng import KeyRing
from .sobol import SobolState, sobol_engine, sobol_sample
from .weights import (check_weights, cleansing_weights, deweighted_resampling,
                      weighted_resampling)

__all__ = [
    "KeyRing",
    "remove_anomalies",
    "symmetrize",
    "jitter_cholesky",
    "make_psd",
    "solve_psd",
    "mvn_logpdf",
    "safe_mvn_prob",
    "cleansing_weights",
    "check_weights",
    "weighted_resampling",
    "deweighted_resampling",
    "SobolState",
    "sobol_engine",
    "sobol_sample",
]
