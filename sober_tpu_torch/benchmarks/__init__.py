"""The competitor batch-BO baselines of the port (benchmarks/batch_bo.py)."""
from .batch_bo import (TurboState, decoupled_thompson_sampling, dpp_ts,
                       expected_improvement, gibbon, hallucination,
                       local_penalisation, maximize_acqf, sober_ts,
                       thompson_sampling, turbo, update_turbo_state)

__all__ = [
    "thompson_sampling",
    "decoupled_thompson_sampling",
    "dpp_ts",
    "gibbon",
    "hallucination",
    "local_penalisation",
    "TurboState",
    "update_turbo_state",
    "turbo",
    "sober_ts",
    "maximize_acqf",
    "expected_improvement",
]
