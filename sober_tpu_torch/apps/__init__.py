"""Applications built on Sober (port of sober_tpu/apps/): BASQ."""
from .basq import BASQ

__all__ = ["BASQ"]
