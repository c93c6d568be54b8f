"""Applications built on Sober (port of sober_tpu/apps/): BASQ, BOLFI's
surrogate and acquisitions, the guided SoberWrapper and expectation
propagation."""
from .basq import BASQ
from .bolfi import SOBERUCB, BoTorchLCBSC, make_bolfi_model
from .ep import ExpectationPropagation
from .wrapper import SoberWrapper

__all__ = ["BASQ", "BoTorchLCBSC", "ExpectationPropagation", "SOBERUCB",
           "SoberWrapper", "make_bolfi_model"]
