"""Benchmark tasks of the port: the drug-discovery datasets, the discrete
tasks (Ising, MaxSAT, pest control), the synthetic objectives and the ECM
battery simulator for simulation-based inference."""
from .discrete import (Ising, MaxSAT, PestControl, setup_ising, setup_maxsat,
                       setup_pest)
from .drug import (create_malaria_dataset, create_solvent_dataset,
                   featurise_smiles, setup_malaria, setup_solvent)
from .ecm import CanonicalECMTwoRCs, setup_ecm_two
from .synthetic import (ackley, branin_product, hartmann6, rosenbrock,
                        setup_ackley, setup_branin, setup_hartmann,
                        setup_rosenbrock, setup_shekel, shekel)

__all__ = ["CanonicalECMTwoRCs", "Ising", "MaxSAT", "PestControl", "ackley",
           "branin_product", "create_malaria_dataset", "create_solvent_dataset",
           "featurise_smiles", "hartmann6", "rosenbrock", "setup_ackley",
           "setup_branin", "setup_ecm_two", "setup_hartmann", "setup_ising",
           "setup_malaria", "setup_maxsat", "setup_pest", "setup_rosenbrock",
           "setup_shekel", "setup_solvent", "shekel"]
