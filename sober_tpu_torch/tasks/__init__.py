"""Benchmark tasks of the port: the drug-discovery datasets and the
synthetic continuous objectives."""
from .drug import (create_malaria_dataset, create_solvent_dataset,
                   featurise_smiles, setup_malaria, setup_solvent)
from .synthetic import (ackley, branin_product, hartmann6, setup_branin,
                        setup_hartmann, setup_shekel, shekel)

__all__ = ["ackley", "branin_product", "create_malaria_dataset",
           "create_solvent_dataset", "featurise_smiles", "hartmann6",
           "setup_branin", "setup_hartmann", "setup_malaria", "setup_shekel",
           "setup_solvent", "shekel"]
