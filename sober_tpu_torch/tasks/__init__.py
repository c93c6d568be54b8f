"""Benchmark tasks of the port (the drug-discovery datasets, for now)."""
from .drug import (create_malaria_dataset, create_solvent_dataset,
                   featurise_smiles, setup_malaria, setup_solvent)

__all__ = ["create_malaria_dataset", "create_solvent_dataset",
           "featurise_smiles", "setup_malaria", "setup_solvent"]
