"""pi, kernel recombination and the fused acquisition of the port."""
