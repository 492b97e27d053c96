"""CPU tests of the benchmark (and, marked gpu, its control on the card)."""
