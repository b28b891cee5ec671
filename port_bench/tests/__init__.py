"""CPU tests of the benchmark; `-m cuda` ones run a cell on a card."""
