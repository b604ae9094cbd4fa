"""CPU tests of the benchmark; `gpu` tests run on the card."""
