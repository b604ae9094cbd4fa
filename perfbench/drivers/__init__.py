"""One driver a kind of traffic: `run(cell, seed, seconds, trace, device,
t_start)` -> `harness.Outcome`.  A mix names its driver."""
