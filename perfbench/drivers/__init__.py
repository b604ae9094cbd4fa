"""One driver a kind of traffic, `drivers/<driver>.py`; a mix names its
driver.  A driver has `accepts(config)`, which raises where it cannot
run a configuration (the dense drivers: `cells.sizes`), `run(cell, seed,
seconds, trace, device, t_start)` -> `harness.Outcome`, and
`readings(cell, seed, control, fault, lower, device, seconds)`, the
readings `perfbench.calibrate` sets a cell's limits from."""
