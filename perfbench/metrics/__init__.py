"""One reader a per-layer metric, `<name>.py` with `read(ctx)`: the value
from the traced run's trace and counters, or None where there is
nothing to read (the metric is then left out of the line).  A quantity
split by the end-to-end metric it moves (`device_idle.train`,
`device_idle.serve`) has one reader under the name before the dot."""
