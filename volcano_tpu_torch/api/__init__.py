"""The wire constants of `volcano_tpu.api` that the port's workloads
read, kept as the port's own copy."""
