"""The benchmark of `volcano_tpu_torch` (see perfbench/README.md)."""
