"""Serving stats contract: the env a serving replica's stats file is
named by (the same value as `volcano_tpu.api.serving.ENV_STATS_FILE`)."""

ENV_STATS_FILE = "VTP_SERVING_STATS_FILE"
