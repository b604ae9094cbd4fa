"""Goodput contract: the restart/resize epoch env stamped on progress
and serving records (the same value as `volcano_tpu.api.goodput.ENV_EPOCH`)."""

ENV_EPOCH = "VTP_EPOCH"
