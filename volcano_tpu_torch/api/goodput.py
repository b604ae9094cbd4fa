"""Goodput contract: the env a worker's progress record is named by and
the restart/resize epoch env stamped on progress and serving records
(the same values as `volcano_tpu.api.goodput.ENV_PROGRESS_FILE` and
`ENV_EPOCH`)."""

ENV_PROGRESS_FILE = "VTP_PROGRESS_FILE"
ENV_EPOCH = "VTP_EPOCH"
