"""Admission webhooks (reference: pkg/webhooks)."""

from volcano_tpu_torch.webhooks.admission import (
    AdmissionChain, AdmissionError, default_admission,
)

__all__ = ["AdmissionChain", "AdmissionError", "default_admission"]
