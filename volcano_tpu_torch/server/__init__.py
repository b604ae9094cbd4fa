"""State server: the apiserver analogue for multi-process deployments."""

from volcano_tpu_torch.server.state_server import StateServer, serve

__all__ = ["StateServer", "serve"]
