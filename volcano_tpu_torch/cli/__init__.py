"""CLI (reference: pkg/cli + cmd/cli vcctl)."""
