"""Settings grammar, component registry and checkpoint format."""
