"""Step construction (only the serve engine's slot decode step is ported)."""
