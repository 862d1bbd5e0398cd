"""Application layer: config, flags, the radio session, graph services,
CAT control and the CLI."""
