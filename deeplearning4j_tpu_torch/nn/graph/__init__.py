"""Graph models of the port."""
