"""Sequential models of the port."""
