"""Host-side utilities of the port (HTTP plumbing, parameter exchange)."""
