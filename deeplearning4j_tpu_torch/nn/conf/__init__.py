"""Configuration DSL of the port (builder, layer configs, input types)."""
