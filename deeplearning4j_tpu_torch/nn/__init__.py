"""Neural-network core of the port: configs, layers, the graph model and
the sequential model."""
