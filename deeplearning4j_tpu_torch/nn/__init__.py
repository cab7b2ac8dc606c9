"""Neural-network core of the port: configs, layers and the graph model."""
