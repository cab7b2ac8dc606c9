"""Dataset fetchers of the port: MNIST, CIFAR and the synthetic sets."""
