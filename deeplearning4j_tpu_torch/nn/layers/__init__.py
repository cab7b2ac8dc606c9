"""Runtime layers of the port. Importing this package registers every
layer implementation with `base.create_layer`."""
from . import convolution, feedforward, misc, recurrent  # noqa: F401
