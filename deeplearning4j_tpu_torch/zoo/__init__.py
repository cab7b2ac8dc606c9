"""Model zoo of the port: `lenet_mnist`, `cifar_convnet`, `mlp_mnist`,
`char_rnn_lstm`, `resnet50` and `transformer_lm`."""
from .models import (char_rnn_lstm, cifar_convnet, lenet_mnist, mlp_mnist,
                     resnet50, transformer_lm)

__all__ = ["char_rnn_lstm", "cifar_convnet", "lenet_mnist", "mlp_mnist",
           "resnet50", "transformer_lm"]
