"""Model zoo of the port: `lenet_mnist`, `cifar_convnet`, `mlp_mnist`,
`char_rnn_lstm`, `resnet50` and `transformer_lm`, and the committed
pretrained LeNet (`load_pretrained`)."""
from .models import (char_rnn_lstm, cifar_convnet, lenet_mnist, mlp_mnist,
                     resnet50, transformer_lm)
from .pretrained import Labels, available_pretrained, load_pretrained

__all__ = ["Labels", "available_pretrained", "char_rnn_lstm",
           "cifar_convnet", "lenet_mnist", "load_pretrained", "mlp_mnist",
           "resnet50", "transformer_lm"]
