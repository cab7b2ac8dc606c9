"""Model zoo (counterpart of deeplearning4j_tpu/zoo/models.py:22-227:
`lenet_mnist`, `cifar_convnet`, `mlp_mnist`, `char_rnn_lstm`, `resnet50`
and `transformer_lm`; `vgg16` waits for ROADMAP queue 1, the convolution
family). Each builds its configuration through the config DSL, as the
JAX package does, and takes `device` (the card unless "cpu")."""
from __future__ import annotations

from ..nn.conf.configuration import BackpropType, NeuralNetConfiguration
from ..nn.conf.graph_configuration import ElementWiseVertex
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (ActivationLayer, BatchNormalization,
                              ConvolutionLayer, DenseLayer, GlobalPoolingLayer,
                              GravesLSTM, LayerNormalization, OutputLayer,
                              RnnOutputLayer, SelfAttentionLayer,
                              SubsamplingLayer)
from ..nn.graph.graph import ComputationGraph
from ..nn.multilayer.network import MultiLayerNetwork
from ..nn.updaters import Adam, Nesterovs


def lenet_mnist(seed=12345, updater=None, device=None):
    """LeNet for 28 x 28 x 1 NHWC digits (BASELINE configuration #1): two
    5x5 convolutions (20 and 50 maps) each followed by 2x2 max pooling, a
    500-wide ReLU Dense layer (it flattens the NHWC maps itself) and a
    10-way softmax; Nesterovs(0.01, 0.9) and xavier by default."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater or Nesterovs(learning_rate=0.01, momentum=0.9))
            .weight_init("xavier")
            .list()
            .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                    n_out=20, activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                    n_out=50, activation="identity"))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=500, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="MCXENT"))
            .input_type(InputType.convolutional(28, 28, 1))
            .build())
    return MultiLayerNetwork(conf, device=device)


def cifar_convnet(seed=12345, num_classes=10, updater=None, device=None):
    """A small convolutional net for 32 x 32 x 3 images: two 3x3 "same"
    convolutions (32 and 64 maps, ReLU) each followed by 2x2 max pooling,
    a 256-wide ReLU Dense layer and a softmax; Adam(1e-3) and relu init
    by default."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater or Adam(1e-3))
            .weight_init("relu")
            .list()
            .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                    n_out=32, activation="relu",
                                    padding=(1, 1)))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                    n_out=64, activation="relu",
                                    padding=(1, 1)))
            .layer(SubsamplingLayer(pooling_type="max", kernel_size=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(n_out=256, activation="relu"))
            .layer(OutputLayer(n_out=num_classes, activation="softmax",
                               loss="MCXENT"))
            .input_type(InputType.convolutional(32, 32, 3))
            .build())
    return MultiLayerNetwork(conf, device=device)


def mlp_mnist(seed=12345, hidden=512, device=None):
    """A two-hidden-layer ReLU perceptron (hidden, hidden / 2) on 784
    features with a 10-way softmax; Adam(1e-3), relu init."""
    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Adam(1e-3)).weight_init("relu")
            .list()
            .layer(DenseLayer(n_out=hidden, activation="relu"))
            .layer(DenseLayer(n_out=hidden // 2, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax", loss="MCXENT"))
            .input_type(InputType.feed_forward(784))
            .build())
    return MultiLayerNetwork(conf, device=device)


def char_rnn_lstm(vocab_size=80, hidden=256, layers=2, seed=12345, tbptt=50,
                  compute_dtype=None, device=None):
    """The GravesLSTM char-RNN (BASELINE configuration #3): `layers`
    GravesLSTM layers of `hidden` (tanh) and a per-step softmax over
    `vocab_size`, on one-hot [b, t, vocab] input, trained with
    Adam(2e-3) under truncated BPTT in windows of `tbptt` steps.
    `compute_dtype="bfloat16"` runs the products in bf16 while the cell
    state and the gate arithmetic stay float32."""
    b = (NeuralNetConfiguration.builder()
         .seed(seed).updater(Adam(2e-3)).weight_init("xavier")
         .compute_dtype(compute_dtype)
         .list())
    for _ in range(layers):
        b.layer(GravesLSTM(n_out=hidden, activation="tanh"))
    b.layer(RnnOutputLayer(n_out=vocab_size, activation="softmax",
                           loss="MCXENT"))
    b.set_input_type(InputType.recurrent(vocab_size))
    b.backprop_type(BackpropType.TRUNCATED_BPTT)
    b.tbptt_fwd_length(tbptt).tbptt_back_length(tbptt)
    return MultiLayerNetwork(b.build(), device=device)


def _resnet_conv_block(gb, name, n_in_name, filters, stride, project=True):
    """One ResNet v1 bottleneck block: conv1x1 (stride) -> conv3x3 ->
    conv1x1, each followed by batch norm, plus the skip (a strided 1x1
    projection + batch norm when `project`), then ReLU. Returns the name
    of its last vertex."""
    f1, f2, f3 = filters

    def conv(vertex, n_out, k, s, src):
        gb.add_layer(vertex, ConvolutionLayer(
            kernel_size=(k, k), stride=(s, s), n_out=n_out,
            activation="identity", convolution_mode="same", has_bias=False),
            src)

    conv(f"{name}_c1", f1, 1, stride, n_in_name)
    gb.add_layer(f"{name}_bn1", BatchNormalization(activation="relu"),
                 f"{name}_c1")
    conv(f"{name}_c2", f2, 3, 1, f"{name}_bn1")
    gb.add_layer(f"{name}_bn2", BatchNormalization(activation="relu"),
                 f"{name}_c2")
    conv(f"{name}_c3", f3, 1, 1, f"{name}_bn2")
    gb.add_layer(f"{name}_bn3", BatchNormalization(activation="identity"),
                 f"{name}_c3")
    skip = n_in_name
    if project:
        conv(f"{name}_proj", f3, 1, stride, n_in_name)
        gb.add_layer(f"{name}_projbn",
                     BatchNormalization(activation="identity"),
                     f"{name}_proj")
        skip = f"{name}_projbn"
    gb.add_vertex(f"{name}_add", ElementWiseVertex("add"), f"{name}_bn3",
                  skip)
    gb.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                 f"{name}_add")
    return f"{name}_relu"


def resnet50(num_classes=1000, image_size=224, seed=12345, updater=None,
             compute_dtype=None, remat=None, device=None):
    """ResNet-50 as a ComputationGraph, the JAX package's graph with the
    same vertex names: NHWC [b, image_size, image_size, 3] images in, a
    softmax over `num_classes` out; a 7x7/2 stem convolution, batch norm,
    3x3/2 max pooling, then [3, 4, 6, 3] bottleneck blocks, global average
    pooling and the output layer. `updater` defaults to Nesterovs(0.1,
    0.9), as in the JAX package; `compute_dtype="bfloat16"` runs the
    convolutions and activations in bf16 on float32 parameters and batch
    statistics. `remat` names the training forward's checkpoint policy
    (nn/remat.py). `device`: the card unless "cpu"."""
    gb = (NeuralNetConfiguration.builder()
          .seed(seed)
          .updater(updater or Nesterovs(learning_rate=0.1, momentum=0.9))
          .weight_init("relu")
          .compute_dtype(compute_dtype)
          .remat(remat)
          .graph_builder()
          .add_inputs("in"))
    gb.add_layer("stem_conv", ConvolutionLayer(
        kernel_size=(7, 7), stride=(2, 2), n_out=64, activation="identity",
        convolution_mode="same", has_bias=False), "in")
    gb.add_layer("stem_bn", BatchNormalization(activation="relu"),
                 "stem_conv")
    gb.add_layer("stem_pool", SubsamplingLayer(
        pooling_type="max", kernel_size=(3, 3), stride=(2, 2),
        convolution_mode="same"), "stem_bn")
    prev = "stem_pool"
    stages = [("s2", (64, 64, 256), 3, 1),
              ("s3", (128, 128, 512), 4, 2),
              ("s4", (256, 256, 1024), 6, 2),
              ("s5", (512, 512, 2048), 3, 2)]
    for sname, filters, blocks, stride in stages:
        prev = _resnet_conv_block(gb, f"{sname}b1", prev, filters, stride,
                                  project=True)
        for i in range(1, blocks):
            prev = _resnet_conv_block(gb, f"{sname}b{i + 1}", prev, filters,
                                      1, project=False)
    gb.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), prev)
    gb.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                    loss="MCXENT"), "avgpool")
    gb.set_outputs("out")
    gb.set_input_types(InputType.convolutional(image_size, image_size, 3))
    return ComputationGraph(gb.build(), device=device)


def transformer_lm(vocab_size=256, d_model=256, n_layers=4, n_heads=4,
                   ffn_mult=4, seed=12345, causal=True, use_pallas=False,
                   compute_dtype=None, updater=None, remat=None,
                   device=None):
    """Decoder-only transformer language model, the JAX package's graph
    with the same vertex names: one-hot [b, t, vocab] in, next-token
    softmax per position out; post-norm blocks of self-attention and a
    per-timestep Dense FFN with ElementWiseVertex residuals.
    use_pallas=True runs attention in the hand-written kernels (the
    forward, and under `fit` the backward). `updater` defaults to
    Adam(3e-4), as in the JAX package. `device`: the card unless "cpu"."""
    gb = (NeuralNetConfiguration.builder()
          .seed(seed).updater(updater or Adam(3e-4)).weight_init("xavier")
          .compute_dtype(compute_dtype)
          .remat(remat)
          .graph_builder()
          .add_inputs("tokens"))
    gb.add_layer("embed", DenseLayer(n_out=d_model, activation="identity"),
                 "tokens")
    prev = "embed"
    for i in range(n_layers):
        gb.add_layer(f"b{i}_attn",
                     SelfAttentionLayer(n_out=d_model, n_heads=n_heads,
                                        causal=causal, use_pallas=use_pallas,
                                        activation="identity"), prev)
        gb.add_vertex(f"b{i}_res1", ElementWiseVertex("add"), prev,
                      f"b{i}_attn")
        gb.add_layer(f"b{i}_ln1", LayerNormalization(), f"b{i}_res1")
        gb.add_layer(f"b{i}_ffn1", DenseLayer(n_out=d_model * ffn_mult,
                                              activation="relu"),
                     f"b{i}_ln1")
        gb.add_layer(f"b{i}_ffn2", DenseLayer(n_out=d_model,
                                              activation="identity"),
                     f"b{i}_ffn1")
        gb.add_vertex(f"b{i}_res2", ElementWiseVertex("add"), f"b{i}_ln1",
                      f"b{i}_ffn2")
        gb.add_layer(f"b{i}_ln2", LayerNormalization(), f"b{i}_res2")
        prev = f"b{i}_ln2"
    gb.add_layer("out", RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                       loss="MCXENT"), prev)
    gb.set_outputs("out")
    gb.set_input_types(InputType.recurrent(vocab_size))
    return ComputationGraph(gb.build(), device=device)
