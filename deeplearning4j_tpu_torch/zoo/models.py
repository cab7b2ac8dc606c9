"""Model zoo (counterpart of deeplearning4j_tpu/zoo/models.py:184-227)."""
from __future__ import annotations

from ..nn.conf.configuration import NeuralNetConfiguration
from ..nn.conf.graph_configuration import ElementWiseVertex
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (DenseLayer, LayerNormalization, RnnOutputLayer,
                              SelfAttentionLayer)
from ..nn.graph.graph import ComputationGraph


def transformer_lm(vocab_size=256, d_model=256, n_layers=4, n_heads=4,
                   ffn_mult=4, seed=12345, causal=True, use_pallas=False,
                   compute_dtype=None, updater=None, remat=None,
                   device=None):
    """Decoder-only transformer language model, the JAX package's graph
    with the same vertex names: one-hot [b, t, vocab] in, next-token
    softmax per position out; post-norm blocks of self-attention and a
    per-timestep Dense FFN with ElementWiseVertex residuals.
    use_pallas=True runs attention in the hand-written kernels. `updater`
    is stored for the training slice. `device`: the card unless "cpu"."""
    gb = (NeuralNetConfiguration.builder()
          .seed(seed).updater(updater).weight_init("xavier")
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
