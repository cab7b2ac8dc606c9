"""Layer configuration dataclasses (counterpart of
deeplearning4j_tpu/nn/conf/layers.py; the configs `transformer_lm` uses).

Hyperparameters left as None inherit the builder's global values. The
`updater` field is stored as given and not used: the optimizer math
arrives with the training slice."""
from __future__ import annotations

from dataclasses import dataclass

from .inputs import InputType, RecurrentInputType

# Global hyperparameters a layer can override
_INHERITED = ("activation", "weight_init", "bias_init", "dropout", "updater")


@dataclass
class BaseLayerConf:
    name: str | None = None
    activation: str | None = None
    weight_init: str | None = None
    bias_init: float | None = None
    dropout: float | None = None
    updater: object | None = None

    def apply_global_defaults(self, g: dict):
        for k in _INHERITED:
            if getattr(self, k, None) is None and g.get(k) is not None:
                setattr(self, k, g[k])
        if self.activation is None:
            self.activation = "sigmoid"
        if self.weight_init is None:
            self.weight_init = "xavier"
        if self.bias_init is None:
            self.bias_init = 0.0
        if self.dropout is None:
            self.dropout = 0.0

    def get_output_type(self, input_type):
        raise NotImplementedError

    def set_n_in(self, input_type):
        """Infer n_in from the incoming InputType when unset."""
        if getattr(self, "n_in", None) in (None, 0):
            self.n_in = input_type.flat_size()


@dataclass
class FeedForwardLayerConf(BaseLayerConf):
    n_in: int | None = None
    n_out: int | None = None

    def get_output_type(self, input_type):
        return InputType.feed_forward(self.n_out)


@dataclass
class DenseLayer(FeedForwardLayerConf):
    """Fully connected layer; time-distributed on [b, t, f] input."""

    def get_output_type(self, input_type):
        if isinstance(input_type, RecurrentInputType):
            return InputType.recurrent(self.n_out)
        return InputType.feed_forward(self.n_out)


@dataclass
class RnnOutputLayer(FeedForwardLayerConf):
    """Per-timestep output layer for sequences [b, t, f]."""
    loss: str = "MCXENT"

    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)


@dataclass
class LayerNormalization(BaseLayerConf):
    """Layer norm over the feature (last) axis; no activation of its own."""
    n_in: int | None = None
    n_out: int | None = None
    eps: float = 1e-5

    def apply_global_defaults(self, g):
        explicit = self.activation
        super().apply_global_defaults(g)
        if explicit is None:
            self.activation = "identity"

    def set_n_in(self, input_type):
        if self.n_in in (None, 0):
            self.n_in = input_type.flat_size()
        self.n_out = self.n_in

    def get_output_type(self, input_type):
        return input_type


@dataclass
class BaseRecurrentConf(FeedForwardLayerConf):
    def get_output_type(self, input_type):
        return InputType.recurrent(self.n_out)


@dataclass
class SelfAttentionLayer(BaseRecurrentConf):
    """Multi-head self-attention over [b, t, f]. use_pallas=True routes the
    attention through the hand-written kernels (kernels/flash_attention.py)
    — the field keeps the JAX package's name; block_size is the key block
    of the plain blockwise path."""
    n_heads: int = 4
    causal: bool = False
    block_size: int = 256
    use_pallas: bool = False
    attention_dropout: float = 0.0
