"""JAX and port models with the same weights, for the port's tests: the
port's `synthetic_params` loaded into both packages' nets."""
import numpy as np

from deeplearning4j_tpu.zoo import models as jzoo

from deeplearning4j_tpu_torch import zoo
from deeplearning4j_tpu_torch.util.params import (params_from_jax,
                                                  synthetic_params)


def nested(flat):
    """A flat {"layer/key": array} (or "layer/sub/key") dict as the JAX
    package's nested parameter tree."""
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.array(v)
    return tree


def jax_tree(jnet, flat):
    """`flat` as JAX net `jnet`'s parameter tree (its layers without
    parameters kept, as empty dicts)."""
    return {name: {} for name in jnet.params} | nested(flat)


def pair_of(tnet, jnet, seed=0):
    """(jnet, tnet): port net `tnet` on the CPU and JAX net `jnet`, both
    with the port's `synthetic_params(seed)`."""
    flat = synthetic_params(tnet.param_shapes(), seed=seed)
    tnet.init(params=params_from_jax(flat, device="cpu"))
    jnet.init()
    jnet.init(params=jax_tree(jnet, flat))
    return jnet, tnet


def pair(name, seed=0, **kw):
    """(JAX net, port net on the CPU) of zoo model `name`, both with the
    port's `synthetic_params(seed)`."""
    return pair_of(getattr(zoo, name)(**kw, device="cpu"),
                   getattr(jzoo, name)(**kw), seed)
