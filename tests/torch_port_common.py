"""Shared set-up for the ``tests/test_torch_port_*.py`` parity tests.

One model, two packages: the port's ``CAVP`` is built from a seed, its
BatchNorm statistics and LayerNorm affines are moved off identity, and
the JAX package's variables are filled from its state dict through the
JAX package's own importer (``cavp_tpu.engine.convert``). Both then hold
the same weights, under the reference's names.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.engine.convert import import_torch_state_dict
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.engine.runner import build_model
from torch_ref import randomize_bn_stats

# the small avss config of tests/test_pallas_fusion.py:82-84
SMALL = dict(image_width=64, image_height=64, num_classes=5,
             visual_backbone=18, compute_dtype="float32")


def configs(**overrides):
    """(port config, JAX config) with the same fields."""
    kw = dict(SMALL, **overrides)
    return get_config("avss").replace(**kw), jax_get_config("avss").replace(**kw)


def jax_variables(jax_model, state_dict, hw):
    """JAX variables holding ``state_dict``'s weights, strictly."""
    shapes = jax.eval_shape(
        lambda r: jax_model.init(r, jnp.zeros((1, hw[0], hw[1], 3)),
                                 jnp.zeros((1, 96, 64, 1)), eval_mode=True),
        jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, report = import_torch_state_dict(
        {k: v.numpy() for k, v in state_dict.items()},
        zeros["params"], zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    return {"params": params, "batch_stats": stats}


def model_pair(seed=0, **overrides):
    """(port model, port config, JAX model, JAX config, JAX variables)."""
    cfg, jcfg = configs(**overrides)
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    randomize_bn_stats(model, seed)
    jmodel = jax_build_model(jcfg)
    jvars = jax_variables(jmodel, model.state_dict(),
                          (cfg.image_height, cfg.image_width))
    return model, cfg, jmodel, jcfg, jvars
