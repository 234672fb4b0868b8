"""Shared NN building blocks with the JAX package's dtype policy.

``cavp_tpu/models/layers.py`` keeps parameters in float32 and runs each
conv and matmul in the compute dtype of its input. These subclasses keep
torch's parameter names (``weight``, ``bias``, ``running_mean``, ...),
so the reference state dict loads unchanged, and override ``forward``
with that policy:

- ``Conv2d`` / ``Linear``: the f32 weight is cast to the input's dtype;
- ``BatchNorm2d``: the per-channel affine is computed in float32, from
  the running statistics (eval) or from the batch (train), and applied
  in the activation dtype (``layers.py:204-248``);
- ``LayerNorm``: the normalization math runs in float32 and the result
  is cast back to the input's dtype (``layers.py:251+``).

"float32" there is :func:`acc_dtype` of the input: float32 for bf16 and
float32 inputs, float64 for a float64 input (the JAX package's
``promote_types(dtype, float32)``), so a float64 model computes in
float64 throughout.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype statistics, norms and losses are computed in for
    activations of ``dtype``: at least float32."""
    return torch.promote_types(dtype, torch.float32)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """Train mode takes the batch statistics as float32 sums: the biased
    variance ``max(s2/n - mean^2, 0)`` normalizes, the unbiased one goes
    into the running variance, both running statistics move by
    ``momentum`` (torch's convention, 0.1). ``num_batches_tracked`` is
    left alone: the JAX package keeps no such count."""

    def forward(self, x):
        adt = acc_dtype(x.dtype)
        if self.training:
            n = float(x.numel() // x.shape[1])
            xf = x.to(adt)
            mean = xf.sum((0, 2, 3)) / n
            var = ((xf * xf).sum((0, 2, 3)) / n - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1.0, 1.0))
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        else:
            mean, var = self.running_mean.to(adt), self.running_var.to(adt)
        inv = torch.rsqrt(var + self.eps)
        gamma = self.weight.to(adt)
        scale = inv * gamma
        shift = (-mean * inv) * gamma + self.bias.to(adt)
        shape = (1, -1, 1, 1)
        return (x * scale.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        adt = acc_dtype(x.dtype)
        y = F.layer_norm(x.to(adt), self.normalized_shape, self.weight.to(adt),
                         self.bias.to(adt), self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    """timm-style Mlp (Linear -> exact GELU -> Linear); drop rates are 0
    in CAVP."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int):
        super().__init__()
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded torch-default initialization of every parameter.

    Conv and Linear weights and biases draw from U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) — torch's kaiming_uniform(a=sqrt(5)) bound —
    BatchNorm and LayerNorm affines are ones/zeros, running stats
    zeros/ones and the step count zero, and every other parameter (the
    unused positional embeddings) zeros: every tensor of the module, so
    the module may have been built without storage (``to_empty``). Draws
    come from ``generator`` in module order, so one seed gives one model on
    any device.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            for p in (m.weight, m.bias):
                if p is not None:
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_((u * 2.0 - 1.0) * bound)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        else:
            for p in m.parameters(recurse=False):
                p.zero_()
