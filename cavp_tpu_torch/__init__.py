"""CAVP on PyTorch and CUDA: the port of ``cavp_tpu`` to one NVIDIA H100.

The JAX package ``cavp_tpu`` stays the reference; this package mirrors
its module layout and names so each module's counterpart is easy to
find. It imports ``torch`` and numpy only, never ``jax``, ``flax`` or
``cavp_tpu``: the machine with the card has no JAX.

What is ported so far is the avss eval and serving slice:

- ``cavp_tpu_torch.config``  : the ``Config`` fields the slice reads
- ``cavp_tpu_torch.audio``   : the trainer log-mel frontend
- ``cavp_tpu_torch.models``  : deep-stem ResNet + DeepLabV3+, the VGG
  audio tower, the sigmoid cross-attention and the assembled ``CAVP``
- ``cavp_tpu_torch.ops``     : the hand-written CUDA fusion kernel
  (``ops/kernels/fusion.py`` over ``csrc/fusion_kernel.cu``) and its
  build
- ``cavp_tpu_torch.metrics`` : MIoU and foreground-detection counters
- ``cavp_tpu_torch.engine``  : ``build_model``, the weight bridge from
  the JAX variables, the eval step and the serving ``Predictor``
- ``cavp_tpu_torch.data``    : the synthetic eval batch

Module parameter names are the reference's state-dict names, so a
reference ``.pth`` loads with ``strict=True``. Public functions keep the
JAX package's layouts (images ``[N,H,W,3]``, waveforms ``[N,C,L]``,
masks ``[N,H,W]`` int32); inside, modules are NCHW in ``channels_last``
memory format.
"""

__version__ = "0.1.0"
