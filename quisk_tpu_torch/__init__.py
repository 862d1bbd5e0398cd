"""quisk_tpu_torch — the receive chain, the PFB channelizer receiver, the
transmit chain and the spectrum services of quisk_tpu on PyTorch and CUDA.

A second package beside ``quisk_tpu`` (the JAX reference, which it never
imports).  Same op contract: an op holds its parameters as tensors on one
device, ``op.init_state(channels)`` gives the carried state and
``op(state, x) -> (state, y)`` processes one ``[channels, block]`` block
(the channelizers of ``ops/channelizer.py`` take ``[streams, block]``).
Hot kernels are hand-written CUDA for Hopper (``csrc/``, built at first
use by ``_kernels``); everything else is PyTorch.

Entry points run on the card (``device=None`` means ``cuda`` and raises
when there is none); ``device="cpu"`` runs the plain versions on the CPU.

Numerics are float32 throughout with no TF32: every accuracy-relevant
product of the reference is f32-exact (``Precision.HIGHEST``), so the
package turns TF32 matmuls off, and the path uses no cuDNN convolution.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False

from quisk_tpu_torch.modes import Mode  # noqa: E402,F401
from quisk_tpu_torch.rx import RxChain, RxChainConfig  # noqa: E402,F401
from quisk_tpu_torch.tx import TxChain, TxChainConfig  # noqa: E402,F401
