"""PyTorch/CUDA port of deepfactors_tpu: dense monocular SLAM with
latent-code keyframe depth, dense SE(3) tracking and photometric bundle
adjustment, for an NVIDIA H100.

The module layout mirrors ``deepfactors_tpu`` (``geometry/se3.py``,
``ops/image.py``, ``mapping/mapper.py``, ``system.py``, ...). The two hot
linearisations (dense tracking and photometric BA) run as hand-written CUDA
kernels (``csrc/``, wrapped by ``ops/kernels/sfm_gram.py``); everything else
is plain PyTorch. Entry points run on ``device="cuda"`` unless the caller
asks for the CPU.
"""
import torch

__version__ = "0.1.0"


def configure_numerics() -> None:
    """Full-fp32 matmuls and convolutions on the card.

    PyTorch rounds float32 convolutions to TF32 by default (and matmuls when
    ``allow_tf32`` is set). TF32 keeps ~3 decimal digits: the Gram-to-system
    congruence (``system_from_gram``), the assembled GN system and its
    Cholesky solve need full fp32 — rounding there makes the damped system
    indefinite and the Cholesky NaN (the JAX package records the same
    failure for the TPU's bf16 matmul). Called by every entry point's
    constructor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
