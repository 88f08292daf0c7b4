"""Matmul precision for the estimator's numerical core.

The JAX package wrapped every estimator entry point in full-f32 matmul
precision (`ctrlvio_tpu/utils/precision.py::f32_matmuls`): reduced-precision
matmuls make the normal equations, the Schur products and the square-root
marginalization lose the digits the prior recursion needs, and the
estimator diverges. On the card the counterpart is one setup call: float32
matrix products and cuDNN convolutions in full float32 (no TF32).
"""

from __future__ import annotations

import torch


def pin_f32_matmuls():
    """Full-f32 matmuls and convolutions (TF32 off), process-wide."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
