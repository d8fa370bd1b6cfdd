"""The precision the program's float32 products run in.

PyTorch lets cuDNN compute float32 convolutions in TF32, a lower
precision, unless told not to. A configuration that states float32 runs
its float32 products in float32: cuDNN's and cuBLAS's TF32 off. Any other
configuration runs under PyTorch's defaults, as they stood when this
module was imported. Each runner sets this before it builds the program,
so runs in one process (`calibrate.py`) do not inherit each other's.
"""

from __future__ import annotations

import torch

_DEFAULTS = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def as_stated(model_conf: dict) -> None:
    float32 = model_conf.get("dtype", "float32") == "float32"
    matmul, cudnn = (False, False) if float32 else _DEFAULTS
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
