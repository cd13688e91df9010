"""PyTorch + CUDA port of the map merger (mapmerge_tpu is the reference).

The module tree mirrors `mapmerge_tpu/` name for name. Plain tensor code is
PyTorch; the two Pallas kernels of the reference are hand-written CUDA C++
kernels for Hopper (`csrc/`, bound in `kernels/`). Nothing here imports jax,
directly or through a `mapmerge_tpu` module: the only reference modules
reused are the framework-free ones (`core.params`, `core.enums`, `graph.*`).

Every product runs in full float32: the reference computes its geometry at
`Precision.HIGHEST`, so TF32 is switched off for matmuls and convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
