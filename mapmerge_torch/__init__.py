"""PyTorch + CUDA port of the map merger (mapmerge_tpu is the reference).

The module tree mirrors `mapmerge_tpu/` name for name. Plain tensor code is
PyTorch; the two Pallas kernels of the reference are hand-written CUDA C++
kernels for Hopper (`csrc/`, bound in `kernels/`), and its g++ host library
(the merge-graph solve and the LZF decoder) is the port's own
`csrc/mapmerge_native.cpp`, bound in `native/`. Nothing here imports jax
or any module of `mapmerge_tpu`: the port keeps its own copies of the
reference's framework-free modules (`core/params.py`, `core/enums.py`,
`graph/merge_graph.py`, `graph/pose_graph.py`).

Entry points run on the current CUDA device unless the caller names another
(`device="cpu"`); with no card and no device named they raise
(`core/device.py`).

Every product runs in full float32: the reference computes its geometry at
`Precision.HIGHEST`, so TF32 is switched off for matmuls and convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
