"""PyTorch/CUDA port of the in-situ VDI frame: the single-chip frame
(``models/pipelines.py``) and the distributed sort-last frame over an
in-process rank mesh (``parallel/``).

A second package beside ``scenery_insitu_tpu`` (the JAX reference, which
this package never imports). It keeps the reference's conventions at
every public function:

- volumes are ``f32[D, H, W]``, indexed ``[z, y, x]``;
- images are channels-first and premultiplied;
- an empty VDI slot has alpha 0 and depth +inf;
- depth is the shared camera's world-space ray parameter ``t``.

The hot loops run through CUDA C++ kernels written for Hopper
(``csrc/*.cu``, built at first use by ``kernels.py``). Each kernel has a
plain PyTorch version beside it; a wrapper runs that plain version only
for tensors that lie on the CPU, and on a CUDA tensor launches its kernel
or raises. Entry points take ``device=None``, meaning ``cuda``: without a
CUDA device they raise unless the caller asks for ``device="cpu"``.
"""

import torch

# The slice march resamples every slice with two matmuls, f32 or (on the
# card, ``matmul_dtype="bf16"``) bf16 operands with f32 accumulation and
# an f32 second product; TF32 would round the f32 operands to 10 mantissa
# bits and break parity with the reference (and the plain versions the
# kernels are held against).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
