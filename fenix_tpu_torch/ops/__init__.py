"""Search operators: metric canon, phase-1 kernels, two-phase top-k.

Importing this package pins float32 matrix products to full fp32 on the
card (TF32 off for matmul and cuDNN): the phase-2 rescore and the plain
kernel twins must be fp32-true, and ``allow_tf32`` is process-wide.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
