"""cockroach_tpu_torch: the PyTorch and CUDA port of cockroach_tpu.

The port keeps the JAX package's module paths and names, so each module
here has its counterpart under cockroach_tpu/. It imports torch and numpy
only: nothing of JAX, pyarrow or the JAX package.

Entry points run on CUDA unless the caller asks for the CPU with
device="cpu". Without a CUDA device and without an explicit device they
raise; they never carry on quietly on the CPU.
"""

from typing import Optional, Union

import torch

# No float work on the port's path needs TF32: keep float32 products and
# convolutions in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: `device` when given, else CUDA.
    Raises when no device is given and CUDA is not available."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
