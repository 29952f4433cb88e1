"""polyaxon_tpu_torch — the PyTorch/CUDA port of ``polyaxon_tpu``.

A second package beside the JAX one, written for an NVIDIA H100.  It
keeps the JAX package's module and public function names so each
counterpart is easy to find, and imports nothing of it: what it needs
is copied here.

- ``ops.flash``:      flash-attention forward; a hand-written CUDA kernel
                      for Hopper (``csrc/flash_fwd.cu``) with its plain
                      PyTorch version beside it.
- ``ops.attention``:  ``dot_product_attention`` routing flash / plain.
- ``models``:         GPT-2 (``gpt2``), its decode cache (``kv_cache``),
                      greedy generation (``generate``), the registry.
- ``convert``:        flax GPT-2 params (as numpy) -> a torch state dict.
- ``cli``:            ``python -m polyaxon_tpu_torch.cli generate``.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; they
never drop to the CPU on their own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

# Full float32 on the card: a float32 matmul is full precision by
# default, but cuDNN runs float32 convolutions in TF32 (about three
# decimal digits) unless told otherwise.  The port is held against the
# JAX reference in float32, so both are pinned off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    passes another.  Raises when CUDA is wanted but missing — the port
    never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --cpu) "
            "to run on the CPU")
    return dev
