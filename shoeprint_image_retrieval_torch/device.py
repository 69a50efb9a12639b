"""Device selection and the float32 precision switch.

The JAX reference runs its convolutions and dots at ``Precision.HIGHEST``
(``shoeprint_image_retrieval_tpu/models/layers.py``), i.e. full float32.
PyTorch lets cuDNN convolutions use TF32 by default, which keeps only about
three decimal digits, so every entry point calls :func:`resolve_device`,
which turns TF32 off for both cuDNN and cuBLAS.
"""

from __future__ import annotations

import torch


def set_float32_precision() -> None:
    """Full float32 for convolutions and matrix products (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(name: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default) or ``"cpu"`` -> a device; TF32 off.

    Asking for CUDA where there is no card raises: the port never falls
    back to the CPU silently.
    """
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass --device cpu (or device='cpu') to run on the CPU"
        )
    set_float32_precision()
    return dev


def free_bytes(dev: torch.device) -> int:
    """Device bytes this process can still allocate: what CUDA reports free
    (``torch.cuda.mem_get_info``) plus what PyTorch's caching allocator
    holds reserved but unallocated, which CUDA counts as used."""
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
