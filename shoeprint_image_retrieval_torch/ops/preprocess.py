"""Model-input normalisation (the reference's torchvision transform stack).

``ToTensor`` scaling to [0, 1], grayscale channel tripling and mean/std
normalisation (reference network.py:51-87, 210-228), as one batched op. The
padded region is re-zeroed so it looks exactly like the first conv's own
zero padding (the masked-extraction invariant of ``models/layers.py``).
"""

from __future__ import annotations

import torch


def normalize_batch(
    imgs_u8: torch.Tensor,
    valid_hw: torch.Tensor,
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
) -> torch.Tensor:
    """(B, Hc, Wc) u8 gray or (B, Hc, Wc, 3) u8 RGB -> (B, 3, Hc, Wc) f32."""
    x = imgs_u8.to(torch.float32) / 255.0
    if x.ndim == 3:
        x = x[:, None].expand(-1, 3, -1, -1)  # gray -> 3 channels
    else:
        x = x.permute(0, 3, 1, 2)
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)[None, :, None, None]
    s = torch.tensor(std, dtype=torch.float32, device=x.device)[None, :, None, None]
    x = (x - m) / s
    rows = torch.arange(x.shape[-2], device=x.device)[None, :, None] < valid_hw[:, 0, None, None]
    cols = torch.arange(x.shape[-1], device=x.device)[None, None, :] < valid_hw[:, 1, None, None]
    return x * (rows & cols)[:, None]
