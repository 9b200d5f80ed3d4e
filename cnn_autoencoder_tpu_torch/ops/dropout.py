"""Channel dropout on NHWC tensors: flax's ``nn.Dropout(rate,
broadcast_dims=(1, 2))`` as the JAX package's units configure it.

One keep-mask entry per (sample, channel), shared across H and W; kept
values are scaled by ``1 / (1 - rate)``.  The masks are drawn by the caller
before the forward (``Dropout.draw``, from an explicit generator) and
passed in, so a forward recomputed under ``torch.utils.checkpoint`` sees
the same masks; flax's mask bits come from its own key and cannot be
reproduced with torch's generators.
"""

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):

    def __init__(self, rate: float, channels: int):
        super().__init__()
        self.rate = float(rate)
        self.channels = channels

    def draw(self, batch: int, generator: Optional[torch.Generator] = None,
             device=None) -> torch.Tensor:
        """A (batch, channels) keep-mask, True with probability
        ``1 - rate``, drawn from ``generator`` (None: torch's default)
        on ``device``."""
        u = torch.rand(batch, self.channels, generator=generator,
                       device=device)
        return u < 1.0 - self.rate

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:   # flax: no 0 / 0 in the gradient
            return torch.zeros_like(x)
        if mask is None or mask.shape != (x.shape[0], x.shape[-1]):
            raise ValueError(f"train-mode dropout takes a ({x.shape[0]}, "
                             f"{x.shape[-1]}) keep-mask, got "
                             f"{None if mask is None else tuple(mask.shape)}")
        keep = 1.0 - self.rate
        return torch.where(mask[:, None, None, :], x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))
