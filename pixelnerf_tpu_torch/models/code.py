"""NeRF positional encoding as one sin over interleaved frequencies/phases.

Counterpart of `pixelnerf_tpu/models/code.py:PositionalEncoding`: output
[x?, sin(f1 x), cos(f1 x), sin(f2 x), cos(f2 x), ...] with each cos taken
as sin(x + pi/2), frequencies interleaved f1 f1 f2 f2 ...
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["PositionalEncoding", "freq_phase"]


def freq_phase(num_freqs: int, freq_factor: float):
    """(2F,) float32 frequencies f1 f1 f2 f2 ... and phases 0 pi/2 0 pi/2 ..."""
    freqs = freq_factor * (2.0 ** np.arange(num_freqs, dtype=np.float32))
    freqs = np.repeat(freqs, 2)
    phases = np.zeros(2 * num_freqs, dtype=np.float32)
    phases[1::2] = np.pi * 0.5
    return freqs.astype(np.float32), phases


class PositionalEncoding(nn.Module):
    """sin/cos positional code of a (..., d_in) input; no parameters."""

    def __init__(
        self,
        num_freqs: int = 6,
        d_in: int = 3,
        freq_factor: float = float(np.pi),
        include_input: bool = True,
    ):
        super().__init__()
        self.num_freqs = num_freqs
        self.d_in = d_in
        self.freq_factor = freq_factor
        self.include_input = include_input

    @property
    def d_out(self) -> int:
        d = self.num_freqs * 2 * self.d_in
        return d + self.d_in if self.include_input else d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """:param x (..., d_in) -> (..., d_out)"""
        freqs, phases = freq_phase(self.num_freqs, self.freq_factor)
        f = torch.from_numpy(freqs).to(x.device)[:, None]  # (2F, 1)
        p = torch.from_numpy(phases).to(x.device)[:, None]
        embed = torch.sin(x[..., None, :] * f + p)  # (..., 2F, d_in)
        embed = embed.reshape(x.shape[:-1] + (self.num_freqs * 2 * self.d_in,))
        if self.include_input:
            embed = torch.cat([x, embed], dim=-1)
        return embed

    @classmethod
    def from_conf(cls, conf, d_in: int = 3) -> "PositionalEncoding":
        return cls(
            num_freqs=conf.get_int("num_freqs", 6),
            d_in=d_in,
            freq_factor=conf.get_float("freq_factor", float(np.pi)),
            include_input=conf.get_bool("include_input", True),
        )
