"""Rotary position embeddings (rotate-half / NeoX convention, as used by
the Llama family): the half-split rotation, computed in fp32."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float,
                     device=None) -> torch.Tensor:
    """[max_seq_len, head_dim//2] angle table (fp32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                                   device=device) ** exponent)
    t = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv_freq)  # [S, D/2]


def apply_rope(x: torch.Tensor, angles: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [B, S, n_heads, head_dim] by per-token angles.

    ``positions`` [B, S] absolute token positions.  Positions past the
    table clamp to its last row, as a JAX gather does; only decode slots
    that are not live ever reach them, and their output is discarded.
    """
    ang = angles[positions.clamp(0, angles.shape[0] - 1)]   # [B, S, D/2]
    cos = torch.cos(ang)[:, :, None, :]                      # [B, S, 1, D/2]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)
