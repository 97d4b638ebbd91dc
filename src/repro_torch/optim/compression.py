"""Gradient compression: int8 quantization with error feedback.

Port of ``src/repro/optim/compression.py``, bit for bit: per-leaf
symmetric int8 with a per-leaf f32 scale; the quantization error is kept
in an error-feedback buffer and added back before the next quantization
(EF-SGD).  Trees are mappings keyed like the parameters; a compressed
leaf is the pair ``(q int8, scale f32)``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


def ef_init(params: Tensors) -> Dict[str, torch.Tensor]:
    """Zero error-feedback buffers (f32) beside each parameter."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def compress(grads: Tensors, ef_buf: Tensors
             ) -> Tuple[Dict[str, tuple], Dict[str, torch.Tensor]]:
    """Quantize (grads + carried error) to int8; returns (the tree of
    ``(q, scale)``, the new error buffers)."""
    qs, errs = {}, {}
    for name, g in grads.items():
        gf = g.float() + ef_buf[name]
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        qs[name] = (q, scale)
        errs[name] = gf - q.float() * scale
    return qs, errs


def decompress(qtree: Mapping[str, tuple]) -> Dict[str, torch.Tensor]:
    return {n: q.float() * scale for n, (q, scale) in qtree.items()}


def compressed_bytes(qtree: Mapping[str, tuple]) -> int:
    """Bytes on the wire: one per int8 entry and four per scale."""
    return sum(q.numel() + 4 for q, _ in qtree.values())
