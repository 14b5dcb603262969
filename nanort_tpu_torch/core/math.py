"""Core vector math on torch tensors (port of ``nanort_tpu.core.math``).

Batched ``(..., 3)`` equivalents of the reference's scalar vector helpers
(nanort.h:321-472). Every product and sum is a separate tensor op, so no
fused multiply-add changes a rounding against the CUDA kernel, which is
compiled with ``--fmad=false``.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector dot product over the trailing axis, summed
    x, y, z in that order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3-vector cross product over the trailing axis, each
    component ``p - q`` of two separately rounded products in
    ``jnp.cross``'s order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def length(a: torch.Tensor) -> torch.Tensor:
    """Euclidean length, correctly rounded: torch's vectorized float32
    ``sqrt`` on the CPU is off by one ulp on ~0.7% of inputs, so float32
    takes the square root in float64 and rounds once (exact for sqrt)."""
    s = dot(a, a)
    if s.dtype == torch.float32:
        return torch.sqrt(s.double()).float()
    return torch.sqrt(s)


def normalize(a: torch.Tensor, eps: float = 1e-17) -> torch.Tensor:
    """Normalize; leaves near-zero vectors unchanged (reference
    ``vnormalize`` guards with len > 1e-17, nanort.h:390-398)."""
    n = length(a)[..., None]
    big = n > eps
    return torch.where(big, a / torch.where(big, n, torch.ones_like(n)), a)


def safe_inverse(v: torch.Tensor) -> torch.Tensor:
    """Zero-safe reciprocal of a ray direction (reference
    ``vsafe_inverse``, nanort.h:409-466): components with
    ``|v| < eps`` map to ``copysign(inf, v)`` — ``-0.0`` maps to
    ``-inf`` — everything else to ``1/v``."""
    eps = torch.finfo(v.dtype).eps
    tiny = v.abs() < eps
    signed_inf = torch.copysign(torch.full_like(v, float("inf")), v)
    denom = torch.where(tiny, torch.ones_like(v), v)
    return torch.where(tiny, signed_inf, torch.ones_like(v) / denom)
