"""The arithmetic of the reference's products.

``F32`` computes every product in float32 (the caller turns TF32 off).
``FP8`` is the control: the nearest precision below the configuration's
bfloat16. Each product's operands are rounded to float8 e4m3 with a
per-tensor scale (its largest magnitude onto 448) and the gradient that
reaches its output to float8 e5m2 (onto 57344), as fp8 training recipes
do; the products then run in float32 on those values.
"""
from __future__ import annotations

import torch


class F32:
    name = "f32"

    @staticmethod
    def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, a, b)


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _E4M3(torch.autograd.Function):
    """Forward: rounded to e4m3; backward: the gradient straight through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradE5M2(torch.autograd.Function):
    """Forward: the identity; backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class FP8:
    name = "fp8"

    @staticmethod
    def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _GradE5M2.apply(torch.einsum(eq, _E4M3.apply(a), _E4M3.apply(b)))

