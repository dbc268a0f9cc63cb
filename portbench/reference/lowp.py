"""The control's lower precision: fp8, the step below the configuration's
bfloat16.

Each convolution's and linear layer's input and weight are rounded to
float8 e4m3 under a per-tensor scale (the largest magnitude maps to
e4m3's largest finite value, 448), and the gradient that flows back
through them to float8 e5m2 under the same rule (57344), as fp8 training
recipes scale them; the products themselves accumulate in float32.
"""

from __future__ import annotations

import torch


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)
