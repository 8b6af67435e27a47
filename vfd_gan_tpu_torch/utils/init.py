"""Parameter initialisers reproducing the reference's init distributions
(port of ``vfd_gan_tpu.utils.init``).

The reference applies ``weights_init`` after construction
(lib/utils.py:51-56): every ``nn.Conv3d`` kernel ~ N(0, 0.02), every
``nn.BatchNorm3d`` scale ~ N(1, 0.02) with zero bias.  Conv *biases* keep
PyTorch's default U(-1/sqrt(fan_in), +1/sqrt(fan_in)).

Values are drawn on the CPU from the passed ``torch.Generator`` and copied
into the tensor, so one seed gives the same weights on every device.
"""

from __future__ import annotations

import torch


STDDEV = 0.02


@torch.no_grad()
def dcgan_normal_(tensor: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """N(0, 0.02) for conv kernels hit by reference ``weights_init``."""
    return tensor.copy_(STDDEV * torch.randn(tensor.shape, generator=generator))


@torch.no_grad()
def bn_scale_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """N(1, 0.02) for BatchNorm scale (lib/utils.py:55)."""
    return tensor.copy_(
        1.0 + STDDEV * torch.randn(tensor.shape, generator=generator))


@torch.no_grad()
def torch_default_(tensor: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), +1/sqrt(fan_in)): PyTorch's default for conv
    biases."""
    bound = 1.0 / (fan_in ** 0.5) if fan_in > 0 else 0.0
    u = torch.rand(tensor.shape, generator=generator)
    return tensor.copy_((2.0 * u - 1.0) * bound)
