"""Nyx-like proxy: white noise shaped in Fourier space by
``(1 + |k|^2)^(-11/12)``, a power spectrum falling as ``k^(-11/6)``; a torch
copy of the ``turbulent`` kind of the port's ``data/fields.py``."""
import torch


def make(shape, gen: torch.Generator, device) -> torch.Tensor:
    white = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    spec = torch.fft.rfftn(white)
    del white
    k2 = torch.zeros((), dtype=torch.float32, device=device)
    last = len(shape) - 1
    for ax, s in enumerate(shape):
        k = (torch.fft.rfftfreq(s, d=1.0 / s, device=device) if ax == last
             else torch.fft.fftfreq(s, d=1.0 / s, device=device)).to(torch.float32)
        view = [1] * len(shape)
        view[ax] = k.numel()
        k2 = k2 + (k * k).reshape(view)
    spec *= (1.0 + k2).pow_(-11.0 / 12.0)
    del k2
    return torch.fft.irfftn(spec, s=tuple(shape), dim=tuple(range(len(shape)))).contiguous()
