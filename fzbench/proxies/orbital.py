"""QMCPACK-like proxy: einspline orbital coefficients, orbitals of 115 planes
stacked along axis 0. Each orbital is its own draw of the ``smooth`` kind of
the port's ``data/fields.py`` over its (115, rows, columns) grid: 6 separable
harmonic products (frequencies U(0.5, 4) cycles an axis, phases U(0, 2 pi),
amplitude U(0.2, 1)), scaled to unit RMS as QMCPACK's orbitals are
normalised, plus 0.01 standard-normal noise; the field jumps at every
orbital boundary. Drawn for all orbitals at once by broadcasting.

The normalisation keeps the field's range, an extreme over 288 orbitals that
sets the bound at a relative eb, from swinging with the amplitudes' draws:
without it the ratio spread 2.5% over six seeds on the card."""
import math

import torch

PLANES = 115          # planes an orbital (QMCPACK's 288 x 115 x 69 x 69 file)
TERMS = 6


def make(shape, gen: torch.Generator, device) -> torch.Tensor:
    if len(shape) != 3 or shape[0] % PLANES:
        raise ValueError(f"orbital fields are 3-D with a leading axis of whole "
                         f"orbitals of {PLANES} planes, got {tuple(shape)}")
    m = shape[0] // PLANES
    dims = (PLANES, shape[1], shape[2])
    out = torch.zeros((m, *dims), dtype=torch.float32, device=device)
    for _ in range(TERMS):
        u = torch.rand((3, m, 3), generator=gen, device=device)
        freqs, phase, amp = 0.5 + 3.5 * u[0], 2 * math.pi * u[1], 0.2 + 0.8 * u[2, :, 0]
        axes = []
        for ax, s in enumerate(dims):
            g = torch.linspace(0.0, 1.0, s, dtype=torch.float32, device=device)
            view = [m, 1, 1, 1]
            view[ax + 1] = s
            axes.append(torch.sin(2 * math.pi * freqs[:, ax:ax + 1] * g
                                  + phase[:, ax:ax + 1]).reshape(view))
        out.addcmul_(axes[0] * axes[1] * amp.reshape(m, 1, 1, 1), axes[2])
    rms = torch.linalg.vector_norm(out, dim=(1, 2, 3), keepdim=True) / math.sqrt(out[0].numel())
    out.div_(rms)
    out.add_(torch.randn(out.shape, generator=gen, device=device), alpha=0.01)
    return out.reshape(shape)
