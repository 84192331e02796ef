"""HACC-like proxy: ``log1p`` of a lognormal of sigma 2, as the paper
log-transforms HACC (section 4.1); a torch copy of the ``particle`` kind of
the port's ``data/fields.py``."""
import torch


def make(shape, gen: torch.Generator, device) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.log_normal_(0.0, 2.0, generator=gen).log1p_()
