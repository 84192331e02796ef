"""``fzbench/fields.py``: the same (seed, configuration, field) gives the
same bytes, another seed other bytes, and the statistics that set the ratio
are those of the port's ``data/fields.py``."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from fzbench import fields
from repro_torch.data import fields as port_fields

KEY = "nyx-512"
SEED = 2**31 + 77


def _make(kind, shape, seed=SEED, key=KEY, index=0):
    return fields.make_field(kind, shape, "float32", seed, key, index, "cpu")


@pytest.mark.parametrize("kind,shape", [("turbulent", (16, 12, 10)), ("particle", (5000,))])
def test_same_seed_and_field_give_the_same_bytes(kind, shape):
    a = _make(kind, shape, index=3)
    b = _make(kind, shape, index=3)
    assert a.dtype == torch.float32 and a.shape == shape and a.is_contiguous()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(a, _make(kind, shape, index=4))
    assert not torch.equal(a, _make(kind, shape, key="hacc-280m", index=3))
    assert not torch.equal(a, _make(kind, shape, seed=SEED + 1, index=3))


def test_field_seeds_are_distinct():
    seeds = {fields.field_seed(s, k, i) for s in (1, 2**33 + 1) for k in ("nyx-512", "hacc-280m")
             for i in range(6)}
    assert len(seeds) == 24 and all(0 <= s < 2**63 for s in seeds)


def test_proxies_are_found_by_name_and_other_dtypes_are_refused(tmp_path):
    assert {p.stem for p in fields.PROXIES.glob("*.py")} >= {"turbulent", "particle"}
    (tmp_path / "ramp.py").write_text(
        "import torch\n\ndef make(shape, gen, device):\n"
        "    return torch.arange(shape[0], dtype=torch.float32, device=device)\n")
    x = fields.make_field("ramp", (7,), "float32", 1, "k", 0, "cpu", tmp_path)
    assert x.tolist() == list(range(7))
    with pytest.raises(ValueError, match="unknown proxy kind"):
        fields.make_field("nothing", (7,), "float32", 1, "k", 0, "cpu", tmp_path)
    with pytest.raises(ValueError, match="bfloat16"):
        fields.make_field("particle", (7,), "bfloat16", 1, "k", 0, "cpu")


def _spectrum_slope(x: np.ndarray) -> float:
    """Least-squares slope of log power against log |k|, shell-averaged, 4 <= |k| <= 16."""
    p = np.abs(np.fft.fftn(x)) ** 2
    ks = np.meshgrid(*[np.fft.fftfreq(s) * s for s in x.shape], indexing="ij")
    k = np.sqrt(sum(g ** 2 for g in ks))
    shells = np.arange(4, 17)
    power = [p[(k >= s - 0.5) & (k < s + 0.5)].mean() for s in shells]
    return float(np.polyfit(np.log(shells), np.log(power), 1)[0])


def test_turbulent_keeps_the_spectrum_slope():
    shape = (64, 64, 64)      # four fields a side: one slope's estimate varies by about 0.05
    ours = [_spectrum_slope(_make("turbulent", shape, index=i).numpy()) for i in range(4)]
    theirs = [_spectrum_slope(port_fields.make_field("turbulent", shape, s)) for s in range(4)]
    # power of a mode falls as (1 + k^2)^(-11/6): a slope near -11/3 at these k
    assert abs(np.mean(ours) - np.mean(theirs)) < 0.1
    assert -11 / 3 - 0.2 < np.mean(ours) < -11 / 3 + 0.3


def test_particle_keeps_the_lognormal_sigma():
    ours = _make("particle", (400_000,)).double()
    theirs = torch.from_numpy(port_fields.make_field("particle", (400_000,), 5)).double()
    for x in (ours, theirs):
        logs = torch.log(torch.expm1(x))     # the lognormal's own log: N(0, 2)
        assert math.isclose(float(logs.std()), 2.0, abs_tol=0.02)
        assert abs(float(logs.mean())) < 0.02
    assert math.isclose(float(ours.mean()), float(theirs.mean()), rel_tol=0.01)
