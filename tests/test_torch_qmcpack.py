"""QMCPACK's einspline table (``fzbench/configs/qmcpack-288.json``) on the
port's normal path, on the CPU at two orbitals, (230, 69, 69): ``fz.compress``
and ``fz.decompress`` in the benchmark's paper mode against the benchmark's
frozen plain reference (``fzbench/reference``), with its three counts each 0;
the ``orbital`` proxy; and K6's column passes at the published shape."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:          # the benchmark's package, beside src/
    sys.path.insert(0, str(ROOT))

from fzbench import fields  # noqa: E402
from fzbench.reference import check  # noqa: E402
from repro_torch.core import fz  # noqa: E402
from repro_torch.kernels import fused_decode  # noqa: E402

SHAPE = (230, 69, 69)
SEED = 2**31 + 33


def _orbital(shape=SHAPE, seed=SEED, index=0):
    return fields.make_field("orbital", shape, "float32", seed, "qmcpack-288", index, "cpu")


def test_config_is_the_published_shape_folded():
    cfg = json.loads((ROOT / "fzbench/configs/qmcpack-288.json").read_text())
    assert cfg["shape"] == [288 * 115, 69, 69] and cfg["reduced"] == []
    assert cfg["proxy"] == "orbital" and cfg["fields"] == ["einspline"]


def test_orbital_proxy_is_seeded_normalised_orbitals_that_jump():
    x = _orbital()
    assert x.dtype == torch.float32 and tuple(x.shape) == SHAPE and x.is_contiguous()
    assert torch.equal(x.view(torch.int32), _orbital().view(torch.int32))
    assert not torch.equal(x, _orbital(seed=SEED + 1))
    assert not torch.equal(x, _orbital(index=1))
    for bad in ((229, 69, 69), (100, 69, 69), (115 * 69, 69)):
        with pytest.raises(ValueError, match="115"):
            _orbital(bad)
    # each orbital normalised to unit RMS (and 0.01 noise on top)
    rms = x.reshape(2, -1).square().mean(dim=1).sqrt()
    assert torch.allclose(rms, torch.ones(2), atol=1e-3)
    # smooth inside an orbital (the noise and the harmonics' slope), a jump between
    step = (x[1:] - x[:-1]).abs().mean(dim=(1, 2))
    inside = torch.cat([step[:114], step[115:]])
    assert float(step[114]) > 5 * float(inside.max())


def test_fz_round_trip_equals_the_frozen_reference():
    mix = json.loads((ROOT / "fzbench/traffic/decompress-paper.json").read_text())["fz"]
    cfg = fz.FZConfig(**mix)
    assert (cfg.eb, cfg.eb_mode, cfg.exact_outliers) == (1e-3, "rel", False)
    x = _orbital()
    c = fz.compress(x, cfg, device="cpu")
    y = fz.decompress(c, cfg, device="cpu")
    totals = check.judge("decompress", [x], [[y]], [c], mix)
    assert totals == {"container_mismatch": 0, "recon_mismatch": 0, "bound_violations": 0}
    assert x.numel() * 4 / c.used_bytes() > 4       # smooth orbitals: 7.6-7.7x on seeds 1-3


def test_k6_column_passes_at_the_published_shape():
    """After the row pass over 69-element rows: the axis-1 pass, 33,120 outer
    slabs of 69 x 69 (three strips of 32 columns, the last with 5 live), then
    the axis-0 pass of 33,120 rows over 4,761 columns (149 strips)."""
    assert fused_decode.column_passes((33120, 69, 69)) == [(69, 69, 33120), (33120, 4761, 1)]
    assert fused_decode.column_passes(SHAPE) == [(69, 69, 230), (230, 4761, 1)]
    assert fused_decode.column_passes((1000, 5, 69)) == [(5, 69, 1000), (1000, 345, 1)]
    strips = [outer * -(-inner // 32) for _, inner, outer in
              fused_decode.column_passes((33120, 69, 69))]
    assert strips == [99360, 149]
