"""The port's resource pass (``repro_torch.analysis``) on the CPU.

* Seeded specs trip each rule of the Hopper model: ``smem-overflow``,
  ``reg-overflow``, ``spill`` and ``occupancy-below-bounds``; a spec within
  the limits is clean, and without ptxas figures the register checks report
  "not measured".
* The ptxas-log parser on a literal sample of ``nvcc -Xptxas -v`` output, and
  the mangled names mapped to their ``__global__`` symbols.
* Every ``__global__`` of ``csrc/`` has a registered spec builder, and every
  spec's C query is bound in ``kernels/build.py``; a spec's dynamic shared
  bytes (and K1's choice of launch) are the C query's answer, "not measured"
  without a card.
* The plan helpers the wrappers launch by: K6's column passes, K7's splits.
* The CPU tree is clean modulo the port's baseline, and the CLI
  (``--json``, ``--check``).
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis import report, resources, space
from repro_torch.analysis.kernelspec import KernelSpec, spec_builders
from repro_torch.kernels import build, module

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
fc, lq = module("fused_compress"), module("lorenzo_quant")
fdec, fdk = module("fused_decode"), module("flash_decode")

SAMPLE_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2fz12encode_tilesINS_11WindowCodesILb1ELi3EEEEEvT_PjPtxPiPyS5_i' for 'sm_90a'
ptxas info    : Function properties for _ZN2fz12encode_tilesINS_11WindowCodesILb1ELi3EEEEEvT_PjPtxPiPyS5_i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers, 80 bytes smem, 592 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2fz12encode_tilesINS_11WindowCodesILb0ELi1EEEEEvT_PjPtxPiPyS5_i' for 'sm_90a'
ptxas info    : Function properties for _ZN2fz12encode_tilesINS_11WindowCodesILb0ELi1EEEEEvT_PjPtxPiPyS5_i
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 44 registers, used 1 barriers, 80 bytes smem, 592 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2fz12scan_columnsILb1EEEvPjixxiPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN2fz12scan_columnsILb1EEEvPjixxiPKf
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 78 registers, 1024 bytes smem, 392 bytes cmem[0]
ptxas info    : Function properties for _ZN2fz8quantizeEff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN2fz21bitshuffle_flag_tilesEPKtPtPh' for 'sm_90a'
ptxas info    : Function properties for _ZN2fz21bitshuffle_flag_tilesEPKtPtPh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, 8192 bytes smem, 376 bytes cmem[0]
"""


def _spec(**kw):
    base = dict(name="seeded", module="fz_compress.cu", symbol="encode_tiles", grid=(8,),
                threads=256, point="seeded point")
    return KernelSpec(**(base | kw))


def _ptxas(registers=32, static_smem=0, spill_stores=0, module="fz_compress.cu",
           symbol="encode_tiles"):
    return {(module, symbol): {"registers": registers, "static_smem": static_smem,
                               "spill_stores": spill_stores, "spill_loads": spill_stores,
                               "instances": 1}}


def _rules(findings):
    return sorted((f.rule, f.severity) for f in findings)


def test_seeded_smem_overflow_flagged():
    assert _rules(resources.analyze_spec(_spec(dynamic_smem=300 * 1024))) == [
        ("smem-overflow", "error")]
    # the static bytes count too, where ptxas reports them
    spec = _spec(dynamic_smem=resources.MAX_SMEM_CTA - 1000)
    assert resources.analyze_spec(spec) == []
    assert _rules(resources.analyze_spec(spec, _ptxas(static_smem=2048))) == [
        ("smem-overflow", "error")]


def test_seeded_reg_overflow_flagged():
    found = resources.analyze_spec(_spec(threads=1024), _ptxas(registers=255))
    assert ("reg-overflow", "error") in _rules(found)
    assert resources.analyze_spec(_spec(threads=256), _ptxas(registers=255)) == []


def test_seeded_spill_flagged():
    assert _rules(resources.analyze_spec(_spec(), _ptxas(spill_stores=24))) == [
        ("spill", "warn")]


def test_seeded_occupancy_below_bounds_flagged():
    # 100 KB a CTA: 2 fit an SM, the bounds ask for 4
    found = resources.analyze_spec(_spec(dynamic_smem=100_000, min_ctas=4))
    assert _rules(found) == [("occupancy-below-bounds", "warn")]
    assert "not measured" in found[0].message
    # registers limit too: 128 a thread x 256 threads -> 2 CTAs
    found = resources.analyze_spec(_spec(min_ctas=3), _ptxas(registers=128))
    assert _rules(found) == [("occupancy-below-bounds", "warn")]
    assert resources.occupancy(_spec(), _ptxas(registers=128)[("fz_compress.cu",
                                                               "encode_tiles")]) == (
        2, "registers")


def test_within_limits_spec_is_clean():
    spec = _spec(dynamic_smem=39_104, min_ctas=5)
    assert resources.analyze_spec(spec) == []
    assert resources.analyze_spec(spec, _ptxas(registers=48, static_smem=80)) == []
    assert resources.occupancy(spec, None) == (5, "shared memory")


def test_register_checks_not_measured_without_ptxas():
    rows = resources.table([_spec(dynamic_smem=None)], _ptxas(registers=64, static_smem=80))
    assert rows[0]["dynamic_smem"] == "not measured" and rows[0]["ctas_per_sm"] == "<= 4"
    assert resources.analyze_spec(_spec(dynamic_smem=None, min_ctas=4)) == []
    assert _rules(resources.analyze_spec(_spec(dynamic_smem=None),
                                         _ptxas(static_smem=resources.MAX_SMEM_CTA + 1))) == [
        ("smem-overflow", "error")]
    rows = resources.table([_spec(dynamic_smem=1024)], None)
    assert rows[0]["registers"] == rows[0]["static_smem"] == rows[0]["spill_stores"] == \
        "not measured"
    assert rows[0]["ctas_per_sm"] == "<= 8"
    rows = resources.table([_spec(dynamic_smem=1024)], _ptxas(registers=64, static_smem=80))
    assert rows[0]["registers"] == 64 and rows[0]["ctas_per_sm"] == 4


def test_ptxas_parser_on_a_sample_log():
    figs = resources.parse_ptxas(SAMPLE_LOG)
    assert len(figs) == 4
    assert figs["_ZN2fz12scan_columnsILb1EEEvPjixxiPKf"] == {
        "registers": 78, "static_smem": 1024, "spill_stores": 12, "spill_loads": 12}
    assert {resources.symbol_of(m) for m in figs} == {
        "encode_tiles", "scan_columns", "bitshuffle_flag_tiles"}
    assert resources.symbol_of("fz_error_string") == "fz_error_string"


def test_ptxas_info_takes_the_worst_instance(monkeypatch):
    monkeypatch.setattr(build, "ptxas_log",
                        lambda source: SAMPLE_LOG if source == "fz_compress.cu" else None)
    info = resources.ptxas_info()
    assert info[("fz_compress.cu", "encode_tiles")] == {
        "registers": 48, "static_smem": 80, "spill_stores": 0, "spill_loads": 0,
        "instances": 2}
    monkeypatch.setattr(build, "ptxas_log", lambda source: None)
    assert resources.ptxas_info() is None


def _globals():
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    out = set()
    for path in CSRC.glob("*.cu"):
        out |= {(path.name, m) for m in pat.findall(path.read_text())}
    return out


def test_every_kernel_site_registers_a_spec():
    specs = space.build_specs()
    declared = {(s.module, s.symbol) for s in specs}
    assert _globals() == declared
    assert {s.name for s in specs} == set(spec_builders())


def test_every_c_query_is_bound():
    for spec in space.build_specs():
        if spec.c_query is None:
            assert spec.dynamic_smem == 0, spec.name
            continue
        source, fn, args = spec.c_query
        assert source == spec.module
        assert len(build.SIGNATURES[source][fn]) == len(args), fn
        assert build._RESTYPES[fn] is build._L, fn
        assert fn in (CSRC / source).read_text()


class _Lib:
    """Stand-in C queries: what a built library would answer."""
    def fz_fused_compress_smem(self, is_bf16, ndim, d0, d1, d2, mis):
        return 1000 + 10 * ndim + is_bf16

    def fz_fused_compress_strict_smem(self, is_bf16, ndim, d0, d1, d2, mis):
        return max(24576, self.fz_fused_compress_smem(is_bf16, ndim, d0, d1, d2, mis))

    def fz_lorenzo_quant_smem(self, is_bf16, ndim, d0, d1, d2, mis):
        return 2000 + ndim

    def fz_lorenzo_quant_walks(self, is_bf16, ndim, d0, d1, d2, mis):
        return int(ndim == 3)

    def fz_scan_columns_smem(self, length):
        return 4 * length

    def fz_flash_decode_smem(self, is_bf16, d):
        return 3000 + d

    def fz_flash_decode_combine_smem(self, splits):
        return 4 * splits


def test_specs_take_the_c_sides_bytes(monkeypatch):
    """On the card each spec's dynamic shared bytes, and K1's launch, are the C
    query's answer; without one they are not measured and K1 lists both of
    its launch sites."""
    assert build.query("fz_compress.cu", "fz_fused_compress_smem", (0, 1, 5000, 1, 1, 0)) \
        is None
    assert fc.fused_compress_spec((5000,)).dynamic_smem is None
    assert [s.name for s in lq.specs((100, 500, 500))] == ["lorenzo_quant.walk",
                                                            "lorenzo_quant.tiles"]
    lib = _Lib()
    monkeypatch.setattr(build, "query", lambda source, fn, args: getattr(lib, fn)(*args))
    assert fc.fused_compress_spec((100, 500, 500), "bfloat16").dynamic_smem == 1031
    assert fc.fused_compress_strict_spec((100, 500, 500), "bfloat16").dynamic_smem \
        == 24576
    assert [(s.name, s.dynamic_smem) for s in lq.specs((100, 500, 500))] == [
        ("lorenzo_quant.walk", 2003)]
    assert [(s.name, s.dynamic_smem) for s in lq.specs((5000,))] == [
        ("lorenzo_quant.tiles", 2001)]
    assert [s.dynamic_smem for s in fdec.specs((100, 500, 500))] == [0, 2000, 400]
    assert [s.dynamic_smem for s in fdk.specs(4, 13, 4, 8, 128, "bfloat16")] == [3128, 52]
    specs = space.build_specs()
    assert all(s.dynamic_smem is not None for s in specs)
    assert resources.analyze(specs) == []


@pytest.mark.parametrize("shape,dtype", space.FZ_SHAPES)
def test_every_fz_point_resolves_through_the_c_side(monkeypatch, shape, dtype):
    """At each FZ point of the space, with a library to ask: one K1 site (the
    one the C side picks), every launch site of both routes and the bound's
    range pass, and bytes on every spec -- and without one, the
    data-dependent bytes not measured."""
    unmeasured = [s.name for s in space.fz_specs(shape, dtype) if s.dynamic_smem is None]
    assert unmeasured and all(s.c_query for s in space.fz_specs(shape, dtype)
                              if s.dynamic_smem is None)
    lib = _Lib()
    monkeypatch.setattr(build, "query", lambda source, fn, args: getattr(lib, fn)(*args))
    specs = space.fz_specs(shape, dtype)
    k1 = "lorenzo_quant.walk" if len(shape) == 3 else "lorenzo_quant.tiles"
    names = [s.name for s in specs]
    assert names[:5] == [k1, "bitshuffle_flag", "bitunshuffle_tiles", "fused_compress",
                         "fused_shuffle_encode"]
    assert names[5:7] == ["fused_decompress.bin_residuals",
                          "fused_decompress.decode_scan_rows"]
    assert names[-2:] == ["fused_compress_strict", "range_eb"]
    assert len(names) == 9 + len(fdec.column_passes(shape))
    assert all(isinstance(s.dynamic_smem, int) for s in specs)
    assert specs[3].c_query == ("fz_compress.cu", "fz_fused_compress_smem",
                                (int(dtype == "bfloat16"), len(shape), *fc.dims3(shape), 0))


def test_k6_column_passes():
    assert fdec.column_passes((5000,)) == []
    assert fdec.column_passes((100, 500, 500)) == [(500, 500, 100), (100, 250000, 1)]
    assert fdec.column_passes((4100, 1)) == []
    assert fdec.column_passes((5, 1, 7)) == [(5, 7, 1)]
    names = [s.name for s in fdec.specs((100, 500, 500), n_out=3)]
    assert names == ["fused_decompress.bin_residuals", "fused_decompress.decode_scan_rows",
                     "fused_decompress.scan_columns", "fused_decompress.scan_columns"]


def test_k7_specs_follow_split_count():
    specs = fdk.specs(4, 13, 4, 8, 128, "bfloat16")           # the Yi-6B page set
    assert specs[0].grid == (13, 4, 4) and specs[1].grid == (8, 4, 4)
    assert specs[0].c_query == ("flash_decode.cu", "fz_flash_decode_smem", (1, 128))
    assert specs[1].c_query == ("flash_decode.cu", "fz_flash_decode_combine_smem", (13,))
    assert [s.name for s in fdk.specs(64, 2, 8, 2, 64)] == ["flash_decode"]   # one split


def test_space_covers_the_shipped_shapes():
    shapes = {s for s, _ in space.FZ_SHAPES}
    assert {(100, 500, 500), (512, 512, 512), (1 << 26,), (2097152,)} <= shapes
    points = {s.point for s in space.attention_specs()}
    assert any("yi-6b paged ps=64 bfloat16" == p for p in points)
    assert all(ps in {8, 16, 64, 128} for ps in space.PAGE_SIZES)


def test_cpu_tree_clean_modulo_baseline():
    rep = report.run_all(ptxas=None)
    assert rep.clean, rep.render_text()
    # the resource pass's findings are warnings; the host-sync pass's baselined
    # syncs (tests/test_torch_analysis_passes.py) are errors by rule
    assert all(f.severity == "warn" for f in rep.findings if f.pass_name == "resources")
    assert rep.rows and all(r["registers"] == "not measured" for r in rep.rows)
    assert all(r["dynamic_smem"] == "not measured" for r in rep.rows
               if r["name"] not in ("bitshuffle_flag", "bitunshuffle_tiles",
                                    "fused_shuffle_encode", "fused_decompress.bin_residuals",
                                    "fused_decompress.decode_scan_rows", "range_eb"))


def test_merge_findings_folds_points():
    f = report.Finding("resources", "spill", "k", "msg", severity="warn")
    merged = report.merge_findings([f, f, f])
    assert len(merged) == 1 and "[3 config points]" in merged[0].message


def test_cli_json_and_check(tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--json", "-"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["clean"] and doc["resources"] and doc["counts"]["new"] == 0
    chk = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--check"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert chk.returncode == 0, chk.stdout + chk.stderr
    empty = tmp_path / "empty.json"
    empty.write_text('{"accepted": []}\n')
    rc = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--check",
                         "--baseline", str(empty)],
                        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert (rc.returncode == 1) == bool(doc["findings"])
