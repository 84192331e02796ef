"""The port's carry and host-sync passes (``repro_torch.analysis.carry``,
``.jitlint``) and the four-pass report, on the CPU.

* carry: the K4, K5 and K6 row-pass bodies carry (the decoupled look-back),
  take their tile from the ticket and declare ``carry="lookback"``; every other
  launch neither carries nor declares. Seeded sources trip each rule: a body
  spinning on the look-back by ``blockIdx`` (``carry-without-ticket``), a
  wrapper handing ``torch.empty`` scratch or scratch it did not zero
  (``carry-scratch-not-zeroed``), a carry the spec leaves undeclared and a
  declared carry the body lacks.
* jitlint: seeded hot functions trip each host-sync kind and ``tensor-branch``;
  the same code outside a hot context is clean; the unused-import style rule.
* The real tree is clean against the baseline, no jitlint or carry entry of it
  is stale, every ``HOT`` entry names a function, and the syncs an H100
  reported (``chip_smoke.py`` phase 18c) map to listed functions.
"""
import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import carry, jitlint, report, space
from repro_torch.analysis.kernelspec import KernelSpec
from repro_torch.kernels import module

ROOT = Path(__file__).resolve().parents[1]
CARRYING = {"fused_compress", "fused_compress_strict", "fused_shuffle_encode",
            "fused_decompress.decode_scan_rows"}


def _rules(findings):
    return sorted((f.rule, f.severity) for f in findings)


def _site_specs():
    return {s.name: s for s in space.build_specs()}


# ---------------------------------------------------------------------------
# carry
# ---------------------------------------------------------------------------

def test_carrying_bodies_are_k4_k5_and_k6_rows():
    for name, spec in _site_specs().items():
        c = carry.classify(carry.load_unit(spec.module), spec.symbol)
        assert c["carries"] == (name in CARRYING), name
        assert (spec.carry == "lookback") == (name in CARRYING), name
        if c["carries"]:
            assert c["ticket"] and not c["block_idx"], name


def test_real_tree_has_no_carry_finding():
    assert carry.analyze(space.build_specs()) == []


def test_carrying_kernels_are_launched_by_their_entry_points():
    unit = carry.load_unit("fz_compress.cu")
    assert carry.launchers(unit, "encode_tiles") == {"fz_fused_compress",
                                                     "fz_fused_compress_strict"}
    assert carry.launchers(unit, "shuffle_encode_tiles") == {"fz_fused_shuffle_encode"}
    assert carry.launchers(carry.load_unit("fz_decompress.cu"),
                           "decode_scan_rows") == {"fz_fused_decompress"}


CU = textwrap.dedent('''\
    // seeded kernels over the real look-back of fz_common.cuh
    #include "fz_common.cuh"
    namespace fz {
    __global__ void by_block(unsigned long long* st, int* out, unsigned* ticket) {
      const int t = blockIdx.x;                    // not the ticket
      const unsigned base = scan_segment(st, t, 0, 1u);
      if (threadIdx.x == 0) out[t] = static_cast<int>(base);
    }
    __global__ void by_ticket(unsigned long long* st, int* out, unsigned* ticket) {
      const int t = static_cast<int>(take_ticket(ticket));
      const unsigned base = scan_segment(st, t, 0, 1u);
      if (threadIdx.x == 0) out[t] = static_cast<int>(base);
    }
    __global__ void spin(volatile int* flag, int* out) {
      const int t = blockIdx.x;
      while (t > 0 && flag[t - 1] == 0) {}         // a hand-rolled published flag
      out[t] = 1;
      flag[t] = 1;
    }
    __global__ void plain(int* out) { out[blockIdx.x] = 1; }
    }  // namespace fz
    extern "C" {
    int fz_seeded(int* out, unsigned long long* scratch, int n, void* stream) {
      unsigned* ticket = reinterpret_cast<unsigned*>(scratch + n);
      fz::by_ticket<<<n, 256, 0, static_cast<cudaStream_t>(stream)>>>(scratch, out, ticket);
      return static_cast<int>(cudaGetLastError());
    }
    }  // extern "C"
    ''')


def _seeded(symbol, carry_decl="lookback"):
    return KernelSpec(name=f"seeded.{symbol}", module="seeded.cu", symbol=symbol, grid=(8,),
                      threads=256, carry=carry_decl)


def _wrapper(alloc):
    return textwrap.dedent(f'''\
        import torch
        from . import build

        _CACHE = {{}}

        def seeded(out: torch.Tensor, n: int):
            lib = build.library("seeded.cu")
            {alloc}
            rc = lib.fz_seeded(out.data_ptr(), scratch.data_ptr(), n, None)
            return rc
        ''')


ZEROED = "scratch = torch.zeros(n + 1, dtype=torch.int64, device=out.device)"


@pytest.mark.parametrize("symbol, rules", [
    ("by_block", [("carry-without-ticket", "error")]),
    ("spin", [("carry-without-ticket", "error")]),
    ("by_ticket", []),
])
def test_seeded_ticket_rule(symbol, rules):
    got = carry.analyze_spec(_seeded(symbol), sources={"seeded.cu": CU},
                             wrapper=(_wrapper(ZEROED), "seeded.py"))
    assert _rules(got) == rules


@pytest.mark.parametrize("alloc, flagged", [
    ("scratch = torch.empty(n + 1, dtype=torch.int64, device=out.device)", True),
    ("scratch = out.new_empty(n + 1, dtype=torch.int64)", True),
    ("scratch = _CACHE.setdefault(n, torch.zeros(n + 1, dtype=torch.int64))", True),
    ("scratch = _CACHE[n]; scratch.zero_()", False),
    ("scratch = torch.empty(n + 1, dtype=torch.int64); scratch.fill_(0)", False),
    (ZEROED, False),
])
def test_seeded_scratch_rule(alloc, flagged):
    got = carry.analyze_spec(_seeded("by_ticket"), sources={"seeded.cu": CU},
                             wrapper=(_wrapper(alloc), "seeded.py"))
    assert _rules(got) == ([("carry-scratch-not-zeroed", "error")] if flagged else [])
    if flagged:
        call = 1 + _wrapper(alloc).splitlines().index(
            "    rc = lib.fz_seeded(out.data_ptr(), scratch.data_ptr(), n, None)")
        assert got[0].location == f"seeded.py:{call}" and "'scratch'" in got[0].message


def test_the_real_wrappers_zero_through_a_helper():
    """K4, strict K4 and K5 take their scratch from ``_outputs``
    (``torch.zeros``): followed into the helper, clean; the same helper
    allocating with ``torch.empty`` is flagged at both calls that launch
    ``encode_tiles``, from either site's spec."""
    fc = Path(module("fused_compress").__file__)
    src = fc.read_text()
    bad = src.replace("scratch = torch.zeros(lookbacks * n_tiles + 1",
                      "scratch = torch.empty(lookbacks * n_tiles + 1")
    assert bad != src
    for name in ("fused_compress", "fused_compress_strict"):
        spec = _site_specs()[name]
        assert carry.analyze_spec(spec, wrapper=(src, "fused_compress.py")) == []
        got = carry.analyze_spec(spec, wrapper=(bad, "fused_compress.py"))
        assert _rules(got) == [("carry-scratch-not-zeroed", "error")] * 2, name


def test_undeclared_and_unused_carries():
    specs = _site_specs()
    undeclared = dataclasses.replace(specs["fused_compress"], carry=None)
    assert _rules(carry.analyze_spec(undeclared)) == [("carry-undeclared", "error")]
    unused = dataclasses.replace(specs["flash_decode"], carry="lookback")
    assert _rules(carry.analyze_spec(unused)) == [("declared-carry-unused", "warn")]
    assert _rules(carry.analyze_spec(_seeded("plain", carry_decl=None),
                                     sources={"seeded.cu": CU})) == []


def test_function_parser_finds_globals_and_entries():
    fns = carry.cuda_functions(CU)
    assert {n for n, f in fns.items() if f.is_global} == {"by_block", "by_ticket", "spin",
                                                          "plain"}
    assert {n for n, f in fns.items() if f.is_c_entry} == {"fz_seeded"}
    assert fns["by_block"].line == 4


# ---------------------------------------------------------------------------
# jitlint
# ---------------------------------------------------------------------------

HOT_SRC = textwrap.dedent('''\
    import numpy as np
    import torch


    def helper(x: torch.Tensor) -> torch.Tensor:
        return x * 2


    def f(x: torch.Tensor, lengths, k: int):
        y = helper(x).sum()
        if y > 0:
            x = x + 1
        n = y.item()
        total = int(x.max())
        lens = torch.tensor(lengths, device=x.device)
        on_host = torch.tensor(lengths)
        idx = torch.nonzero(x)
        kept = x[x > 0]
        reps = x.repeat_interleave(lens)
        fine = x.repeat_interleave(k)
        while x.sum() < 10:
            x = x * 2
        moved = torch.from_numpy(np.zeros(3)).to(x.device)
        if x is None or x.shape[0] > 3:
            pass

        def inner(z: torch.Tensor):
            return z.tolist()
        return inner(x), n, total, lens, on_host, idx, kept, reps, fine, moved


    def cold(x: torch.Tensor):
        return x.item()
    ''')


def test_seeded_hot_function_flags_every_kind():
    got = jitlint.lint_source(HOT_SRC, "m.py", hot={"f"})
    keys = sorted(f.obj.split(":", 2)[2] + "/" + f.rule for f in got)
    assert keys == sorted([
        "if#1/tensor-branch", ".item()#1/host-sync", "int()#1/host-sync",
        "torch.tensor(device=)#1/host-sync", "nonzero()#1/host-sync",
        "mask-index#1/host-sync", "repeat_interleave()#1/host-sync",
        "while#1/tensor-branch", ".to(device)#1/host-sync", ".tolist()#1/host-sync",
    ])
    inner = [f for f in got if ".tolist()" in f.obj]
    assert inner[0].obj == "m.py:f.<locals>.inner:.tolist()#1"
    assert {f.location for f in got if f.rule == "tensor-branch"} == {"m.py:11", "m.py:21"}


def test_same_code_outside_a_hot_context_is_clean():
    assert jitlint.lint_source(HOT_SRC, "m.py", hot=set()) == []
    assert [f.obj for f in jitlint.lint_source(HOT_SRC, "m.py", hot={"cold"})] == \
        ["m.py:cold:.item()#1"]


def test_a_new_sync_adds_a_key():
    """Ordinals per function and kind: a second .item() is a new key, while an
    edit that only moves lines keeps every key."""
    src = "import torch\n\ndef f(x: torch.Tensor):\n    return x.item()\n"
    keys = {f.key for f in jitlint.lint_source(src, "m.py", hot={"f"})}
    moved = {f.key for f in jitlint.lint_source("\n\n" + src, "m.py", hot={"f"})}
    more = {f.key for f in jitlint.lint_source(
        src.replace("return x.item()", "a = x.item()\n    return a + x.item()"), "m.py",
        hot={"f"})}
    assert keys == moved and keys < more and len(more) == 2


def test_unused_import_style_rule():
    src = "import os\nimport sys  # noqa: F401\nfrom pathlib import Path\n\nprint(Path)\n"
    got = jitlint.lint_source(src, "m.py", style=True, discipline=False)
    assert [(f.rule, f.obj) for f in got] == [("unused-import", "m.py:1:os")]


def test_every_hot_entry_names_a_function():
    assert jitlint.missing_hot() == []
    assert not [f for f in jitlint.analyze(style=False) if f.rule == "unknown-hot-context"]


# the innermost repro_torch function of every sync the card reported in the
# Yi-6B serving trace and in fused compress / decompress (chip_smoke.py phase
# 18c, NVIDIA H100 80GB HBM3)
RUNTIME_SYNCS = {
    ("repro_torch/models/attention.py", "rope_freqs"),
    ("repro_torch/core/fz.py", "FZCompressed.used_bytes"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._tensor"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._step"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._start_running"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._lane_pages"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._sentinel_check"),
    ("repro_torch/core/quant.py", "dual_quantize"),
}


def test_runtime_syncs_map_to_static_findings():
    findings = jitlint.analyze(style=False)
    assert RUNTIME_SYNCS <= jitlint.sync_sites(findings, baseline={})
    assert RUNTIME_SYNCS <= jitlint.sync_sites()


# ---------------------------------------------------------------------------
# the four passes on the tree
# ---------------------------------------------------------------------------

def test_tree_clean_against_the_baseline_and_nothing_stale():
    rep = report.run_all(ptxas=None)
    assert rep.clean, rep.render_text()
    # the resource entry (K1's walk at 512^3) needs the card's ptxas figures
    assert [k for k in rep.stale if not k.startswith("resources:")] == []
    reasons = report.load_baseline()
    assert all(len(reasons[f.key]) > 40 for f in rep.findings if f.pass_name == "jitlint")
    assert {f.pass_name for f in rep.findings} >= {"jitlint"}


@pytest.mark.parametrize("passes", ["carry,jitlint,style", "style"])
def test_cli_passes_subset(passes, tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--passes", passes,
                          "--check", "--json", "-"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert {f["pass_name"] for f in doc["findings"]} <= set(passes.split(","))
    assert doc["stale_baseline"] == [] and doc["resources"] == []
    bad = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--passes", "nope"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert bad.returncode == 2 and "unknown pass" in bad.stderr
