"""Compare the SASS of every kernel of a CUDA source between two checkouts.

    python tools/sass_diff.py OLD_ROOT NEW_ROOT [SOURCE ...] [--out DIR]

Each ``src/repro_torch/csrc/<SOURCE>`` (default: fz_compress.cu and
fz_staged.cu) of both checkouts is compiled to an sm_90a cubin with the
flags of ``kernels/build.py`` (``-cubin`` in place of ``-shared``) and
disassembled with ``cuobjdump -sass``. Kernels are matched by mangled name
and compared instruction for instruction, whitespace aside (the listing's
column width follows the longest name in the file). One line a kernel:
identical, differing (with the count of lines), or present on one side only.
Needs nvcc and cuobjdump (the CUDA toolkit); no card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import build  # noqa: E402

FLAGS = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")] + ["-cubin"]


def kernels(root: Path, source: str, out: Path, tag: str) -> dict[str, list[str]]:
    """mangled name -> its SASS lines, whitespace collapsed."""
    cubin = out / f"{tag}_{source}.cubin"
    subprocess.run([build.nvcc(), *FLAGS, "-o", str(cubin),
                    str(root / "src" / "repro_torch" / "csrc" / source)], check=True)
    text = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    (out / f"{tag}_{source}.sass").write_text(text)
    funcs: dict[str, list[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and line.strip():
            funcs[name].append(" ".join(line.split()))
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("sources", nargs="*", default=["fz_compress.cu", "fz_staged.cu"])
    ap.add_argument("--out", type=Path, default=None, help="keep cubins and listings here")
    args = ap.parse_args(argv)
    out = args.out or Path(tempfile.mkdtemp())
    out.mkdir(parents=True, exist_ok=True)
    for source in args.sources:
        old = kernels(args.old, source, out, "old")
        new = kernels(args.new, source, out, "new")
        for name in sorted(old.keys() | new.keys()):
            if name not in new or name not in old:
                side = "old" if name in old else "new"
                print(f"{source} {name}: only in {side} ({len((old | new)[name])} lines)")
                continue
            diff = sum(a != b for a, b in zip(old[name], new[name]))
            diff += abs(len(old[name]) - len(new[name]))
            print(f"{source} {name}: " + ("identical" if diff == 0 else f"{diff} lines differ")
                  + f" ({len(old[name])} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
