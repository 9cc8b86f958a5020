"""Compare the machine code (SASS) of the port's kernels in two checkouts,
function by function: whether a change to a kernel source left some of
its instantiations compiling exactly as before.

Each named source under qwen3_tts_tpu_torch/csrc/ is compiled to a cubin
from this checkout and from ``--root DIR`` with the flags of
ops/kernels/_build.py, disassembled with cuobjdump, and each function's
instructions (addresses and encodings left out; the anonymous namespace's
per-file hash taken out of the names) compared. Prints one line per
function: EQUAL, DIFFER (with the count of lines that differ), or the
side it exists on. Needs nvcc and cuobjdump (the CUDA toolkit), no card.

    python qwen3_tts_tpu_torch/tools/compare_sass.py --root DIR \\
        [decode_attention.cu ...]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]          # this checkout
sys.path.insert(0, str(HERE))

from qwen3_tts_tpu_torch.ops.kernels import _build  # noqa: E402


def sass(src: Path, cubin: Path) -> dict:
    """{function name: [instruction, ...]} of one source, compiled to
    ``cubin``."""
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True)
    text = subprocess.run(
        [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N_", m.group(1))
            out[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
            if ins.strip():
                out[name].append(ins.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other checkout (e.g. a parent unpacked with "
                         "git archive)")
    ap.add_argument("sources", nargs="*", default=["decode_attention.cu"])
    args = ap.parse_args()
    other = Path(args.root).resolve()
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.sources:
            rel = Path("qwen3_tts_tpu_torch") / "csrc" / name
            a = sass(other / rel, Path(tmp) / "root.cubin")
            b = sass(HERE / rel, Path(tmp) / "here.cubin")
            for fn in sorted(set(a) | set(b)):
                x, y = a.get(fn), b.get(fn)
                if x is None or y is None:
                    side = "only here" if x is None else "only in --root"
                    print(f"{name} {side}: {fn} ({len(x or y)} instructions)")
                    continue
                diff = sum(i != j for i, j in zip(x, y)) + abs(len(x) - len(y))
                print(f"{name} {'EQUAL' if diff == 0 else 'DIFFER'} {fn}: "
                      f"{len(x)} -> {len(y)} instructions, {diff} lines differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
