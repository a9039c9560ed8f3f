#!/usr/bin/env python3
"""Registers, shared memory and spills of the port's kernels, as ptxas
reports them for sm_90a.

    python3 tools/ptxas_report.py [file.cu ...]

Compiles each named source of `xclip_tpu_torch/csrc/` (default: the three
attention files) with the library's own nvcc flags plus `-Xptxas -v`, all
at once, and prints one line per kernel: its name (demangled where
`cu++filt` or `c++filt` is on the path), registers, spill stores and loads
in bytes, and static shared memory. Needs nvcc; builds nothing the library
uses.
"""

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from xclip_tpu_torch.kernels import _build  # noqa: E402

DEFAULT = ("attention_block.cu", "attention_megablock.cu",
           "flash_attention.cu")
ENTRY = re.compile(r"Compiling entry function '(\w+)'")
USED = re.compile(r"Used (\d+) registers")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
SMEM = re.compile(r"(\d+) bytes smem")


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def report(output):
    """[(mangled name, registers, spill stores, spill loads, smem)]."""
    rows, name, spill = [], None, (0, 0)
    for line in output.splitlines():
        if m := ENTRY.search(line):
            name, spill = m.group(1), (0, 0)
        elif name and (m := SPILL.search(line)):
            spill = (int(m.group(1)), int(m.group(2)))
        elif name and (m := USED.search(line)):
            smem = SMEM.search(line)
            rows.append((name, int(m.group(1)), *spill,
                         int(smem.group(1)) if smem else 0))
            name = None
    return rows


def main(files):
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(f, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / f"{Path(f).stem}.o"), str(_build.CSRC / f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for f in files]
        outputs = [(f, p.communicate()[0], p.returncode) for f, p in procs]
    for f, out, rc in outputs:
        if rc:
            print(out)
            raise SystemExit(f"nvcc failed on {f} ({rc})")
        rows = report(out)
        for (_, regs, st, ld, smem), name in zip(
                rows, demangle([r[0] for r in rows])):
            print(f"{f}: {name}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B, static smem {smem} B")


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
