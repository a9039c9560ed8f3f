#!/usr/bin/env python3
"""Registers, shared memory and spills of the port's kernels, as ptxas
reports them for sm_90a.

    python3 tools/ptxas_report.py [--compare DIR] [file.cu ...]

Compiles each named source of `xclip_tpu_torch/csrc/` (default: the three
attention files) with the library's own nvcc flags plus `-Xptxas -v`, all
at once, and prints one line per kernel: its name (demangled where
`cu++filt` or `c++filt` is on the path), registers, spill stores and loads
in bytes, and static shared memory. With `--compare DIR` (a checkout of
another commit) it also compiles DIR's sources of the same names and
prints, per kernel of either, its registers and spills there and whether
its SASS (`cuobjdump -sass`, addresses dropped) is the same instruction
for instruction. Needs nvcc; builds nothing the library uses.
"""

import argparse
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


def compile_all(csrc, files, tmp):
    """{file: (ptxas output, object path)} of `files` of `csrc`, compiled
    at once."""
    Path(tmp).mkdir(parents=True, exist_ok=True)
    procs = [(f, Path(tmp) / f"{Path(f).stem}.o", subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(Path(tmp) / f"{Path(f).stem}.o"), str(Path(csrc) / f)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for f in files]
    out = {}
    for f, obj, p in procs:
        text = p.communicate()[0]
        if p.returncode:
            print(text)
            raise SystemExit(f"nvcc failed on {csrc}/{f} ({p.returncode})")
        out[f] = (text, obj)
    return out


def norm(name):
    """A mangled kernel name without its translation unit's hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "",
                  name)


def sass(obj):
    """{mangled kernel name: [instruction, ...]} of an object file, the
    translation unit's own hash taken out of the names."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = norm(m.group(1))
            funcs[name] = []
        elif name and (m := re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)):
            funcs[name].append(m.group(1))
    return funcs


def main(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("--compare", type=Path,
                        help="a checkout whose sources of the same names "
                        "are compared kernel by kernel")
    parser.add_argument("files", nargs="*", default=list(DEFAULT))
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        here = compile_all(_build.CSRC, args.files, Path(tmp) / "a")
        there = (compile_all(args.compare / "xclip_tpu_torch" / "csrc",
                             args.files, Path(tmp) / "b")
                 if args.compare else None)
        for f in args.files:
            rows = report(here[f][0])
            for (_, regs, st, ld, smem), name in zip(
                    rows, demangle([r[0] for r in rows])):
                print(f"{f}: {name}: {regs} registers, spill stores {st} B, "
                      f"spill loads {ld} B, static smem {smem} B")
            if there is None:
                continue
            other = {norm(r[0]): r for r in report(there[f][0])}
            a, b = sass(here[f][1]), sass(there[f][1])
            for mangled in sorted(set(a) | set(b)):
                name = demangle([mangled])[0]
                if mangled not in b:
                    print(f"{f}: {name}: new (not in {args.compare})")
                elif mangled not in a:
                    print(f"{f}: {name}: gone (only in {args.compare})")
                else:
                    o = other.get(mangled)
                    was = (f"{o[1]} registers, spills {o[2]} / {o[3]} B"
                           if o else "registers not read")
                    print(f"{f}: {name}: there {was}; SASS "
                          + ("identical" if a[mangled] == b[mangled] else
                             f"differs ({len(b[mangled])} -> "
                             f"{len(a[mangled])} instructions)"))


if __name__ == "__main__":
    main(sys.argv[1:])
