"""Which kernel functions of two trees' libraries differ in their machine
code (SASS).

    python3 probav_tpu_torch/tools/sass_diff.py PARENT_ROOT CHANGE_ROOT \\
        [--out DIR]

Builds each tree's kernel library (``probav_tpu_torch/ops/_build.build``
run in a process of its own per tree, both at once), disassembles both
with ``cuobjdump -sass`` and compares them function by function, with
instruction addresses, runs of white space (cuobjdump pads each
instruction to the longest of its file, so a kernel added to a file
re-pads all of it) and the per-file hash in the anonymous namespace's
mangled name taken out.  Prints one JSON line: the functions of each
library, how many are identical, the changed ones (with their instruction
counts, how many lines differ and the first differing pair), and those
found in only one; appended to ``DIR/sass_diff.jsonl`` with ``--out``.
Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from probav_tpu_torch.ops import _build; print(_build.build()[0])")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")


def functions(cuobjdump: str, lib: str) -> dict[str, list[str]]:
    """{function name: its SASS lines, addresses and padding removed} of
    a library."""
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    fs, name = {}, None
    for line in _ANON.sub("ANON", out).splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            fs[name] = []
        elif name is not None:
            fs[name].append(" ".join(_ADDR.sub("", line).split()))
    return fs


def difference(a: list[str], b: list[str]) -> dict:
    """How two versions of one function's SASS differ."""
    pairs = [(x, y) for x, y in zip(a, b) if x != y]
    return dict(instructions=[len(a), len(b)], lines_differing=len(pairs),
                first=list(pairs[0]) if pairs else None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out")
    opt = ap.parse_args(argv)
    roots = [os.path.abspath(opt.parent), os.path.abspath(opt.change)]
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, root],
                              cwd=root, stdout=subprocess.PIPE, text=True)
             for root in roots]
    libs = []
    for root, p in zip(roots, procs):
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"build of {root} failed ({p.returncode})")
        libs.append(out.strip().splitlines()[-1])
    sys.path.insert(0, roots[1])
    from probav_tpu_torch.ops import _build
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    a, b = (functions(cuobjdump, lib) for lib in libs)
    changed = sorted(k for k in a if k in b and a[k] != b[k])
    result = dict(
        parent=roots[0], change=roots[1], parent_functions=len(a),
        change_functions=len(b),
        identical=sum(1 for k in a if k in b and a[k] == b[k]),
        changed={k: difference(a[k], b[k]) for k in changed},
        only_in_parent=sorted(k for k in a if k not in b),
        only_in_change=sorted(k for k in b if k not in a))
    line = json.dumps(result)
    print(line, flush=True)
    if opt.out:
        os.makedirs(opt.out, exist_ok=True)
        with open(os.path.join(opt.out, "sass_diff.jsonl"), "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
