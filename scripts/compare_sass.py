#!/usr/bin/env python3
"""Compare the machine code (SASS) of the kernels two builds of the port's
kernel library share.

Each kernel function of the OLD library is matched by its demangled name,
template arguments included, to the NEW library's, with trailing template
flags of value ``false`` dropped from both names first: an old
``paged_chunk_kernel<64, __nv_bfloat16>`` matches the new
``paged_chunk_kernel<64, __nv_bfloat16, false>``, and the other way round.
The two instruction streams are compared with addresses and encodings
stripped and, with ``--any-param-offsets``, constant-bank operands
(``c[0x0][...]``, the kernel parameters) masked, so a kernel whose
parameter list grew but whose instructions did not counts as unchanged.

Run on a machine with the CUDA toolkit (``cuobjdump``, ``cu++filt``), from
the repository root:

    python3 scripts/compare_sass.py OLD.so NEW.so flash_packed_kernel \\
        flash_fwd_kernel paged_chunk_kernel --any-param-offsets

Prints one JSON line per compared kernel whose name contains one of the
given substrings (every kernel when none is given), and a summary line;
exits 1 when one of them differs or has no counterpart. Kernels whose name
contains a ``--changed=SUBSTR`` substring are the ones a change redesigned:
they are listed (with the instances only the new library has) and may
differ, so one call shows that only those changed:

    python3 scripts/compare_sass.py OLD.so NEW.so --changed=paged_decode_kernel \\
        --changed=paged_splitk_kernel
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from typing import Dict, List


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not shutil.which(path):
        raise SystemExit(f"{name} not found: the CUDA toolkit is needed")
    return path


def sass_by_function(lib: str) -> Dict[str, List[str]]:
    """Demangled kernel name (parameter list dropped) -> its instructions."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs: Dict[str, List[str]] = {}
    name = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
            if ins:
                funcs[name].append(ins.group(1))
    mangled = list(funcs)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(mangled),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    out = {}
    for m, d in zip(mangled, demangled):
        out[kernel_key(d)] = funcs[m]
    return out


def kernel_key(demangled: str) -> str:
    """``void ns::name<(int)64, T, false>(params)`` -> ``ns::name<(int)64, T>``:
    the name with its template arguments (trailing ``false`` or
    ``(bool)0`` flags dropped), without the return type and parameter
    list."""
    name = demangled.split(" ", 1)[1] if demangled.startswith("void ") else demangled
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                return re.sub(r"(, (false|\(bool\)0))+>$", ">", name[:i + 1])
        elif ch == "(" and depth == 0:
            return name[:i]
    return name


def main(argv: List[str]) -> int:
    mask_params = "--any-param-offsets" in argv
    changed = [a.split("=", 1)[1] for a in argv if a.startswith("--changed=")]
    args = [a for a in argv if not a.startswith("--")]
    old_lib, new_lib, wanted = args[0], args[1], args[2:] or [""]
    old, new = sass_by_function(old_lib), sass_by_function(new_lib)
    redesigned = lambda key: any(c in key for c in changed)

    def norm(lines):
        if not mask_params:
            return lines
        return [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][*]", x) for x in lines]

    bad = 0
    compared = 0
    for key in sorted(old):
        if not any(w in key for w in wanted):
            continue
        if redesigned(key):
            print(json.dumps({"kernel": key, "status": "redesigned",
                              "in_new": key in new}))
            continue
        compared += 1
        if key not in new:
            print(json.dumps({"kernel": key, "status": "missing in new"}))
            bad += 1
            continue
        same = norm(old[key]) == norm(new[key])
        bad += not same
        print(json.dumps({"kernel": key, "instructions_old": len(old[key]),
                          "instructions_new": len(new[key]), "identical": same}))
    for key in sorted(set(new) - set(old)):
        if any(w in key for w in wanted):
            print(json.dumps({"kernel": key, "status": "new only",
                              "redesigned": redesigned(key)}))
            bad += not redesigned(key)
    print(json.dumps({"compared": compared, "differ_or_missing": bad,
                      "param_offsets_masked": mask_params, "redesigned": changed}))
    return 1 if bad or not compared else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
