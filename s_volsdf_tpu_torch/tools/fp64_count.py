"""Counts a built kernel's FP64-pipe instructions in its SASS.

    python3 -m s_volsdf_tpu_torch.tools.fp64_count [LIBRARY [KERNEL]]

Runs `cuobjdump -sass` (beside nvcc) on LIBRARY (default: this
checkout's `_build/libgeo_consistency.so`, built first) and counts, in
the function whose name holds KERNEL (default `geo_consistency_kernel`),
the instructions that issue to the FP64 units: DFMA, DMUL, DADD, DSETP,
DMNMX, the conversions to and from F64 (F2F, I2F, F2I), FRND on F64,
and MUFU.RCP64H / MUFU.RSQ64H. Each instruction of the kernel's own body
counts once, whichever branch a thread takes: the straight-line count
of one thread. The subroutines the body calls (the slow paths of an
IEEE division or square root, for operands near the range's ends) are
counted apart. Prints the counts by opcode.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import Counter
from typing import Dict

FP64_BASES = {"DFMA", "DMUL", "DADD", "DSETP", "DSET", "DMNMX"}
FP64_CONVERSIONS = {"F2F", "I2F", "F2I", "FRND"}
FP64_MUFU = {"MUFU.RCP64H", "MUFU.RSQ64H"}
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
_LABEL = re.compile(r"^\s*(\$[^\s:]+):\s*$")


def is_fp64(opcode: str) -> bool:
    parts = opcode.split(".")
    if parts[0] in FP64_BASES or opcode in FP64_MUFU:
        return True
    return parts[0] in FP64_CONVERSIONS and "F64" in parts[1:]


def count_sass(sass: str, kernel: str) -> Dict:
    """FP64-pipe instruction counts of the function named with `kernel`
    in cuobjdump's SASS listing: {"main": n, "subroutines": n,
    "by_opcode": {opcode: n}} (by_opcode for the main body)."""
    lines, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if inside:
            lines.append(line)
    if not lines:
        raise ValueError(f"no function named with {kernel!r} in the SASS")
    main, sub, in_sub = Counter(), 0, False
    for line in lines:
        if _LABEL.match(line):    # a called subroutine starts here
            in_sub = True
            continue
        m = INSTR.search(line)
        if m and is_fp64(m.group(1)):
            if in_sub:
                sub += 1
            else:
                main[m.group(1)] += 1
    return {"main": sum(main.values()), "subroutines": sub,
            "by_opcode": dict(sorted(main.items()))}


def cuobjdump() -> str:
    """cuobjdump beside nvcc."""
    from s_volsdf_tpu_torch.ops.build import nvcc
    path = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def fp64_instructions(library: str,
                      kernel: str = "geo_consistency_kernel") -> Dict:
    """`count_sass` of `kernel` in the built `library`."""
    res = subprocess.run([cuobjdump(), "-sass", library], capture_output=True,
                         text=True, check=True)
    return count_sass(res.stdout, kernel)


def main() -> None:
    if len(sys.argv) > 1:
        library = sys.argv[1]
    else:
        from s_volsdf_tpu_torch.ops import geo_consistency
        library = geo_consistency.build()
    kernel = sys.argv[2] if len(sys.argv) > 2 else "geo_consistency_kernel"
    print(fp64_instructions(library, kernel))


if __name__ == "__main__":
    main()
