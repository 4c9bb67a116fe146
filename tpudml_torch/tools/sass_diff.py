"""Which of the port's CUDA kernels compile to other machine code than in
another checkout.

Builds every ``tpudml_torch/csrc/*.cu`` of this checkout and of OTHER (for
example a parent commit unpacked with ``git archive``) with the port's
nvcc flags, disassembles both with ``cuobjdump -sass`` and pairs each of
OTHER's kernels with a kernel of this checkout whose instructions are the
same, up to the offsets of kernel parameters (constant bank 0 from 0x210,
where Hopper passes them) and the numbering of branch labels. A kernel
that only gained a template parameter changes its name but keeps its pair.
Prints one JSON line: per source, the number of pairs and, demangled, the
kernels of either side that have none.

Run where nvcc is (the card's machine), from the checkout's root:
``python -m tpudml_torch.tools.sass_diff OTHER``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

from tpudml_torch.ops.cuda_lib import BUILD_DIR, NVCC_FLAGS, PKG_DIR, find_nvcc

PARAM_BASE = 0x210  # first kernel-parameter byte in constant bank 0 on sm_90
_PARAM = re.compile(r"c\[0x0\]\[0x([0-9a-f]+)\]")
_LABEL = re.compile(r"\.L_x_\d+")
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _normalized(instrs: list[str]) -> tuple[str, ...]:
    labels: dict[str, str] = {}

    def param(m):
        return "c[0x0][param]" if int(m.group(1), 16) >= PARAM_BASE else m.group(0)

    def label(m):
        return labels.setdefault(m.group(0), f"L{len(labels)}")

    return tuple(_LABEL.sub(label, _PARAM.sub(param, i)) for i in instrs)


def parse_sass(sass: str) -> dict[str, tuple[str, ...]]:
    """{mangled kernel: its normalized instructions} of ``cuobjdump -sass``
    output."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if cur is not None and m:
            cur.append(m.group(1))
    return {name: _normalized(instrs) for name, instrs in out.items()}


def kernels(lib: Path) -> dict[str, tuple[str, ...]]:
    """{mangled kernel: its normalized instructions} of a built library."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    return parse_sass(subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                                     text=True, timeout=600, check=True).stdout)


def pair(here: dict, there: dict) -> tuple[int, list[str], list[str]]:
    """(pairs, kernels of ``there`` with no twin, kernels of ``here`` with
    none): each of ``there``'s kernels takes the first unpaired kernel of
    ``here`` with the same instructions."""
    unpaired = dict(here)
    only_there = []
    for name, code in there.items():
        twin = next((n for n, c in unpaired.items() if c == code), None)
        if twin is None:
            only_there.append(name)
        else:
            del unpaired[twin]
    return len(there) - len(only_there), only_there, sorted(unpaired)


def demangle(names: list[str]) -> list[str]:
    if not names:
        return []
    cufilt = Path(find_nvcc()).with_name("cu++filt")
    out = subprocess.run([str(cufilt)], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.splitlines()


def build(trees: dict[str, Path]) -> dict[str, dict[str, Path]]:
    """{tree: {source: library}}: every ``tpudml_torch/csrc/*.cu`` of each
    checkout built under ``_build/sass_diff/<tree>``, all nvcc at once."""
    procs = []
    for tree, root in trees.items():
        out_dir = BUILD_DIR / "sass_diff" / tree
        out_dir.mkdir(parents=True, exist_ok=True)
        for src in sorted((root / "tpudml_torch" / "csrc").glob("*.cu")):
            lib = out_dir / f"lib{src.stem}.so"
            procs.append((tree, src, lib, subprocess.Popen(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs: dict[str, dict[str, Path]] = {tree: {} for tree in trees}
    for tree, src, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        libs[tree][src.name] = lib
    return libs


def compare(other: Path) -> dict:
    libs = build({"here": PKG_DIR.parent, "other": other})
    result = {}
    for source in sorted(set(libs["here"]) | set(libs["other"])):
        here = kernels(libs["here"][source]) if source in libs["here"] else {}
        there = kernels(libs["other"][source]) if source in libs["other"] else {}
        paired, only_other, only_here = pair(here, there)
        result[source] = {"paired": paired, "only_other": demangle(only_other),
                          "only_here": demangle(only_here)}
    return result


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other", type=Path, help="root of the checkout to compare with")
    result = compare(p.parse_args(argv).other.resolve())
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
