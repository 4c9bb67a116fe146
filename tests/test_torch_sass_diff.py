"""The SASS comparison of two checkouts' kernels, on canned ``cuobjdump``
output (building and disassembling needs nvcc, which the card's machine
has): parameter offsets and branch-label numbers do not make two kernels
differ, any other operand does."""

from tpudml_torch.tools.sass_diff import pair, parse_sass


def _listing(name: str, body: list[str]) -> str:
    lines = [f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, ins in enumerate(body):
        lines.append(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"                /* 0x{i:016x} */")
        lines.append(f"                                                   /* 0x{i:016x} */")
    return "\n".join(lines)


def _kernel(param: int, label: int, reg: str = "R2") -> list[str]:
    return ["LDC R1, c[0x0][0x28]", f"LDC {reg}, c[0x0][0x{param:x}]",
            f"@P0 BRA `(.L_x_{label})", "EXIT"]


def test_parse_sass_keeps_instructions_per_kernel():
    got = parse_sass(_listing("_Z1aPf", _kernel(0x210, 3)) + "\n"
                     + _listing("_Z1bPf", ["EXIT"]))
    assert got["_Z1aPf"] == ("LDC R1, c[0x0][0x28]", "LDC R2, c[0x0][param]",
                             "@P0 BRA `(L0)", "EXIT")
    assert got["_Z1bPf"] == ("EXIT",)


def test_pair_ignores_parameter_offsets_and_label_numbers():
    there = parse_sass(_listing("_Z3oldPf", _kernel(0x210, 3)) + "\n"
                       + _listing("_Z4gonePf", _kernel(0x210, 4, "R3")))
    here = parse_sass(_listing("_Z3newILb0EEvPf", _kernel(0x218, 9)) + "\n"
                      + _listing("_Z3newILb1EEvPf", _kernel(0x218, 9, "R4")))
    assert pair(here, there) == (1, ["_Z4gonePf"], ["_Z3newILb1EEvPf"])
    # Bank 0 below the parameters (here the stack pointer at 0x28) still counts.
    moved = parse_sass(_listing("_Z1cPf", ["LDC R1, c[0x0][0x30]"]))
    base = parse_sass(_listing("_Z1cPf", ["LDC R1, c[0x0][0x28]"]))
    assert pair(moved, base) == (0, ["_Z1cPf"], ["_Z1cPf"])
