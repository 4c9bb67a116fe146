"""Where the score store of kernel 11 (the fused-xent forward that saves the
scores) spends its time: kernels 10 and 11 of one or more checkouts beside
a diagnostic copy of kernel 11 whose store is aimed at a small scratch.

For each checkout (this one first), builds its
``tpudml_torch/csrc/xent.cu`` as it is and a copy in which the row index
of every score store, ``static_cast<long long>(row) * V``, becomes
``row & 127``: the same store instructions, but their bytes land in a
128-row window of s (16 MiB at V = 32768) that stays in L2 instead of
going out to device memory. Then times kernel 10, kernel 11 and the
copy's kernel 11 with CUDA events at the flagship head (N = 8192, d = 512,
V = 32768) in bf16 and f32 and at the long context's N = 32768 in f32,
the checkouts in turns (A, B, B, A). Prints one JSON line per shape,
checkout and variant, with the card's name and power limit.

Run on the card, from a checkout's root:
``python -m tpudml_torch.tools.xent_store_probe [OTHER ...]`` (OTHER e.g.
a parent commit unpacked with ``git archive``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from tpudml_torch.device import no_tf32
from tpudml_torch.ops.cuda_lib import BUILD_DIR, NVCC_FLAGS, PKG_DIR, find_nvcc

STORE = re.compile(r"static_cast<long long>\(row\) \* V")
SCRATCH = "static_cast<long long>(row & 127) * V"
SHAPES = ((8192, 512, 32768, torch.bfloat16), (8192, 512, 32768, torch.float32),
          (32768, 512, 32768, torch.float32))
P, I = ctypes.c_void_p, ctypes.c_int


def _start(csrc: Path, tag: str, scratch: bool):
    src = (csrc / "xent.cu").read_text()
    if scratch:
        src, hits = STORE.subn(SCRATCH, src)
        if not hits:
            raise SystemExit(f"{csrc / 'xent.cu'}: no score store to aim at the scratch")
    out = BUILD_DIR / "store_probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{tag}.cu").write_text(src)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(out / f"{tag}.so"),
           str(out / f"{tag}.cu")]
    return out / f"{tag}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)


def _load(path: Path, proc) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {path.with_suffix('.cu')}:\n{log[-4000:]}")
    lib = ctypes.CDLL(str(path))
    lib.xent_fwd.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.xent_fwd_save.argtypes = [P] * 8 + [I] * 4 + [P]
    return lib


def _launch(lib, save: bool, x, w, b, y, s, part, lse, picked) -> None:
    n, d = x.shape
    v = w.shape[1]
    head = [P(t.data_ptr()) for t in (x, w, b, y)] + ([P(s.data_ptr())] if save else [])
    fn = lib.xent_fwd_save if save else lib.xent_fwd
    err = fn(*head, P(part.data_ptr()), P(lse.data_ptr()), P(picked.data_ptr()), I(n), I(d),
             I(v), I(int(x.dtype == torch.bfloat16)), P(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"xent forward: CUDA error {err}")


def _ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="*", help="other checkouts' roots")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("xent_store_probe runs only on the card")
    roots = {"this": PKG_DIR.parent, **{o: Path(o).resolve() for o in args.others}}
    started = {(name, scratch): _start(root / "tpudml_torch" / "csrc", f"{i}_{int(scratch)}",
                                       scratch)
               for i, (name, root) in enumerate(roots.items()) for scratch in (False, True)}
    libs = {key: _load(*job) for key, job in started.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    no_tf32("cuda")
    names = list(roots)
    for n, d, v, dtype in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((n, d), generator=g, device="cuda").to(dtype)
        w = ((torch.rand((d, v), generator=g, device="cuda") * 2 - 1) / d ** 0.5).to(dtype)
        b = ((torch.rand((v,), generator=g, device="cuda") * 2 - 1) / d ** 0.5).to(dtype)
        y = torch.randint(0, v, (n,), generator=g, dtype=torch.int32, device="cuda")
        s = torch.empty((n, v), device="cuda")
        part = torch.empty((3, -(-v // 128), n), device="cuda")  # the most slices of either
        lse, picked = torch.empty(n, device="cuda"), torch.empty(n, device="cuda")
        times: dict[tuple, list] = {}
        for name in names + names[::-1]:
            for kernel, save, scratch in (("10", False, False), ("11", True, False),
                                          ("11_scratch", True, True)):
                lib = libs[(name, scratch)]
                times.setdefault((name, kernel), []).append(_ms(
                    lambda: _launch(lib, save, x, w, b, y, s, part, lse, picked)))
        for (name, kernel), ms in times.items():
            print(json.dumps({"shape": f"N={n} d={d} V={v} {str(dtype)[6:]}", "checkout": name,
                              "kernel": kernel, "ms": ms, "card": smi}), flush=True)
        del x, w, s, part
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
