"""Measure the card's issue rate of each non-tensor instruction that the
kernel table's operation bounds count (chip_smoke.py: INT32_OPS_PER_S,
DPX_OPS_PER_S, F32_OPS_PER_S), as SASS instructions a clock per SM.

    python3 scripts/issue_rates.py [--trips N] [--out FILE]
    python3 scripts/issue_rates.py --sass LIB NAME  # the SASS opcodes of
                                   # each loop of LIB's kernels whose
                                   # mangled name holds NAME

Builds scripts/issue_rates.cu with nvcc (sm_90a) into build/issue_rates/,
runs each operation in one block of 1024 threads per SM (8 dependent rings
a thread), reads each block's SM clock around its loop, and counts the
operation's SASS instructions in the loop body (cuobjdump -sass). Per SM:
instructions of all its blocks over the span of their clocks; the line
reports the median over the SMs, the SASS opcodes of the loop body, and the
rate a second at the card's top SM clock (nvidia-smi clocks.max.sm). Needs
an NVIDIA GPU with the CUDA toolkit; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "scripts" / "issue_rates.cu"
OUT_DIR = ROOT / "build" / "issue_rates"
#: the kernels' operations in issue_rates.cu's order, and the SASS opcodes
#: (their stem, before the first '.') each may compile to: the one of them
#: most frequent in the loop body is the instruction measured
OPS = (
    ("int32 add", ("IADD3", "IADD")),
    ("int32 max", ("IMNMX", "VIMNMX")),
    ("DPX add + max (__viaddmax_s32)", ("VIADDMNMX",)),
    ("DPX max of three (__vimax3_s32)", ("VIMNMX3", "IMNMX3", "VIMNMX", "IMNMX")),
    ("byte permute", ("PRMT",)),
    ("logic (xor)", ("LOP3",)),
    ("f32 add", ("FADD",)),
    ("f32 fma", ("FFMA",)),
    ("warp shuffle", ("SHFL",)),
    ("warp reduce (__reduce_max_sync)", ("REDUX",)),
    ("int32 to f32", ("I2FP", "I2F")),
)
#: source operations a loop trip (kUnroll steps of kChains rings)
OPS_PER_TRIP = 32 * 8
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")


def nvcc() -> Path:
    import shutil

    found = shutil.which("nvcc")
    return Path(found) if found else Path("/usr/local/cuda/bin/nvcc")


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def functions(sass: str, name: str) -> dict[str, str]:
    """{mangled name: its SASS} of the functions whose name holds ``name``,
    in cuobjdump -sass."""
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        head = fn.split(None, 1)[0]
        if name in head:
            out[head] = fn
    return out


def loops(fn: str) -> list[tuple[int, int, collections.Counter]]:
    """Each loop of a function's SASS, in order: the addresses from a
    backward branch's target to the branch, and its opcodes (their stems,
    before the first '.') counted."""
    ins = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                                                    fn)]
    out = []
    for addr, tgt in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?BRA[^\n]*?(0x[0-9a-f]+)", fn):
        lo, hi = int(tgt, 16), int(addr, 16)
        if lo < hi:
            out.append((lo, hi, collections.Counter(o.split(".")[0] for a, o in ins if lo <= a <= hi)))
    return out


def loop_bodies(sass: str) -> dict[int, collections.Counter]:
    """{op: opcode counts of rate_kernel<op>'s loop body} (its one loop)."""
    out = {}
    for head, fn in functions(sass, "rate_kernel").items():
        body = loops(fn)
        out[int(re.search(r"rate_kernelILi(\d+)E", head).group(1))] = body[-1][2] if body else collections.Counter()
    return out


def print_loops(lib: Path, name: str) -> int:
    """Each loop of the kernels of ``lib`` whose mangled name holds
    ``name``: its address range, its instructions and its opcodes by count,
    one JSON line a loop (the whole function's count first)."""
    sass = subprocess.run([str(nvcc().parent / "cuobjdump"), "-sass", str(lib)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    found = functions(sass, name)
    for head, fn in found.items():
        every = collections.Counter(o.split(".")[0] for o in re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn))
        print(json.dumps(dict(function=head, instructions=sum(every.values()), opcodes=dict(every.most_common()))))
        for lo, hi, body in loops(fn):
            print(json.dumps(dict(function=head, loop=[hex(lo), hex(hi)], instructions=sum(body.values()),
                                  opcodes=dict(body.most_common()))))
    return 0 if found else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trips", type=int, default=2000, help="loop trips a thread (256 steps each)")
    ap.add_argument("--out", type=Path, default=None, help="also write the lines to this file")
    ap.add_argument("--sass", nargs=2, metavar=("LIB", "NAME"), default=None,
                    help="print the SASS opcodes of each loop of LIB's kernels whose mangled name holds NAME")
    args = ap.parse_args(argv)
    if args.sass:
        return print_loops(Path(args.sass[0]), args.sass[1])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = OUT_DIR / "libissue_rates.so"
    subprocess.run([str(nvcc()), *NVCC_FLAGS, "-o", str(lib_path), str(SRC)], check=True, timeout=600)
    sass = subprocess.run([str(nvcc().parent / "cuobjdump"), "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    bodies = loop_bodies(sass)
    lib = ctypes.CDLL(str(lib_path))
    lib.issue_rates_run.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_longlong)]
    assert lib.issue_rates_ops() == len(OPS), "OPS is out of step with issue_rates.cu"
    threads = lib.issue_rates_threads()

    label = smi("name,power.limit")
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    host_in = (ctypes.c_int32 * 2048)(*[(i * 2654435761) % 1000003 for i in range(1024)],
                                      *[(7 * i + 3) % 32 for i in range(1024)])
    lines = []
    for op, (what, opcodes) in enumerate(OPS):
        rec = (ctypes.c_longlong * (3 * sms))()
        rc = lib.issue_rates_run(op, sms, args.trips, host_in, rec)
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")
        per_sm = collections.defaultdict(list)
        for b in range(sms):
            per_sm[rec[3 * b + 2]].append((rec[3 * b], rec[3 * b + 1]))
        body = bodies.get(op, collections.Counter())
        opcode = max(opcodes, key=lambda o: body.get(o, 0))
        n_op = body.get(opcode, 0)
        # thread-cycles a trip of each SM: its blocks' threads over its clock span
        trips_per_clock = [args.trips * threads * len(spans) / (max(e for _, e in spans) - min(s for s, _ in spans))
                           for spans in per_sm.values()]
        rates = [n_op * t for t in trips_per_clock]
        per_clock = statistics.median(rates)
        ops_per_clock = OPS_PER_TRIP * statistics.median(trips_per_clock)
        line = dict(operation=what, sass=opcode, per_trip=n_op, ops_per_trip=OPS_PER_TRIP,
                    loop_body=dict(body.most_common(6)), sms_used=len(per_sm), blocks=sms,
                    per_clock_per_sm=per_clock, per_clock_min=min(rates), per_clock_max=max(rates),
                    ops_per_clock_per_sm=ops_per_clock, per_s_at_max_clock=per_clock * sms * sm_mhz * 1e6,
                    ops_per_s_at_max_clock=ops_per_clock * sms * sm_mhz * 1e6, card=label)
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = dict(card=label, sms=sms, clocks_max_sm_mhz=sm_mhz, threads_per_sm=threads,
                   per_clock_per_sm={ln["operation"]: (ln["sass"], ln["per_clock_per_sm"], ln["ops_per_clock_per_sm"])
                                     for ln in lines})
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in [*lines, summary]))
    print(label, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
