"""Time layouts of the grid probe (csrc/grid_correspond.cu) against the
committed one.

    python3 tpuslam_torch/bench/grid_variants.py [--reps 3]

Each variant is `csrc/grid_correspond.cu` with some constants or lines
substituted (lanes a query, queries a block, row loads in flight a lane,
how the list is written, the hash), compiled by nvcc into a library
of its own, all in parallel.  Three more leave out a stage (the row loads,
the scan, the lookups): they are not bit-equal, and their times less the
committed one's say what each stage costs.  Every variant builds the
index's table and runs the posed probe at chip_smoke.py's phase-3 shapes
(16,384 queries x 131,072 rows, ~150 points to a cell; the inputs of
profile_odometry.py --mode grid), its queries in random order and sorted
by voxel key, is checked bit-equal to the plain twin in both orders (the
stage drops are reported, not held to it), and is timed by its device µs a
launch (20 launches under torch.profiler), the variants in turns (forward,
then back) `--reps` times.  Prints the card's name and power limit, then
one JSON line: each variant's registers, shared bytes and spill bytes
(ptxas), and its device µs in each order with their minimum.  Exits 2
without a GPU, 1 when a variant other than a stage drop is not
bit-equal.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# the list as the committed probe writes it: each lane its own cells' rows,
# in a rotated order
PER_LANE = """  int at = incl - own;
#pragma unroll
  for (int k = 0; k < kCellsPerLane; ++k) {
    const int start = static_cast<int>(run[k] >> 5);
    const int count = static_cast<int>(run[k] & 31u);
    // in a rotated order: lanes whose runs start a bank apart write
    // different banks
    for (int j = 0; j < kSlots; ++j) {
      const int s = (j + lane) & (kSlots - 1);
      if (s < count) list[at + s] = start + s;
    }
    at += count;
  }
"""
# the list written one occupied cell at a time by all of a query's lanes
# (a ballot of the occupied cells, their runs shuffled to the lanes)
BALLOT = """  int off[kCellsPerLane];
  off[0] = incl - own;
#pragma unroll
  for (int k = 1; k < kCellsPerLane; ++k) {
    off[k] = off[k - 1] + static_cast<int>(run[k - 1] & 31u);
  }
  const unsigned group =
      kLanes == 32 ? kFull
                   : ((1u << (kLanes & 31)) - 1u)
                         << ((threadIdx.x & 31) & ~(kLanes - 1));
#pragma unroll
  for (int k = 0; k < kCellsPerLane; ++k) {
    unsigned pending = __ballot_sync(kFull, (run[k] & 31u) != 0u) & group;
    while (__any_sync(kFull, pending != 0u)) {
      const bool act = pending != 0u;
      const int src = act ? __ffs(pending) - 1 : (threadIdx.x & 31);
      pending &= pending - 1u;
      const uint32_t r = __shfl_sync(kFull, run[k], src);
      const int o = __shfl_sync(kFull, off[k], src);
      const int start = static_cast<int>(r >> 5);
      const int count = act ? static_cast<int>(r & 31u) : 0;
      for (int j = lane; j < count; j += kLanes) list[o + j] = start + j;
    }
  }
"""
VARIANTS = {
    "committed": {},
    "a warp a query": {"kLanes = 16": "kLanes = 32"},
    "8 lanes a query": {"kLanes = 16": "kLanes = 8",
                        "kQueries = 8": "kQueries = 16"},
    "16 queries a block": {"kQueries = 8": "kQueries = 16"},
    "2 loads in flight": {"kBatch = 4": "kBatch = 2"},
    "8 loads in flight": {"kBatch = 4": "kBatch = 8"},
    "straight list writes": {
        """    for (int j = 0; j < kSlots; ++j) {
      const int s = (j + lane) & (kSlots - 1);
      if (s < count) list[at + s] = start + s;
    }""": "    for (int j = 0; j < count; ++j) list[at + j] = start + j;"},
    "list a cell at a time": {PER_LANE: BALLOT},
    "z-neighbours share a sector": {
        "return (static_cast<uint32_t>(key) * kHashMul) >> (32 - bits);":
        "return (((static_cast<uint32_t>(key) >> 2) * kHashMul) >> "
        "(32 - bits) & ~3u) | (static_cast<uint32_t>(key) & 3u);"},
}
# Not bit-equal: each leaves out a stage of the committed probe, so the
# difference from "committed" is what that stage costs.
STAGE_DROPS = {
    "drop: the row loads": {"__ldg(rows + 2 * r[u])":
                            "make_float4(x0, x1, x2, 0.0f)"},
    "drop: the scan": {
        "const int total = __shfl_sync(kFull, incl, kLanes - 1, kLanes);":
        "const int total = 0 * __shfl_sync(kFull, incl, kLanes - 1, kLanes);"},
    "drop: the lookups": {
        "run[k] = lookup(table, tmask, bits, (a << 16) | (b << 8) | z);":
        "run[k] = 0u;"},
}


def ptxas_probe(log: str) -> dict:
    """Registers, shared bytes and spill bytes of grid_correspond_kernel in
    nvcc's -Xptxas -v log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and \
                "grid_correspond_kernel" in line:
            rest = "\n".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", rest)
            smem = re.search(r"(\d+) bytes smem", rest)
            spill = re.search(r"(\d+) bytes spill stores", rest)
            return {"registers": int(regs.group(1)) if regs else None,
                    "smem_bytes": int(smem.group(1)) if smem else 0,
                    "spill_store_bytes": int(spill.group(1)) if spill else 0}
    return {}


def build_variants(tmp: Path) -> dict:
    from tpuslam_torch.kernels import _build

    src = (ROOT / "tpuslam_torch" / "csrc" / "grid_correspond.cu").read_text()
    jobs = []
    for name, subs in {**VARIANTS, **STAGE_DROPS}.items():
        text = src
        for a, b in subs.items():
            if a not in text:
                raise RuntimeError(f"{name}: {a!r} not in grid_correspond.cu")
            text = text.replace(a, b)
        stem = re.sub(r"\W+", "_", name)
        (tmp / f"{stem}.cu").write_text(text)
        cmd = [_build.find_nvcc(), *_build.COMPILE_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(tmp / f"{stem}.so"),
               str(tmp / f"{stem}.cu")]
        jobs.append((name, stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, stem, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(tmp / f"{stem}.so"))
        for fn, argtypes in _build._SIGNATURES.items():
            if fn.startswith("tpuslam_grid"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, ptxas_probe(log))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import torch

    if not torch.cuda.is_available():
        print("grid_variants: no CUDA device", file=sys.stderr)
        return 2
    from tpuslam_torch.bench.profile_odometry import (
        GRID_CELL,
        event_and_device_us,
        grid_inputs,
    )
    from tpuslam_torch.config import VoxelConfig
    from tpuslam_torch.geom.voxel import voxel_keys
    from tpuslam_torch.kernels import _build, correspond, gn_epilogue

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    target, x, xm, T = grid_inputs(dev)
    carry = gn_epilogue.init_carry(T, 12)
    vc = VoxelConfig()
    hi, lo, _ = voxel_keys(x, torch.ones_like(xm), vc.voxel_size, vc.origin,
                           vc.extent)
    order = torch.sort(hi.long() * 2 ** 31 + lo.long(), stable=True).indices
    orders = {"random": (x, xm),
              "voxel_key": (x[order].contiguous(), xm[order].contiguous())}
    # the committed library sorts; each variant builds its own table
    plain_index = correspond.build_grid_index(target, GRID_CELL)._replace(
        table=None)
    ref = {k: correspond.grid_correspond_at_pose_reference(
        xq, xmq, plain_index, GRID_CELL, T) for k, (xq, xmq) in orders.items()}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        times = {k: {o: [] for o in orders} for k in libs}
        equal = {k: True for k in libs}
        library = _build.library
        try:
            for _ in range(args.reps):
                for name in list(libs) + list(libs)[::-1]:
                    _build.library = lambda _lib=libs[name][0]: _lib
                    index = correspond.with_cell_table(plain_index)
                    for o, (xq, xmq) in orders.items():
                        out = correspond.correspondence_buffers(xq.shape[0],
                                                                dev)

                        def probe(xq=xq, xmq=xmq, out=out, index=index):
                            correspond.grid_correspond_at_pose(
                                xq, xmq, index, GRID_CELL, carry, out=out)
                        _, us = event_and_device_us(
                            probe, "grid_correspond_kernel", runs=5)
                        equal[name] &= all(torch.equal(a, b)
                                           for a, b in zip(out, ref[o]))
                        times[name][o].append(us)
        finally:
            _build.library = library
    print(json.dumps({"card": card, "shape": [x.shape[0],
                                              target.points.shape[0]],
                      "variants": {k: {
                          **libs[k][1], "bit_equal": equal[k],
                          "device_us": times[k],
                          "min_device_us": {o: min(v) for o, v in
                                            times[k].items()}}
                          for k in libs}}), flush=True)
    return 0 if all(equal[k] for k in VARIANTS) else 1


if __name__ == "__main__":
    sys.exit(main())
