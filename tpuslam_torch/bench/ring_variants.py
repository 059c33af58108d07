"""Time variants of the ring_nn kernel's tiling against the committed one.

    python3 tpuslam_torch/bench/ring_variants.py [--reps 3]

Each variant is `csrc/ring_nn.cu` with some constants substituted (queries
a thread, threads a block, rows a tile, waves of blocks), compiled by nvcc
into a library of its own, all in parallel.  Every variant runs the ring
ICP's hop (`ring_correspond_hop`, first and last hop at once) at
chip_smoke.py's shapes (16,384 queries x 131,072 rows, about half valid),
is checked bit-equal to the plain twin, and is timed by CUDA events over 20
launches, the variants in turns (forward, then back) `--reps` times.
Prints the card's name and power limit, then one JSON line: each variant's
registers, shared bytes, blocks a query tile, launch times and their
minimum.  Exits 2 without a GPU.
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
VARIANTS = {
    "committed": {},
    "8 queries a thread": {"kQueriesPerThread = 16": "kQueriesPerThread = 8",
                           "kMinBlocks = 3": "kMinBlocks = 4"},
    "12 queries a thread": {"kQueriesPerThread = 16":
                            "kQueriesPerThread = 12"},
    "256 threads, 8 queries": {"kThreads = 128": "kThreads = 256",
                               "kQueriesPerThread = 16":
                               "kQueriesPerThread = 8",
                               "kMinBlocks = 3": "kMinBlocks = 2"},
    "512-row tiles": {"kTile = 256": "kTile = 512"},
    "two waves": {"resident / query_tiles": "2 * resident / query_tiles"},
}


def build_variants(tmp: Path) -> dict:
    from tpuslam_torch.kernels import _build

    src = (ROOT / "tpuslam_torch" / "csrc" / "ring_nn.cu").read_text()
    jobs = []
    for name, subs in VARIANTS.items():
        text = src
        for a, b in subs.items():
            if a not in text:
                raise RuntimeError(f"{name}: {a!r} not in ring_nn.cu")
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
        regs, smem = re.findall(r"Used (\d+) registers.*?(\d+) bytes smem",
                                log)[0]
        lib = ctypes.CDLL(str(tmp / f"{stem}.so"))
        for fn, argtypes in _build._SIGNATURES.items():
            if fn.startswith("tpuslam_ring_nn"):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, int(regs), int(smem))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ring_variants: no CUDA device", file=sys.stderr)
        return 2
    from tpuslam_torch.kernels import _build, gn_epilogue, ring_nn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda:0")
    n, m = 16384, 131072
    rng = np.random.default_rng(0)
    q = rng.uniform(-2.0, 2.0, (m, 3)).astype(np.float32)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.5
    p = (q[rng.integers(0, m, n)]
         + rng.normal(scale=0.02, size=(n, 3))).astype(np.float32)
    pts = torch.as_tensor(p, device=dev)
    mask = torch.ones(n, dtype=torch.bool, device=dev)
    shard = ring_nn.pack_cloud_rows(torch.as_tensor(q, device=dev),
                                    torch.as_tensor(nrm, device=dev),
                                    torch.as_tensor(valid, device=dev))
    carry = gn_epilogue.init_carry(torch.eye(4, device=dev), 12)
    ref = ring_nn.ring_state(n, dev)
    ring_nn.ring_correspond_hop_reference(
        pts, mask, shard, ref, carry[gn_epilogue.T_SLICE].reshape(4, 4),
        True, True, 0.05)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(Path(tmp))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        times = {k: [] for k in libs}
        equal = {}
        library = _build.library
        try:
            for _ in range(args.reps):
                for name in list(libs) + list(libs)[::-1]:
                    _build.library = lambda _lib=libs[name][0]: _lib
                    ring_nn._workspace.clear()
                    st = ring_nn.ring_state(n, dev)

                    def hop(st=st):
                        ring_nn.ring_correspond_hop(pts, mask, shard, st,
                                                    carry, True, True, 0.05)
                    hop()
                    torch.cuda.synchronize()
                    equal[name] = all(
                        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
                        for a, b in zip(st, ref))
                    start.record()
                    for _ in range(20):
                        hop()
                    stop.record()
                    torch.cuda.synchronize()
                    times[name].append(start.elapsed_time(stop) / 20)
        finally:
            _build.library = library
            ring_nn._workspace.clear()
    print(json.dumps({"card": card, "shape": [n, m, int(valid.sum())],
                      "variants": {k: {
                          "registers": libs[k][1], "smem_bytes": libs[k][2],
                          "blocks_a_query_tile":
                              libs[k][0].tpuslam_ring_nn_slices(n, m),
                          "bit_equal": equal[k], "ms": times[k],
                          "min_ms": min(times[k])} for k in libs}}),
          flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
