"""The kernels on two CUDA streams of one card at once: every launch's
result bit-equal to the same launch run alone, and the tickets back at
zero after.

The SLAM backend's worker runs a loop-closure attempt's `correspond`,
`gn_step` and `gn_fused` on a stream of its own while tracking launches
the same kernels on the main stream; the ring ICP's `ring_nn` keeps scratch
the same way.  `gn_step`/`gn_fused` fold their blocks' rows after an
atomic ticket and `ring_nn` its slices' partials, in scratch the wrappers
keep: scratch shared by two streams would let one launch's blocks draw the
other's tickets and read its rows, with wrong answers and no error.

The captured programs (tpuslam_torch/graphs.py) replay the same kernels
from CUDA graphs, each graph with the scratch it baked in at its capture:
`graph:process_frame_jit` (the frame's whole tracking) and
`graph:optimize_pose_graph` (a 32-node dense solve) replay on both streams
at once too, a graph a stream, each call copying its inputs in and its
outputs out.

`check_two_streams` gives each stream inputs of its own (another frame
and pose; another random map and query set for `ring_nn`; another graph)
and records each kernel's result launched alone.  Then, kernel by kernel, it starts one
thread a stream: each holds its stream behind a device-side sleep, queues
`launches` launches of that kernel (fresh carries and outputs each) and
lets them run, so the two streams' launches of the same kernel run side
by side on the device (with all four kernels in each round, the long
`ring_nn` hops paced the streams and the short launches rarely met their
twins).  It returns, per kernel, the launches a stream and how many
results differ from the lone launch's in any bit, and whether every
ticket the wrappers keep (by stream or by graph) is zero after.

    python tpuslam_torch/bench/two_streams.py [--root DIR] [--tag TAG]

runs it on the card for the package under DIR (default: this checkout; a
parent commit unpacked with `git archive` runs its own wrappers) and
prints one JSON line.  Only the wrappers' public calls are used, so an
older checkout runs too.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

SLEEP_CYCLES = 200_000_000    # ~0.1 s at the H100's clock: the queue fills
JOIN_S = 300.0


def _same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _shift(x: float):
    """A pure translation by x along the first axis."""
    import numpy as np

    m = np.eye(4)
    m[0, 3] = x
    return m


def _stream_inputs(dev, height: int, width: int, ring_n: int, ring_m: int,
                   frame: int, seed: int):
    """One stream's launches, each a callable returning its outputs."""
    import numpy as np
    import torch

    from tpuslam_torch.backend.posegraph import GraphHost, optimize_pose_graph
    from tpuslam_torch.bench.harness import _render_sequence
    from tpuslam_torch.config import SLAMConfig
    from tpuslam_torch.frontend import preprocess, process_frame_jit
    from tpuslam_torch.geom import se3
    from tpuslam_torch.icp import pack_pyramid, select_level_source
    from tpuslam_torch.kernels import (
        correspond,
        gn_epilogue,
        gn_fused,
        gn_step,
        ring_nn,
    )

    cfg = SLAMConfig(height=height, width=width).validate()
    icp = cfg.icp
    K, _, d_np = _render_sequence(3, height, width)
    d = torch.as_tensor(d_np, device=dev)
    kf_packed = pack_pyramid(preprocess(d[0], K, cfg), icp)
    packed = kf_packed[0]
    src = select_level_source(preprocess(d[frame], K, cfg), 0, icp)
    pts, nrm = src.points.contiguous(), src.normals.contiguous()
    mask = src.mask.contiguous()
    rng = np.random.default_rng(seed)
    T = se3.exp(torch.as_tensor(rng.normal(scale=0.004, size=6),
                                dtype=torch.float32, device=dev))
    carry = gn_epilogue.init_carry(T, 12)
    nvs = torch.sum(mask.to(torch.float32))
    geo = (height, width, K, icp.max_corr_dist, icp.normal_dot_min)
    corr = correspond.projective_correspond_at_pose(pts, mask, nrm, packed,
                                                    *geo, carry)
    solve = (icp.damping, icp.damping_abs, icp.max_trans_step,
             icp.max_rot_step, False, icp.inner_steps, 12, icp.tol_delta ** 2)
    gate = gn_fused.gate_buffer(dev)

    # ring_nn at its own shapes: a map half valid, queries near it
    q = rng.uniform(-2.0, 2.0, (ring_m, 3)).astype(np.float32)
    qn = rng.normal(size=(ring_m, 3)).astype(np.float32)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    shard = ring_nn.pack_cloud_rows(
        torch.as_tensor(q, device=dev), torch.as_tensor(qn, device=dev),
        torch.as_tensor(rng.uniform(size=ring_m) > 0.5, device=dev))
    x = torch.as_tensor(q[rng.integers(0, ring_m, ring_n)]
                        + rng.normal(scale=0.02, size=(ring_n, 3))
                        .astype(np.float32), device=dev)
    x_mask = torch.ones(ring_n, dtype=torch.bool, device=dev)

    def ring():
        state = ring_nn.ring_state(ring_n, dev)
        ring_nn.ring_correspond_hop(x, x_mask, shard, state, carry, True,
                                    True, icp.max_corr_dist)
        return tuple(state)

    # a 20-node chain with a loop edge, its nodes off by a few centimetres
    host = GraphHost(cfg.posegraph, device=dev)
    for k in range(20):
        node = np.eye(4, dtype=np.float32)
        node[:3, 3] = [0.1 * k, 0.0, 0.0] + rng.normal(scale=0.03, size=3)
        host.add_node(node)
        if k:
            host.add_edge(k - 1, k, _shift(0.1))
    host.add_edge(0, 19, _shift(1.9), weight=2.0)
    graph = host.graph(bucketed=True)
    eye = torch.eye(4, device=dev)

    def track():
        pyr, T_new, delta, flat = process_frame_jit(d[frame], kf_packed, K,
                                                    eye, eye, cfg)
        return (*(t for f in pyr for t in f), T_new, delta, flat)

    return pts.shape[0], {
        "correspond": lambda: tuple(correspond.projective_correspond_at_pose(
            pts, mask, nrm, packed, *geo, carry)),
        "gn_step": lambda: (gn_step.gn_step(
            pts, corr.q, corr.n, corr.w, carry.clone(), nvs,
            icp.huber_delta, *solve),),
        "gn_fused": lambda: (gn_fused.gn_fused_step(
            pts, nrm, mask, packed, carry.clone(), gate.clone(), True, K,
            width, height, icp.max_corr_dist, icp.normal_dot_min,
            icp.huber_delta, nvs, *solve),),
        "ring_nn": ring,
        "graph:process_frame_jit": track,
        "graph:optimize_pose_graph": lambda: optimize_pose_graph(
            graph, cfg.posegraph),
    }


def tickets_zero(dev, streams) -> bool:
    """Whether every ticket the wrappers keep for `streams` — and for any
    other stream or graph — is zero."""
    import torch

    from tpuslam_torch.kernels import gn_step, ring_nn

    zero = True
    for s in streams:
        with torch.cuda.stream(s):
            ticket, _ = gn_step.scratch(dev)
            tickets, _ = ring_nn._scratch(dev, 1, 1)
            zero &= not bool(ticket.any()) and not bool(tickets.any())
    for table in (gn_step._workspace, ring_nn._workspace):
        zero &= not any(bool(ws[0].any()) for ws in list(table.values()))
    return zero


def check_two_streams(dev, height: int = 480, width: int = 640,
                      ring_n: int = 16384, ring_m: int = 131072,
                      launches: int = 100) -> dict:
    """The check of the module doc on `dev` (a CUDA device)."""
    import torch

    t0 = time.perf_counter()
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    fns, alone = [], []
    for i, s in enumerate(streams):
        with torch.cuda.stream(s):
            n_pts, f = _stream_inputs(dev, height, width, ring_n, ring_m,
                                      frame=1 + i, seed=10 + i)
            fns.append(f)
            torch.cuda.synchronize(dev)
            one = {}
            for name, fn in f.items():
                one[name] = fn()
                torch.cuda.synchronize(dev)       # alone on the card
            alone.append(one)
    kernels = {}
    for name in fns[0]:
        results: list = [None, None]
        errors: list = []

        def run(i: int) -> None:
            try:
                with torch.cuda.device(dev), torch.cuda.stream(streams[i]):
                    torch.cuda._sleep(SLEEP_CYCLES)   # hold the queue
                    results[i] = [fns[i][name]() for _ in range(launches)]
            except BaseException as e:               # raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            if t.is_alive():
                raise TimeoutError(f"two streams: a thread ran past "
                                   f"{JOIN_S} s")
        if errors:
            raise errors[0]
        torch.cuda.synchronize(dev)
        bad = sum(not all(_same_bits(a, b) for a, b in zip(r, alone[i][name]))
                  for i in range(2) for r in results[i])
        kernels[name] = {"launches_per_stream": launches, "mismatches": bad}
    return {"kernels": kernels, "tickets_zero": tickets_zero(dev, streams),
            "points": n_pts, "ring": [ring_n, ring_m],
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose tpuslam_torch to run")
    ap.add_argument("--tag", default="change",
                    help="a label for the printed line (parent, change)")
    args = ap.parse_args()
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import tpuslam_torch
    from tpuslam_torch.kernels import _build

    if not torch.cuda.is_available():
        print("two_streams: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    r = check_two_streams(torch.device("cuda:0"))
    print(json.dumps({"tag": args.tag, "package": tpuslam_torch.__file__,
                      "card": torch.cuda.get_device_name(0), **r}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
