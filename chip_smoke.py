"""Drive the PyTorch port's main path on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and the script exits non-zero):
  1. device   — require a CUDA device; print its name and power limit
  2. build    — build the three CUDA kernels from tpuslam_torch/csrc
  3. kernels  — each kernel against its plain PyTorch twin at the main
                path's shapes (all three levels of a 640×480 frame pair),
                with each one's time beside its twin's
  4. uint16   — raw uint16 depth divided on the device is bit-equal to
                host-divided float32 depth
  5. small    — a 12-frame 120×160 scan on the GPU against the same scan
                through the plain twins on the CPU (the twins are held to
                the JAX reference by tests/test_torch_*.py)
  6. main     — tpuslam_torch.bench.harness.run_bench: 240 frames at
                640×480, default config; ATE < 1 mm; every kernel
                launched, no plain twin called
  7. profile  — device time by kernel over a few frames (torch.profiler)
Then one JSON line with the kernels, and last a JSON line with the device.
No JAX is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL_PARTIALS_REL = 1e-4     # order of summation differs (blocks vs chunks)
TOL_EPILOGUE_T = 1e-5       # FMA contraction / libm differences
TOL_EPILOGUE_H_REL = 1e-6
TOL_SMALL_POSE = 1e-4       # GPU kernels vs CPU twins over 12 frames


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main() -> int:
    # ---- 1. device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from tpuslam_torch.bench.harness import _render_sequence, run_bench
    from tpuslam_torch.config import ICPConfig, KeyframeConfig, SLAMConfig
    from tpuslam_torch.frontend import preprocess, scan_odometry
    from tpuslam_torch.geom import se3
    from tpuslam_torch.icp import pack_pyramid, select_level_source
    from tpuslam_torch.kernels import _build, correspond, gn_epilogue, gn_partials

    dev = torch.device("cuda:0")
    card = gpu_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.3f} s ({card})")

    # ---- 3. kernels vs plain twins at the main path's shapes ----
    cfg = SLAMConfig()
    icp = cfg.icp
    K, _, depths_np = _render_sequence(2, 480, 640)
    d = torch.as_tensor(depths_np, device=dev)
    pyr_a = preprocess(d[0], K, cfg)
    pyr_b = preprocess(d[1], K, cfg)
    packed = pack_pyramid(pyr_a, icp)
    T = se3.exp(torch.tensor([0.01, -0.005, 0.008, 0.004, -0.006, 0.003],
                             device=dev))
    carry = gn_epilogue.init_carry(T, 12)
    nvs_all = {}
    stats = {"correspond": {}, "gn_partials": {}, "gn_epilogue": {}}
    for li in range(icp.pyramid_levels - 1, -1, -1):
        K_l = K.scaled(1.0 / 2 ** li)
        src = select_level_source(pyr_b, li, icp)
        h, w, _ = pyr_b[li].points.shape
        x = se3.transform_points(T, src.points)
        n_rot = se3.rotate_vectors(T, src.normals)
        args = (x, src.mask, packed[li], h, w, K_l, icp.max_corr_dist, n_rot,
                icp.normal_dot_min)
        ck = correspond.projective_correspond_packed(*args, done=carry)
        cr = correspond.projective_correspond_packed_reference(*args)
        torch.cuda.synchronize()
        check(torch.equal(ck.q, cr.q) and torch.equal(ck.n, cr.n),
              f"correspond level {li}: q/n not bit-equal")
        check(torch.equal(ck.idx, cr.idx), f"correspond level {li}: flat")
        w_mis = float((ck.w != cr.w).float().mean())
        check(w_mis == 0.0, f"correspond level {li}: w mismatch {w_mis}")
        c_err = max(float((ck.q - cr.q).abs().max()),
                    float((ck.n - cr.n).abs().max()),
                    float((ck.w - cr.w).abs().max()))

        pk = gn_partials.gn_reduce_partials(x, ck.q, ck.n, ck.w,
                                            icp.huber_delta, done=carry)
        pr = gn_partials.gn_reduce_partials_reference(x, ck.q, ck.n, ck.w,
                                                      icp.huber_delta)
        torch.cuda.synchronize()
        fk = gn_partials.fold_partials(pk)
        fr = gn_partials.fold_partials(pr)
        p_rel = max(rel_err(a, b) for a, b in zip(fk, fr))
        check(p_rel <= TOL_PARTIALS_REL,
              f"gn_partials level {li}: rel err {p_rel}")
        p_err = max(float((a - b).abs().max()) for a, b in zip(fk, fr))

        nvs = torch.sum(src.mask.to(torch.float32))
        nvs_all[li] = nvs
        eargs = (pk, carry, nvs, icp.damping, icp.damping_abs,
                 icp.max_trans_step, icp.max_rot_step, True, icp.inner_steps,
                 12, icp.tol_delta ** 2)
        ek_carry, ek_step = gn_epilogue.gn_epilogue(*eargs)
        er_carry, er_step = gn_epilogue.gn_epilogue_reference(*eargs)
        torch.cuda.synchronize()
        t_err = float((ek_step[gn_epilogue.STEP_T]
                       - er_step[gn_epilogue.STEP_T]).abs().max())
        h_rel = rel_err(ek_step[gn_epilogue.STEP_H],
                        er_step[gn_epilogue.STEP_H])
        check(t_err <= TOL_EPILOGUE_T, f"gn_epilogue level {li}: T {t_err}")
        check(h_rel <= TOL_EPILOGUE_H_REL, f"gn_epilogue level {li}: H {h_rel}")
        check(float((ek_carry[gn_epilogue.T_SLICE]
                     - er_carry[gn_epilogue.T_SLICE]).abs().max())
              <= TOL_EPILOGUE_T, f"gn_epilogue level {li}: carry T")
        check(float(ek_carry[gn_epilogue.IT]) == float(er_carry[gn_epilogue.IT])
              and float(ek_carry[gn_epilogue.DONE])
              == float(er_carry[gn_epilogue.DONE]),
              f"gn_epilogue level {li}: carry it/done")

        times = {
            "correspond": (
                time_ms(lambda: correspond.projective_correspond_packed(
                    *args, done=carry)),
                time_ms(lambda: correspond.projective_correspond_packed_reference(
                    *args))),
            "gn_partials": (
                time_ms(lambda: gn_partials.gn_reduce_partials(
                    x, ck.q, ck.n, ck.w, icp.huber_delta, done=carry)),
                time_ms(lambda: gn_partials.gn_reduce_partials_reference(
                    x, ck.q, ck.n, ck.w, icp.huber_delta))),
            "gn_epilogue": (
                time_ms(lambda: gn_epilogue.gn_epilogue(*eargs)),
                time_ms(lambda: gn_epilogue.gn_epilogue_reference(*eargs),
                        reps=20)),
        }
        errs = {"correspond": c_err, "gn_partials": p_err,
                "gn_epilogue": t_err}
        for name, (ms, plain_ms) in times.items():
            stats[name][li] = {"ms": ms, "plain_ms": plain_ms,
                               "max_abs_err": errs[name], "n": x.shape[0]}
            log(f"[kernels] {name} level {li} N={x.shape[0]}: kernel "
                f"{ms:.5f} ms, plain {plain_ms:.5f} ms, max_abs_err "
                f"{errs[name]:.3e} ({card})")
        log(f"[kernels] level {li}: w mismatch share {w_mis}, partials rel "
            f"{p_rel:.3e}, epilogue T {t_err:.3e} H rel {h_rel:.3e}")

    # ---- 4. uint16 divide ----
    raw = np.round(depths_np * cfg.depth_scale).astype(np.uint16)
    host = raw.astype(np.float32) / np.float32(cfg.depth_scale)
    for i in range(raw.shape[0]):
        pu = preprocess(torch.as_tensor(raw[i], device=dev), K, cfg)
        pf = preprocess(torch.as_tensor(host[i], device=dev), K, cfg)
        for a, b in zip(pu, pf):
            check(all(torch.equal(u, v) for u, v in zip(a, b)),
                  "uint16 preprocess is not bit-equal to float32")
    log(f"[uint16] device divide bit-equal to host-divided float32 "
        f"({raw.shape[0]} frames, 3 levels)")

    # ---- 5. small scan: GPU kernels vs CPU twins ----
    from tpuslam_torch.config import Intrinsics
    from tpuslam_torch.data.synthetic import orbit_trajectory, render_depth

    Ks = Intrinsics(160.0, 160.0, 79.5, 59.5)
    cfg_s = SLAMConfig(
        height=120, width=160,
        icp=ICPConfig(pyramid_levels=3, iters_per_level=(12, 8, 8),
                      max_corr_dist=0.25, huber_delta=0.05),
        keyframe=KeyframeConfig(max_translation=0.03, max_rotation=0.15))
    gt_s = orbit_trajectory(12)
    ds = np.stack([render_depth(gt_s[i], Ks, 120, 160, seed=i)
                   for i in range(12)])
    pg, fg, ig = scan_odometry(torch.as_tensor(ds, device=dev), Ks, cfg_s)
    pc, fc, ic = scan_odometry(torch.as_tensor(ds), Ks, cfg_s)
    small_err = float((pg.cpu() - pc).abs().max())
    check(torch.equal(fg.cpu(), fc), "small scan: promote flags differ")
    check(small_err <= TOL_SMALL_POSE, f"small scan: pose err {small_err}")
    log(f"[small] 12×120×160 scan GPU vs CPU twins: pose max err "
        f"{small_err:.3e}, promotions {int(fc.sum())} identical")

    # ---- 6. main path ----
    for c in (correspond.counter, gn_partials.counter, gn_epilogue.counter):
        c.reset()
    res = run_bench(frames=240, height=480, width=640, device="cuda")
    counts = {"correspond": correspond.counter,
              "gn_partials": gn_partials.counter,
              "gn_epilogue": gn_epilogue.counter}
    launches = {k: c.launches for k, c in counts.items()}
    plain = {k: c.plain_calls for k, c in counts.items()}
    log(f"[main] {json.dumps(res)}")
    log(f"[main] fps {res['fps']:.3f}, ms/frame {res['ms_per_frame']:.4f}, "
        f"icp_iter_latency_ms {res['icp_iter_latency_ms']:.5f}, ATE "
        f"{res['ate_rmse_m']:.3e} m ({card})")
    log(f"[main] launches {launches} plain calls {plain}")
    check(res["poses_finite"], "main: non-finite poses")
    check(res["ate_rmse_m"] < 1e-3, f"main: ATE {res['ate_rmse_m']} ≥ 1 mm")
    check(all(v > 0 for v in launches.values()), f"main: launches {launches}")
    check(all(v == 0 for v in plain.values()), f"main: plain calls {plain}")

    # ---- 7. profile: device time by kernel over a few frames ----
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    d8 = torch.as_tensor(depths_np, device=dev)
    d8 = d8[[0, 1] * 4]
    scan_odometry(d8, K, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan_odometry(d8, K, cfg)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue        # host ops: their device time is their kernels'
        dt = getattr(ev, "self_device_time_total", None)
        if dt is None:
            dt = getattr(ev, "self_cuda_time_total", 0)
        if dt > 0:
            rows.append((dt, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy > 0:
        log(f"[profile] 8 frames: wall {wall_us:.1f} us (profiled), device "
            f"busy {busy:.1f} us, idle share {1 - busy / wall_us:.4f} ({card})")
        for dt, cnt, key in rows[:15]:
            log(f"[profile]   {dt:10.1f} us  {cnt:6d}x  {key[:90]}")
    else:
        log("[profile] device time: not measured (profiler saw no kernels)")

    # ---- result lines ----
    sources = {
        "correspond": ("tpuslam_torch/csrc/correspond.cu",
                       "tpuslam/kernels/correspond.py:100"),
        "gn_partials": ("tpuslam_torch/csrc/gn_partials.cu",
                        "tpuslam/kernels/pallas_gn.py:37"),
        "gn_epilogue": ("tpuslam_torch/csrc/gn_epilogue.cu",
                        "tpuslam/kernels/pallas_epilogue.py:187"),
    }
    kernels = []
    for name, (src_path, replaces) in sources.items():
        s0 = stats[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src_path,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["max_abs_err"] for v in stats[name].values()),
            "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
