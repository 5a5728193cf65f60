"""Command-line interface — the engine's analogue of the reference's
launch file (reference launch/mcl_launch.py:19-147), ROS-free.

Subcommands:
  replay      run a recorded trace through the engine, report RMSE/rates
  live        replay a trace in REAL TIME through the dual-rate LiveRunner
  make-trace  synthesize a golden trace by driving a simulated car in a map
  baseline    measure the reference-faithful CPU harness on a trace
  bench       run the benchmark harness (same as `python bench.py`)
  info        inspect a map or trace file

Map resolution: `--map` accepts either a path to a ROS-style map YAML or a
bare name resolved against --map-dir (the launch file's `map_name` arg).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _resolve_map(map_arg: str, map_dir: str | None, max_range: float):
    from monte_carlo_localization_tpu.mapping import load_map

    p = Path(map_arg)
    if p.suffix in (".yaml", ".yml") and p.exists():
        return load_map(p, max_range_meters=max_range)
    if map_dir:
        candidate = Path(map_dir) / f"{map_arg}.yaml"
        if candidate.exists():
            return load_map(candidate, max_range_meters=max_range)
    raise SystemExit(f"map not found: {map_arg!r} (map_dir={map_dir!r})")


def _load_cfg(args) -> "MCLConfig":
    from monte_carlo_localization_tpu.config import MCLConfig, load_config

    cfg = load_config(args.config) if args.config else MCLConfig()
    overrides = {}
    if args.particles is not None:
        overrides["max_particles"] = args.particles
    if getattr(args, "angle_step", None) is not None:
        overrides["angle_step"] = args.angle_step
    if getattr(args, "raycast", None):
        overrides["raycast_method"] = args.raycast
    if getattr(args, "resample", None):
        overrides["resample_method"] = args.resample
    if getattr(args, "async_correction", False):
        overrides["async_correction"] = True
    if getattr(args, "live_chunk", None) is not None:
        overrides["live_chunk"] = args.live_chunk
        if args.live_chunk > 1 and not overrides.get("async_correction"):
            # chunking only exists on the async dispatch path; a bare
            # --live-chunk K unambiguously asks for it
            overrides["async_correction"] = True
    return cfg.replace(**overrides) if overrides else cfg


def cmd_make_trace(args) -> int:
    from monte_carlo_localization_tpu.runtime import synthesize_trace

    if args.duration <= 0:
        raise SystemExit("--duration must be positive")
    if args.beams <= 0:
        raise SystemExit("--beams must be positive")
    gm = _resolve_map(args.map, args.map_dir, args.max_range)
    t0 = time.perf_counter()
    trace = synthesize_trace(
        gm,
        duration_s=args.duration,
        num_beams=args.beams,
        seed=args.seed,
        speed=args.speed,
    )
    written = trace.save(args.out)
    print(
        f"wrote {written}: {trace.scan_ranges.shape[0]} scans x "
        f"{trace.num_beams} beams, {len(trace.odom_t)} odom msgs, "
        f"{trace.duration:.1f}s sim ({time.perf_counter() - t0:.1f}s wall)"
    )
    return 0


def _make_sink(path: str):
    from monte_carlo_localization_tpu.runtime import JsonlSink, NpzSink

    if path.endswith(".jsonl"):
        return JsonlSink(path)
    if path.endswith(".npz"):
        return NpzSink(path)
    raise SystemExit(f"--record-out must end in .jsonl or .npz: {path!r}")


def cmd_replay(args) -> int:
    from monte_carlo_localization_tpu.runtime import MCLNode, Trace

    gm = _resolve_map(args.map, args.map_dir, args.max_range)
    trace = Trace.load(args.trace)
    cfg = _load_cfg(args)
    log = print if args.verbose else (lambda s: None)
    node = MCLNode(gm, cfg, log=log)
    if args.record_out:
        node.add_sink(_make_sink(args.record_out))
    if args.viz_out:
        from monte_carlo_localization_tpu.runtime import VizSink

        node.add_sink(VizSink(gm, args.viz_out, every=args.viz_every))
    if args.resume_from:
        from monte_carlo_localization_tpu.runtime import load_state

        node.state, meta = load_state(args.resume_from, tracker=node.tracker)
        node.iters = int(meta.get("iters", 0))
        if meta.get("inferred_pose") is not None:
            node.inferred_pose = np.asarray(meta["inferred_pose"])
        if trace.beam_angles is not None:
            node.on_scan(trace.scan_ranges[0], beam_angles=trace.beam_angles)
    elif args.init == "truth" and trace.truth_pose is not None:
        node.initialize_pose(trace.truth_pose[0])
    elif args.init == "global":
        pass  # node starts globally initialized
    if args.profile_dir:
        from monte_carlo_localization_tpu.utils import device_trace

        with device_trace(args.profile_dir, log=log):
            res = (
                node.replay_chained(trace)
                if args.chained
                else node.replay(trace)
            )
    else:
        res = (
            node.replay_chained(trace) if args.chained else node.replay(trace)
        )
    if args.checkpoint_out:
        from monte_carlo_localization_tpu.runtime import save_state

        save_state(
            args.checkpoint_out, node.state,
            iters=node.iters, inferred_pose=node.inferred_pose,
            tracker=node.tracker,
        )
    node.close_sinks()
    out = dict(
        corrections=len(res.times),
        updates_per_sec=round(res.updates_per_sec, 2),
        rmse_xy_m=None if res.rmse_xy is None else round(res.rmse_xy, 4),
        rmse_theta_rad=None if res.rmse_theta is None else round(res.rmse_theta, 4),
        particles=cfg.max_particles,
        beams=int(np.ceil(trace.num_beams / cfg.angle_step)),
        map=gm.name,
    )
    if args.record_out:
        out["record_out"] = args.record_out
    print(json.dumps(out))
    return 0


def cmd_live(args) -> int:
    """Feed a trace through the node in REAL TIME: odometry/scans arrive at
    their recorded wall-clock rates on the main thread while the LiveRunner
    ticks at timer_frequency on its own thread — the reference's dual-rate
    process topology (SURVEY §2.1)."""
    from monte_carlo_localization_tpu.runtime import (
        LiveRunner,
        MCLNode,
        Trace,
        TraceReader,
    )

    gm = _resolve_map(args.map, args.map_dir, args.max_range)
    trace = Trace.load(args.trace)
    cfg = _load_cfg(args)
    node = MCLNode(gm, cfg, log=print if args.verbose else (lambda s: None))
    if args.record_out:
        node.add_sink(_make_sink(args.record_out))
    if getattr(args, "resume_from", None):
        from monte_carlo_localization_tpu.runtime import load_state

        node.state, meta = load_state(args.resume_from, tracker=node.tracker)
        node.iters = int(meta.get("iters", 0))
        if meta.get("inferred_pose") is not None:
            node.inferred_pose = np.asarray(meta["inferred_pose"])
        if trace.beam_angles is not None:
            node.on_scan(trace.scan_ranges[0], beam_angles=trace.beam_angles)
    elif trace.truth_pose is not None:
        node.initialize_pose(trace.truth_pose[0])

    webviz = None
    if getattr(args, "serve", None) is not None:
        from monte_carlo_localization_tpu.runtime import WebViz

        webviz = WebViz(node, gm, port=args.serve).start()
        print(f"# live viewer at {webviz.url}", flush=True)

    duration = args.duration or min(trace.duration, 10.0)
    t0 = time.monotonic()
    with LiveRunner(node) as runner:
        for ev in TraceReader(trace):
            if ev.t > duration:
                break
            lag = ev.t - (time.monotonic() - t0)
            if lag > 0:
                time.sleep(lag)
            if ev.kind == "odom":
                op, tw = trace.odom_pose[ev.index], trace.odom_twist[ev.index]
                node.on_odometry(op[0], op[1], op[2], tw[0], tw[1], stamp=ev.t)
            else:
                node.on_scan(
                    trace.scan_ranges[ev.index], beam_angles=trace.beam_angles
                )
        wall = time.monotonic() - t0
    if webviz is not None:
        webviz.close()
    if getattr(args, "checkpoint_out", None):
        from monte_carlo_localization_tpu.runtime import save_state

        save_state(
            args.checkpoint_out, node.state,
            iters=node.iters, inferred_pose=node.inferred_pose,
            tracker=node.tracker,
        )
    node.close_sinks()
    print(
        json.dumps(
            dict(
                wall_s=round(wall, 2),
                ticks=runner.ticks,
                corrections=runner.corrections,
                skipped_ticks=runner.skipped,
                tick_hz=round(runner.ticks / wall, 1),
                correction_hz=round(runner.corrections / wall, 1),
                timer_frequency=cfg.timer_frequency,
            )
        )
    )
    return 0


def cmd_baseline(args) -> int:
    from monte_carlo_localization_tpu.baseline import (
        replay_cpu_reference,
        trajectory_rmse,
    )
    from monte_carlo_localization_tpu.runtime import Trace

    gm = _resolve_map(args.map, args.map_dir, args.max_range)
    trace = Trace.load(args.trace)
    cfg = _load_cfg(args)
    times, poses, stats, ups = replay_cpu_reference(
        gm, trace, cfg, seed=0, max_corrections=args.corrections
    )
    out = dict(
        engine="cpu_reference",
        updates_per_sec=round(ups, 2),
        corrections=len(times),
        particles=cfg.max_particles,
    )
    if trace.truth_t is not None:
        rx, rt = trajectory_rmse(times, poses, trace.truth_t, trace.truth_pose)
        out["rmse_xy_m"] = round(rx, 4)
        out["rmse_theta_rad"] = round(rt, 4)
    n = max(stats.measurement_count, 1)
    out["phase_ms"] = dict(
        total=round(stats.total_mcl_time / n, 2),
        raycast=round(stats.ray_casting_time / n, 2),
        sensor=round(stats.sensor_model_time / n, 2),
        query_prep=round(stats.query_prep_time / n, 2),
        motion=round(stats.motion_model_time / n, 2),
        resample=round(stats.resampling_time / n, 2),
    )
    print(json.dumps(out))
    return 0


def cmd_info(args) -> int:
    p = Path(args.path)
    if p.suffix == ".npz":
        from monte_carlo_localization_tpu.runtime import Trace

        t = Trace.load(p)
        print(
            json.dumps(
                dict(
                    kind="trace",
                    map=t.map_name,
                    duration_s=round(t.duration, 2),
                    scans=int(t.scan_ranges.shape[0]),
                    beams=int(t.num_beams),
                    odom_msgs=int(len(t.odom_t)),
                    has_truth=t.truth_t is not None,
                )
            )
        )
    else:
        gm = _resolve_map(str(p), args.map_dir, 12.0)
        print(
            json.dumps(
                dict(
                    kind="map",
                    name=gm.name,
                    height=gm.height,
                    width=gm.width,
                    resolution=gm.resolution,
                    origin=[float(gm.origin_x), float(gm.origin_y), float(gm.origin_yaw)],
                    free_cells=gm.num_free_cells,
                    max_range_px=gm.max_range_px,
                )
            )
        )
    return 0


def cmd_export_bag(args) -> int:
    """Trace .npz -> rosbag2 directory (sqlite3 + CDR; SURVEY §4's
    rosbag-replay workflow, no ROS install needed)."""
    from monte_carlo_localization_tpu.runtime import Trace
    from monte_carlo_localization_tpu.runtime.rosbag import export_bag

    t = Trace.load(args.trace)
    out = export_bag(
        t, args.out,
        scan_topic=args.scan_topic, odom_topic=args.odom_topic,
        truth_topic=args.truth_topic, range_max=args.range_max,
    )
    print(json.dumps(dict(
        bag=str(out),
        scans=int(t.scan_ranges.shape[0]),
        odom_msgs=int(len(t.odom_t)),
        has_truth=t.truth_t is not None,
    )))
    return 0


def cmd_import_bag(args) -> int:
    """rosbag2 directory (or bare .db3) -> trace .npz for `cli replay`."""
    from monte_carlo_localization_tpu.runtime.rosbag import import_bag

    t = import_bag(
        args.bag,
        scan_topic=args.scan_topic, odom_topic=args.odom_topic,
        truth_topic=args.truth_topic, map_name=args.map_name,
    )
    p = t.save(args.out)
    print(json.dumps(dict(
        trace=str(p),
        scans=int(t.scan_ranges.shape[0]),
        beams=int(t.num_beams),
        odom_msgs=int(len(t.odom_t)),
        has_truth=t.truth_t is not None,
        duration_s=round(t.duration, 2),
    )))
    return 0


def cmd_bench(args) -> int:
    import bench as bench_mod  # repo-root bench harness

    return bench_mod.main(args.rest)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="monte_carlo_localization_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--map", required=True, help="map YAML path or name")
    common.add_argument("--map-dir", default=None)
    common.add_argument("--max-range", type=float, default=12.0)

    mt = sub.add_parser("make-trace", parents=[common])
    mt.add_argument("--out", required=True)
    mt.add_argument("--duration", type=float, default=20.0)
    mt.add_argument("--beams", type=int, default=1080)
    mt.add_argument("--speed", type=float, default=1.5)
    mt.add_argument("--seed", type=int, default=0)
    mt.set_defaults(fn=cmd_make_trace)

    rp = sub.add_parser("replay", parents=[common])
    rp.add_argument("--trace", required=True)
    rp.add_argument("--config", default=None, help="mcl_config.yaml")
    rp.add_argument("--particles", type=int, default=None)
    rp.add_argument("--angle-step", type=int, default=None, dest="angle_step")
    rp.add_argument(
        "--raycast",
        choices=["auto", "lut_pallas", "lut", "sphere", "dda"],
        default=None,
    )
    rp.add_argument(
        "--resample", choices=["systematic", "multinomial"], default=None
    )
    rp.add_argument("--init", choices=["truth", "global"], default="truth")
    rp.add_argument("--viz-out", default=None, dest="viz_out",
                    help="directory for rendered PNG frames (RViz analogue)")
    rp.add_argument("--viz-every", type=int, default=10, dest="viz_every",
                    help="render every Nth correction (default 10)")
    rp.add_argument("--record-out", default=None, dest="record_out",
                    help="stream outputs to a .jsonl or .npz sink")
    rp.add_argument(
        "--chained", action="store_true",
        help="chain corrections on-device (step_many) — throughput path; "
        "skips the dual-rate tracker and per-correction sinks",
    )
    rp.add_argument("--checkpoint-out", default=None, dest="checkpoint_out",
                    help="write the final filter/tracker state (npz)")
    rp.add_argument("--resume-from", default=None, dest="resume_from",
                    help="resume from a checkpoint instead of --init")
    rp.add_argument("--profile-dir", default=None, dest="profile_dir",
                    help="capture a jax.profiler device trace of the "
                    "replay (TensorBoard/Perfetto)")
    rp.add_argument("-v", "--verbose", action="store_true")
    rp.set_defaults(fn=cmd_replay)

    lv = sub.add_parser("live", parents=[common])
    lv.add_argument("--trace", required=True)
    lv.add_argument("--config", default=None, help="mcl_config.yaml")
    lv.add_argument("--particles", type=int, default=None)
    lv.add_argument("--angle-step", type=int, default=None, dest="angle_step")
    lv.add_argument(
        "--raycast",
        choices=["auto", "lut_pallas", "lut", "sphere", "dda"],
        default=None,
    )
    lv.add_argument("--duration", type=float, default=None,
                    help="seconds of trace to feed (default: min(trace, 10))")
    lv.add_argument("--record-out", default=None, dest="record_out")
    lv.add_argument("--async-correction", action="store_true",
                    dest="async_correction",
                    help="pipeline corrections: dispatch without blocking, "
                    "harvest poses as the device finishes")
    lv.add_argument("--live-chunk", type=int, default=None, dest="live_chunk",
                    help="with --async-correction: buffer K ticks and "
                    "dispatch them as one step_many(K) — amortizes the "
                    "per-dispatch overhead over K corrections at <= K-1 "
                    "ticks of extra pose latency (1 = off)")
    lv.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve the interactive live viewer (map + cloud "
                    "+ pose; drag to set a pose estimate, button for "
                    "global re-init — the RViz analogue) on this port "
                    "(0 = ephemeral)")
    lv.add_argument("--checkpoint-out", default=None, dest="checkpoint_out",
                    help="write the final filter/tracker state (npz) when "
                    "the live window ends")
    lv.add_argument("--resume-from", default=None, dest="resume_from",
                    help="resume the filter/tracker from a checkpoint "
                    "instead of seeding from the trace's first truth pose")
    lv.add_argument("-v", "--verbose", action="store_true")
    lv.set_defaults(fn=cmd_live, resample=None)

    bl = sub.add_parser("baseline", parents=[common])
    bl.add_argument("--trace", required=True)
    bl.add_argument("--config", default=None)
    bl.add_argument("--particles", type=int, default=None)
    bl.add_argument("--angle-step", type=int, default=None, dest="angle_step")
    bl.add_argument("--corrections", type=int, default=60,
                    help="cap on replayed corrections (timing sample size)")
    bl.set_defaults(fn=cmd_baseline, raycast=None, resample=None)

    bn = sub.add_parser("bench")
    bn.add_argument("rest", nargs=argparse.REMAINDER)
    bn.set_defaults(fn=cmd_bench)

    eb = sub.add_parser(
        "export-bag",
        help="trace .npz -> rosbag2 directory (ros2-bag-play compatible)",
    )
    eb.add_argument("--trace", required=True)
    eb.add_argument("--out", required=True, help="bag DIRECTORY to create")
    eb.add_argument("--scan-topic", default="/scan")
    eb.add_argument("--odom-topic", default="/odom")
    eb.add_argument("--truth-topic", default="/ground_truth")
    eb.add_argument("--range-max", type=float, default=30.0)
    eb.set_defaults(fn=cmd_export_bag)

    ib = sub.add_parser(
        "import-bag",
        help="rosbag2 directory/.db3 -> trace .npz (feeds `replay`)",
    )
    ib.add_argument("--bag", required=True)
    ib.add_argument("--out", required=True)
    ib.add_argument("--scan-topic", default=None,
                    help="default: first LaserScan topic in the bag")
    ib.add_argument("--odom-topic", default=None,
                    help="default: first Odometry topic in the bag")
    ib.add_argument("--truth-topic", default=None,
                    help="default: second Odometry topic if present")
    ib.add_argument("--map-name", default="")
    ib.set_defaults(fn=cmd_import_bag)

    inf = sub.add_parser("info")
    inf.add_argument("path")
    inf.add_argument("--map-dir", default=None)
    inf.set_defaults(fn=cmd_info)

    return ap


def main(argv=None) -> int:
    # persist compiles across CLI invocations (big-map LUT builder
    # programs take a while to compile cold)
    from monte_carlo_localization_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
