"""One run of one cell: set-up and warm-up, the measured window, the traced
segment (`--trace 1`), the check against the reference, the result line.

    python3 pigobench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the system under test from the configuration's cascades and
the traffic's frame pool, then runs the cell's own traffic: the first
answer (which builds the kernels), then the mix's `warmup_s` seconds, so
that every shape the window uses is built and warm and the rate has
settled. The window follows in the same loop, with nothing in
between, for `--seconds`; `setup_s` runs from the start of run.py to the
window's first frame. With `--trace 1` the window runs alike, then the
mix's `trace_frames` more requests run under torch.profiler. Once the
window has closed and the memory peak is read, the program's state is
freed and the reference works out the answers it judges the run by
(lib/check.py). The result is the last line of standard output; standard
error ends with each number compared beside its limit.

`--device cpu` runs the program's plain kernels on the host, for the
harness's own tests; it prints no device metric. `--control <precision>`
puts the reference in the program's place (lib/control.py); the
benchmark's own runs never pass it.

No result is printed while a module of JAX or of the JAX package is
loaded: the check runs last, after the reference and every metric reader.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time

from pigobench.lib import card, check, frames, imports, manifest, program
from pigobench.lib import trace as trace_lib

EXIT_USAGE, EXIT_NO_CARD, EXIT_NO_PROGRAM, EXIT_FORBIDDEN = 2, 3, 4, 5
FIRST_ANSWER_S = 600  # the most the first answer (and the build) may take


@dataclasses.dataclass
class Ctx:
    """What a driver and a metric reader see."""

    root: str
    cell: manifest.Cell
    seed: int
    seconds: float
    device: str
    t_start: float
    control: str = ""
    kind: str = ""
    cascades: dict | None = None
    pool: object = None
    order: object = None
    setup_s: float = 0.0
    stamps: dict = dataclasses.field(default_factory=dict)
    window: dict | None = None
    trace: dict | None = None
    work: dict | None = None
    faces_per_frame: list | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--control", choices=("float32", "bfloat16"), default="")
    return p.parse_args(argv)


def fail(code: int, msg: str) -> int:
    print(f"pigobench: {msg}", file=sys.stderr)
    return code


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        cell = manifest.Cell(args.workload)
    except (KeyError, OSError) as exc:
        return fail(EXIT_USAGE, f"cannot resolve the cell: {exc}")
    build = os.path.join(manifest.ROOT, "build", "pigobench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    stamps = {"start": t_start, "imports": time.perf_counter()}
    import torch

    if args.device == "cuda" and (not torch.cuda.is_available() or
                                  torch.cuda.device_count() < cell.chips):
        return fail(EXIT_NO_CARD, f"the cell needs {cell.chips} CUDA "
                    f"card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import pigo_tpu_torch  # noqa: F401  the system under test
    except ImportError as exc:
        return fail(EXIT_NO_PROGRAM, f"the program is missing: {exc}")
    stamps["program"] = time.perf_counter()
    ctx = Ctx(manifest.ROOT, cell, args.seed, args.seconds, args.device,
              t_start, args.control, stamps=stamps)
    ctx.kind = (torch.cuda.get_device_name(0) if args.device == "cuda"
                else "cpu")
    if args.device == "cuda":
        print(f"card: {card.describe()}", file=sys.stderr)
    stamps["card"] = time.perf_counter()
    ctx.cascades = program.load_cascades(ctx.root, ctx.config)
    ctx.pool = frames.make_pool(ctx.root, ctx.config, ctx.traffic["pool"])
    ctx.order = frames.Order(ctx.seed, len(ctx.pool))
    stamps["inputs"] = time.perf_counter()
    driver = cell.driver()
    sut = driver.build(ctx)
    stamps["built"] = time.perf_counter()
    served = window(ctx, driver, sut)
    peak = (torch.cuda.max_memory_allocated(0) if args.device == "cuda"
            else 0)
    if args.trace:
        ctx.trace = traced(ctx, driver, sut, served["next"])
    del sut
    gc.collect()
    if args.device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, n_checked = judge(ctx, served)
    ref_s = time.perf_counter() - t_ref
    metrics = {}
    for e in (cell.per_layer if args.trace else cell.end_to_end):
        value = cell.metric(e["name"]).read(ctx)
        if value is not None:
            metrics[e["name"]] = {"value": value, "unit": e["unit"]}
    device = {"platform": "gpu" if args.device == "cuda" else "cpu",
              "kind": ctx.kind, "count": cell.chips,
              "memory_peak_bytes": peak}
    w = ctx.window
    print("compared: " + json.dumps({
        "answers": w["answers"], "checked": n_checked,
        "pool_frames": len(ctx.pool), "faces_per_frame": ctx.faces_per_frame,
        "setup_s": ctx.setup_s, "setup_parts": setup_parts(ctx.stamps),
        "reference_s": ref_s, "rates": w["rates"],
        "warm_rates": w["warm_rates"], "clocks": w["clocks"]}),
        file=sys.stderr)
    result = {"correct": check.passed(numbers),
              "attempted": w["answers"] + served["missing"],
              "failed": served["missing"], "metrics": metrics,
              "device": device}
    if ctx.trace is not None:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = ctx.trace["breakdown"]
    result["checks"] = check.report(numbers)
    bad = imports.loaded_forbidden()
    if bad:
        return fail(EXIT_FORBIDDEN, "modules of JAX or the JAX package are "
                    f"loaded: {', '.join(bad)}")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def setup_parts(stamps: dict) -> dict:
    """Seconds of each part of set-up, from the stamps taken in order: the
    harness's imports (torch among them), importing the program, the
    card's name and power limit, the cascades and the frame pool, building
    the system under test (the card's context and the uploads), the first
    answer (which loads or builds the kernels), the warm-up."""
    names = list(stamps)
    return {b: round(stamps[b] - stamps[a], 4)
            for a, b in zip(names, names[1:])}


def window(ctx: Ctx, driver, sut) -> dict:
    """Warm-up and window in one loop of the cell's traffic. Keeps each
    window answer's faces, the whole answers check.Keep picks, each
    call's seconds (drivers that time calls) and the answer times."""
    tr = ctx.traffic
    keep = check.Keep(ctx.seed, tr["check"]["keep_share"])
    faces, kept, lat, times, warm = [], {}, [], [], []
    faces_of = check.faces_of
    clock = time.perf_counter
    inf = float("inf")
    # the warm-up's clock starts at the first answer, once the first call
    # has built the kernels
    t_w0 = t_stop = inf

    def on_answer(i, res, t_call, t_ans):
        nonlocal t_w0, t_stop
        if t_w0 == inf:
            ctx.stamps["first_answer"] = t_ans
            t_w0 = t_ans + tr["warmup_s"]
            t_stop = t_w0 + ctx.seconds
        if t_ans < t_w0:
            warm.append(t_ans)
            return
        times.append(t_ans)
        faces.append((i, faces_of(res)))
        if t_call is not None:
            lat.append(t_ans - t_call)
        if keep(i) or not kept:  # the window's first answer, and a share
            kept[i] = res

    sampler = card.ClockSampler()
    try:
        t_limit = clock() + FIRST_ANSWER_S
        nxt = driver.serve(ctx, sut, 0, lambda i, now: now < min(
            t_stop, t_limit if t_w0 == inf else inf),
                           on_answer, lambda name: contextlib.nullcontext())
    finally:
        clocks = sampler.stop()
    ctx.setup_s = t_w0 - ctx.t_start
    ctx.stamps["warm_up"] = t_w0
    span = (times[-1] - t_w0) if times else float("nan")
    tenth = ctx.seconds / 10
    buckets = [0] * 10
    for t in times:
        buckets[min(9, int((t - t_w0) / tenth))] += 1
    t_first = warm[0] if warm else t_w0
    warm_buckets = [0] * max(1, int(tr["warmup_s"]))
    for t in warm:
        warm_buckets[min(len(warm_buckets) - 1, int(t - t_first))] += 1
    ctx.window = {"answers": len(times), "seconds": span, "latencies": lat,
                  "rates": [round(b / tenth, 2) for b in buckets],
                  "warm_rates": warm_buckets,
                  "clocks": card.clock_summary(clocks)}
    return {"next": nxt, "missing": nxt - len(times) - len(warm),
            "faces": faces, "kept": kept}


def traced(ctx: Ctx, driver, sut, first: int) -> dict:
    """The mix's trace_frames requests after the window, under the
    profiler, reduced (lib/trace.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    n = int(ctx.traffic["trace_frames"])
    acts = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    got = []
    spans = ("harness.traced", "detector.detect",
             "detector.detect_stream_device")
    with profile(activities=acts) as prof:
        with record_function("harness.traced"):
            driver.serve(ctx, sut, first, lambda i, now: i < first + n,
                         lambda i, res, t0, t1: got.append(i),
                         record_function)
            if ctx.device == "cuda":
                torch.cuda.synchronize()
    if len(got) != n:
        raise RuntimeError(f"the traced segment answered {len(got)} of {n}")
    events = prof.events()
    outer = [e for e in events if e.name == "harness.traced"][0]
    out = trace_lib.reduce(events, outer.time_range.start,
                           outer.time_range.end, spans, n)
    out["first"] = first
    return out


def judge(ctx: Ctx, served: dict) -> dict:
    """The reference's answers and the numbers compared (lib/check.py);
    with a trace, also the work counts of the traced requests."""
    import torch

    from pigobench.reference import pico

    c, p = ctx.cascades, ctx.config["params"]
    names = sorted(c["landmarks"])
    ref = pico.Pipeline(
        pico.face_forest(c["face"]), pico.walk_forest([c["pupil"]]),
        pico.walk_forest([c["landmarks"][n] for n in names]), names,
        **p, acc=torch.float32, device=ctx.device)
    tr = ctx.trace is not None
    checked = check.sample(ctx.seed, served["kept"],
                           ctx.traffic["check"]["sample"])
    idx = (list(range(ctx.trace["first"], ctx.trace["first"]
                      + ctx.trace["frames"])) if tr else [])
    used = sorted({ctx.order[i] for i, _ in served["faces"]}
                  | {ctx.order[i] for i in checked + idx})
    got, counts = ref.faces(ctx.pool[used], work=tr)
    by_frame = dict(zip(used, got))
    ctx.faces_per_frame = sorted({len(f) for f in got})
    if tr:
        counts = dict(zip(used, counts))
    answers = ref.answers(ctx.pool, check.requests(ctx.seed, ctx.order,
                                                   checked), faces=by_frame)
    numbers = check.compare(by_frame, served["faces"], served["kept"],
                            checked, answers, ctx.order, served["missing"])
    if tr:
        _, walks = ref.answers(ctx.pool, check.requests(
            ctx.seed, ctx.order, idx), faces=by_frame, work=True)
        ctx.work = {
            "face": [counts[ctx.order[i]] for i in idx], "walks": walks,
            "face_depth": ref.face.depth,
            "pupil": (ref.pupil.stages, ref.pupil.trees, ref.pupil.depth),
            "landmarks": (ref.landmarks.stages, ref.landmarks.trees,
                          ref.landmarks.depth)}
    return numbers, len(checked)
