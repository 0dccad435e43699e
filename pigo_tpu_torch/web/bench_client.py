"""Load client for the web server's /detect endpoint (pigo_tpu_torch.web.main).

A copy of the JAX package's examples/web/bench_client.py: encode a
640x480 frame as JPEG once, then POST it repeatedly with `--concurrency`
requests in flight (the browser page keeps 3, web/main.py's PAGE) and
report the served frames per second, and beside them each request's
latency (best, median, p90). `run_engine` puts the same load on an engine
in this process, and `match_once` holds a run's answers to the
references of the requests it made. Needs Pillow and the standard library
only.

    # in one shell (the card; --device cpu runs the plain versions):
    python -m pigo_tpu_torch.web.main --port 5000
    # in another:
    python -m pigo_tpu_torch.web.bench_client --frames 200 --concurrency 3
"""

from __future__ import annotations

import argparse
import io
import math
import os
import sys
import threading
import time
import urllib.request

SAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "assets", "testdata", "sample.jpg")


def post(url: str, payload: bytes, timeout: float = 300.0) -> bytes:
    req = urllib.request.Request(url, data=payload, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310
        return resp.read()


def run(url: str, payload: bytes, frames: int, concurrency: int):
    """POST `payload` `frames` times from `concurrency` threads, each
    sending its next request when its last one is answered: (the response
    bodies, each request's seconds, the whole run's seconds). A request
    that fails raises here after every thread has ended."""
    bodies: list[bytes] = []
    seconds: list[float] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def worker(budget):
        try:
            for _ in range(budget):
                t0 = time.perf_counter()
                body = post(url, payload)
                dt = time.perf_counter() - t0
                with lock:
                    bodies.append(body)
                    seconds.append(dt)
        except Exception as exc:  # handed to the caller below
            with lock:
                errors.append(exc)

    threads = [threading.Thread(
        target=worker,
        args=(frames // concurrency + (t < frames % concurrency),))
        for t in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    total = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return bodies, seconds, total


def run_engine(engine, plans, timeout: float = 600.0, **cfg):
    """Each plan, a list of (kind, BGR frame), sent to `engine.detect(frame,
    **cfg)` by a thread of its own, each request when its caller's last
    one is answered: ([(kind, results, seconds)] in the order they were
    answered, the whole run's seconds). A request that fails raises here
    after every thread has ended; a caller still waiting after `timeout`
    seconds raises TimeoutError."""
    answers: list[tuple] = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def caller(plan):
        try:
            for kind, frame in plan:
                t0 = time.perf_counter()
                got = engine.detect(frame, **cfg)
                dt = time.perf_counter() - t0
                with lock:
                    answers.append((kind, got, dt))
        except Exception as exc:  # handed to the caller below
            with lock:
                errors.append(exc)

    threads = [threading.Thread(target=caller, args=(p,)) for p in plans]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    deadline = t0 + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
        if t.is_alive():
            raise TimeoutError(f"an engine caller waited over {timeout} s")
    total = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return answers, total


def match_once(answers, refs) -> bool:
    """True when each (kind, results, ...) answer can take a request index
    i of its own, with refs[kind][i] == results exactly: a bipartite
    matching by augmenting paths. refs[kind] lists the expected results by
    request index (None where no request of that kind can be)."""
    index: dict[tuple, list[int]] = {}  # (kind, repr of results) -> i
    for kind, wants in refs.items():
        for i, want in enumerate(wants):
            if want is not None:
                index.setdefault((kind, repr(want)), []).append(i)
    cands = [index.get((kind, repr(got)), []) for kind, got, *_ in answers]
    owner: dict[int, int] = {}

    def place(a, seen):
        for i in cands[a]:  # a free index first: no search when there is one
            if i not in owner:
                owner[i] = a
                return True
        for i in cands[a]:
            if i not in seen:
                seen.add(i)
                if place(owner[i], seen):
                    owner[i] = a
                    return True
        return False

    return all(place(a, set()) for a in range(len(answers)))


def latency_ms(seconds: list[float]) -> dict:
    """Best, median and p90 (nearest rank) of request times, in ms."""
    ms = sorted(s * 1e3 for s in seconds)
    return {"best_ms": ms[0], "median_ms": ms[len(ms) // 2],
            "p90_ms": ms[math.ceil(0.9 * len(ms)) - 1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--url", default="http://localhost:5000/detect")
    p.add_argument("--image", default=SAMPLE)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--concurrency", type=int, default=3)
    args = p.parse_args(argv)

    from PIL import Image

    img = Image.open(args.image).convert("RGB").resize((640, 480))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=70)
    payload = buf.getvalue()

    first = post(args.url, payload)  # warm-up: the server's first plans
    print(f"first response: {first[:120].decode()}", file=sys.stderr)

    bodies, seconds, total = run(args.url, payload, args.frames,
                                 args.concurrency)
    lat = latency_ms(seconds)
    print(f"{len(bodies)} frames in {total:.2f}s -> "
          f"{len(bodies) / total:.1f} fps (concurrency {args.concurrency}, "
          f"640x480); latency best {lat['best_ms']:.2f} ms, median "
          f"{lat['median_ms']:.2f} ms, p90 {lat['p90_ms']:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
