"""Device selection for the port's entry points, and the card's clock.

Entry points run on the CUDA card unless the caller passes device="cpu".
With no device given and no card present they raise: the port never
carries on silently on the CPU. `card_description` and `cuda_ms` serve
the measurements (chip_smoke.py, pigo_tpu_torch/tools/face_sweep.py).
"""

from __future__ import annotations

import subprocess
import time

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch version on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device "
                               "is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def card_description() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (first card only), for printing beside measured numbers."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, from CUDA
    events around the whole run, after two warm-up calls (the second
    timed on the host).

    queue_ahead: first occupy the stream with a sleep kernel long enough
    for the host to enqueue every call, so that the events time the
    kernels back to back on the device and not the host's launch rate (a
    walk launch runs for tens of microseconds, about what the host takes
    to issue one)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        # 2e9 cycles a second bounds the SM clock from above, so the sleep
        # lasts at least twice the host's enqueue time (capped near 1 s)
        torch.cuda._sleep(int(min(2e9 * 2 * reps * host_s, 2e9)) + 1)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
