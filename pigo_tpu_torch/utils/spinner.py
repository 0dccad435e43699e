"""Progress spinner (reference utils/progress.go:15-107).

A braille spinner on stderr while long work runs, started/stopped exactly
like the reference's `NewSpinner/Start/Stop`; no-op when stderr is not a
terminal (pipelines, tests, CI).
"""

from __future__ import annotations

import sys
import threading

FRAMES = "⣾⣽⣻⢿⡿⣟⣯⣷"


class Spinner:
    def __init__(self, message: str = "Processing...", interval: float = 0.1):
        self.message = message
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self):
        i = 0
        while not self._stop.is_set():
            sys.stderr.write(f"\r{FRAMES[i % len(FRAMES)]} {self.message}")
            sys.stderr.flush()
            i += 1
            self._stop.wait(self.interval)
        sys.stderr.write("\r" + " " * (len(self.message) + 2) + "\r")
        sys.stderr.flush()

    def start(self):
        if self._thread is not None or not sys.stderr.isatty():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
