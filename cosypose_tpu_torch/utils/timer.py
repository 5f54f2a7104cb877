"""Pause/resume wall timer that splits a pipeline's stage times (port of
cosypose_tpu/utils/timer.py; the RANSAC and bundle adjustment stages use it).

It reads the host clock: a caller timing work on the card synchronizes
before pausing."""

from __future__ import annotations

import datetime
import time


class Timer:
    def __init__(self):
        self.start_time = None
        self.elapsed = 0.0
        self.is_running = False

    def reset(self):
        self.start_time = None
        self.elapsed = 0.0
        self.is_running = False
        return self

    def start(self):
        self.elapsed = 0.0
        return self.resume()

    def pause(self):
        if self.is_running:
            self.elapsed += time.perf_counter() - self.start_time
            self.is_running = False
        return self

    def resume(self):
        self.is_running = True
        self.start_time = time.perf_counter()
        return self

    def stop(self) -> datetime.timedelta:
        self.pause()
        return datetime.timedelta(seconds=self.elapsed)
