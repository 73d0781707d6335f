"""Real-time playback pacing and audio sinks.

Counterpart of the reference's platform layer (SimpleWindowsAudio's blocking
ring buffer + idle task, HiResTimer's precise sleeps — reference:
SimpleWindowsAudio/SimpleWindowsAudio.h:36-71, HiResTimer/HiResTimer.h:16-56).
This environment has no audio device, so the player paces decode against a
monotonic clock and delivers samples to a pluggable sink (WAV file, memory,
or a callback); the idle-task hook runs whenever the pacer would block,
exactly like the reference's idle task.

The port's copy of ``dcsexplorer_tpu/utils/player.py``: ``WavSink`` writes
through the port's ``utils/audioio.write_wav``; the explorer's interactive
mode renders into ``MemorySink``.
"""

import time

import numpy as np

from ..format.tables import SAMPLE_RATE


class HiResTimer:
    """Monotonic timing + precise sleep (QPC-wrapper counterpart)."""

    @staticmethod
    def now():
        return time.perf_counter()

    @staticmethod
    def sleep_for(seconds):
        if seconds > 0:
            time.sleep(seconds)

    @staticmethod
    def sleep_until(deadline):
        HiResTimer.sleep_for(deadline - time.perf_counter())


class MemorySink:
    def __init__(self):
        self.chunks = []

    def write(self, pcm):
        self.chunks.append(np.asarray(pcm, dtype=np.int16))

    def data(self):
        return (np.concatenate(self.chunks)
                if self.chunks else np.zeros(0, np.int16))


class WavSink:
    def __init__(self, path):
        self.path = path
        self.sink = MemorySink()

    def write(self, pcm):
        self.sink.write(pcm)

    def close(self):
        from .audioio import write_wav
        write_wav(self.path, self.sink.data())


class Player:
    """Paced sample pump: pulls from a decoder, pushes to a sink in real
    time (or faster with pace=None), running the idle task while ahead."""

    def __init__(self, sample_source, sink, chunk=240, pace=True,
                 idle_task=None, sleep_floor=0.002):
        self.source = sample_source        # callable(n) -> int16 array/list
        self.sink = sink
        self.chunk = chunk
        self.pace = pace
        self.idle_task = idle_task
        self.sleep_floor = sleep_floor
        self.slept = 0.0                   # GetSleepTime() counterpart

    def run(self, n_samples):
        start = HiResTimer.now()
        produced = 0
        while produced < n_samples:
            n = min(self.chunk, n_samples - produced)
            self.sink.write(self.source(n))
            produced += n
            if self.pace:
                deadline = start + produced / SAMPLE_RATE
                while True:
                    ahead = deadline - HiResTimer.now()
                    if ahead <= 0:
                        break
                    if self.idle_task is not None:
                        self.idle_task()
                    wait = min(ahead, self.sleep_floor)
                    HiResTimer.sleep_for(wait)
                    self.slept += wait
        return produced
