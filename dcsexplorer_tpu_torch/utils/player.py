"""Audio sinks.

The port's copy of ``MemorySink`` from ``dcsexplorer_tpu/utils/player.py``,
which the explorer's interactive mode renders into.  The real-time
``Player``, its ``HiResTimer`` and the ``WavSink`` have no caller in the
port.
"""

import numpy as np


class MemorySink:
    def __init__(self):
        self.chunks = []

    def write(self, pcm):
        self.chunks.append(np.asarray(pcm, dtype=np.int16))

    def data(self):
        return (np.concatenate(self.chunks)
                if self.chunks else np.zeros(0, np.int16))
