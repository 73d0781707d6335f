"""dcsexplorer_tpu_torch — the DCS device decode path in PyTorch + CUDA.

A second package beside ``dcsexplorer_tpu`` (the JAX reference).  It imports
torch and numpy, never jax and nothing of the reference package: the host
code it needs is its own copy, in the reference's layout.

- ``format``  — the codec's constant tables.
- ``refdec``  — the scalar reference decoder, the ground truth of the checks.
- ``native``  — the C++ host runtime (stream indexer, VM tracer), built with
                g++ at first use and bound with ctypes; ``vm`` wraps the
                tracer.
- ``ops``     — the stream prescan; fixed-point numerics, band controls,
                symbol decode, dequant/mix, inverse transform: plain
                PyTorch versions beside hand-written CUDA kernels
                (``csrc/``, built with nvcc and bound with ctypes by
                ``ops/kernels.py``).
- ``models``  — the flat 1994+ catalog sweep (host ``FlatSweep`` packing and
                the ``FlatPipeline`` device module).
- ``encoder`` — the encoders: the host's analysis and per-stream setup,
                the 1994+ format search on the device (``device94``:
                ``DeviceEncoder94``, ``encode_batch``,
                ``encode_files_device``), the host's ``encode_pcm`` of
                every family (the 1993 one in ``encoder93``).
- ``compiler`` — the ROM compiler: a script and its audio to a ROM zip
                (``script.compile_script_file``), the 1994+ streams encoded
                in batches on the device.
- ``tools``   — the explorer CLI (``python -m
                dcsexplorer_tpu_torch.tools.explorer ROM.zip``), the
                encoder CLI (``python -m
                dcsexplorer_tpu_torch.tools.encoder_cli``), the corpus
                validator (``test_all``) and the bench-asset generator
                (``make_bench_assets``).
- ``utils``   — audio I/O, the player, profiling, and decoder checkpoints
                (``state``).

Values follow the reference's u16-in-int32 storage convention throughout.
"""

__version__ = "0.1.0"
