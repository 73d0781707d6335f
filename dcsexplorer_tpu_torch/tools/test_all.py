"""Corpus validation driver.

Counterpart of the reference's test harness (reference:
DCSDecoder/Tests/test-all.bat + Tests/README.md): run the lockstep
--validate sweep over every ROM zip in a directory, write a per-ROM log,
and drop `.success` / `.diff` markers next to it.  Point it at a directory
of PinMame ROM zips (not redistributable, so not included here; synthetic
zips from the compiler work too).

Usage:
  python -m dcsexplorer_tpu_torch.tools.test_all ROMS_DIR [RESULTS_DIR]
      [--vol N] [--max-track-frames N] [--device cuda|cpu]
  python -m dcsexplorer_tpu_torch.tools.test_all ROMS_DIR --versions

--versions dumps the detected hardware/software version of every ROM
instead of validating (counterpart of the reference's all-versions.bat).

The port's copy of ``dcsexplorer_tpu/tools/test_all.py``, over the port's
``tools/explorer`` (``cmd_validate``, ``load_rom``).  The device side of
each validation runs on ``--device``: ``cuda`` (the default) is the card's
session kernels (``decode94_bank``, ``session_mix94`` and the carried-state
``transform94_pcm`` for 1994+ ROMs, the carried-state ``decode93_pcm`` for
1993 ROMs), held against the port's scalar ``ReferenceDecoder``; without a
card the tool validates nothing and exits 2.  ``cpu`` runs the kernels'
plain PyTorch versions.
"""

import argparse
import glob
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dcs-test-all",
        description="lockstep-validate every ROM zip in a directory")
    p.add_argument("roms_dir")
    p.add_argument("results_dir", nargs="?", default="results")
    p.add_argument("--vol", type=int, default=220,
                   help="master volume (the reference harness uses 220)")
    p.add_argument("--max-track-frames", type=int, default=4000)
    p.add_argument("--versions", action="store_true",
                   help="print each ROM's detected version instead of "
                        "validating (reference: Tests/all-versions.bat)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the device side of the validation runs "
                        "(default: the CUDA card; cpu = the kernels' plain "
                        "PyTorch versions)")
    args = p.parse_args(argv)

    from .explorer import cmd_validate, load_rom
    os.makedirs(args.results_dir, exist_ok=True)
    zips = sorted(glob.glob(os.path.join(args.roms_dir, "*.zip")))
    if not zips:
        print(f"no ROM zips found in {args.roms_dir}", file=sys.stderr)
        return 2

    if args.versions:
        for path in zips:
            name = os.path.splitext(os.path.basename(path))[0]
            try:
                rs, _, status = load_rom(path)
                from ..rom.image import game_title
                info = rs.version_info()
                game = game_title(rs.game_id) if rs.game_id else ""
                extra = f"  [{game}]" if game else ""
                flag = "" if status == 1 else f"  (POST code {status})"
                print(f"{name}: {info}{extra}{flag}")
            except Exception as e:
                print(f"{name}: ERROR {e}")
        return 0

    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("error: no CUDA device (--device cpu runs the device "
                  "pipeline on the host)", file=sys.stderr)
            return 2

    n_ok = 0
    for path in zips:
        name = os.path.splitext(os.path.basename(path))[0]
        log = os.path.join(args.results_dir, f"{name}.log")
        for marker in (".success", ".diff"):
            try:
                os.remove(os.path.join(args.results_dir, name + marker))
            except FileNotFoundError:
                pass
        try:
            rs, _, status = load_rom(path)
            if status != 1:
                raise ValueError(f"ROM failed POST checks (code {status})")
            rc = cmd_validate(rs, args.vol, args.max_track_frames,
                              log_path=log, device=args.device)
        except Exception as e:
            rc = 1
            with open(log, "w") as f:
                f.write(f"Validation FAILED: {e}\n")
        marker = ".success" if rc == 0 else ".diff"
        open(os.path.join(args.results_dir, name + marker), "w").close()
        print(f"{name}: {'Validation Succeeded' if rc == 0 else 'FAILED'}")
        n_ok += (rc == 0)
    print(f"{n_ok}/{len(zips)} ROMs validated successfully")
    return 0 if n_ok == len(zips) else 1


if __name__ == "__main__":
    sys.exit(main())
