"""The correctness check's control: the plain reference put in the
program's place with one guarantee of the configurations broken, which the
check has to call not correct.

The configurations guarantee PCM bit-exact with the ADSP-2105's 16-bit
fixed-point arithmetic.  The control computes the reference's transforms
with the MAC's rounding made ordinary (round half up; the ADSP clears bit
16 when the product's low word is exactly $8000, the convergent-rounding
quirk), the step a faster port would be tempted to take.  For each seed it
runs the cell's set-up (the program's packing or traced wires), then takes
one job a variant or batch from the control in the program's place and
counts the mismatches as a run does.

    python3 dcsbench/control.py --workload os94.catalog --seeds 1,2,3

prints one JSON line a seed, {"seed", "mismatches", "limit", "checked"};
the benchmark's runs never run it.
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def ordinary_rounding():
    """The reference's MAC rounding without the convergent quirk."""
    from dcsbench.reference import fixmath, transform

    def mac_round_half_up(acc, p_b):
        return fixmath.s16(((acc << 1) + 0x8000) >> 16)

    saved = fixmath.mac_round, transform.mac_round
    fixmath.mac_round = transform.mac_round = mac_round_half_up
    try:
        yield
    finally:
        fixmath.mac_round, transform.mac_round = saved


def control_readings(workload, seeds, device, overrides=None,
                     config_overrides=None):
    """[(seed, mismatches, what was compared)] of the control."""
    import torch
    from dcsbench import harness
    from dcsbench.reference.cache import IndexCache
    _, _, config, traffic = harness.load_spec(
        workload, overrides=overrides, config_overrides=config_overrides)
    harness.check_data()
    device = torch.device(device)
    cache = IndexCache()
    out = []
    for seed in seeds:
        jobs = harness.KINDS[traffic["kind"]](
            config, traffic, seed, device,
            os.path.join(harness.HERE, "data"))
        with ordinary_rounding():
            history = jobs.control_history(device, cache)
        jobs.release()
        mismatches, _, checked = jobs.check(history, device, cache)
        out.append((seed, mismatches, checked))
        del jobs
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, three or more")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from dcsbench import harness
    for seed, n, checked in control_readings(
            args.workload, [int(s) for s in args.seeds.split(",")],
            args.device):
        print(json.dumps(dict(seed=seed, mismatches=n,
                              limit=harness.MISMATCH_LIMIT,
                              checked=checked)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
