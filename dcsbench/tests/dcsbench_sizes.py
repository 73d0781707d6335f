"""Small sizes of the benchmark's cells that a CPU test run holds: the same
code paths, by the configuration and the traffic's kind.  A catalog plays
one copy of each stream of its configuration's sweeps; sessions keep the
traffic's shape at four sessions of 300 frames.  ``CELLS`` holds every
cell of ``BENCHMARK.json`` with its sizes, ``FAMILY_KIND`` its
configuration's family and its traffic's kind."""

import os

from dcsbench import harness

SESSIONS = dict(overrides={"sessions": 4, "frames": 300, "batches": 2,
                           "check_sessions": 3})


def sizes(config, kind):
    """{overrides, config_overrides} of a cell at small size."""
    if kind == "sessions":
        return SESSIONS
    if kind == "catalog":
        return dict(overrides={"variants": 2}, config_overrides={
            "catalog": [dict(sweep, streams=[[n, 1] for n, _ in
                                             sweep["streams"]])
                        for sweep in config["catalog"]]})
    raise ValueError(f"no small size for traffic of kind {kind!r}")


def cells():
    """({cell: sizes}, {cell: (family, kind)}) of every cell of
    ``BENCHMARK.json``."""
    root = harness.ROOT
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    files = {c["name"]: c["file"] for c in bench["configs"]}
    small, family_kind = {}, {}
    for w in bench["workloads"]:
        config = harness.load_json(os.path.join(root, files[w["config"]]))
        kind = harness.load_json(os.path.join(
            harness.HERE, "traffic", f"{w['traffic']}.json"))["kind"]
        small[w["name"]] = sizes(config, kind)
        family_kind[w["name"]] = (config["family"], kind)
    return small, family_kind


CELLS, FAMILY_KIND = cells()
