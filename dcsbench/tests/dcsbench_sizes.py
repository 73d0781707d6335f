"""Small sizes of the four cells that a CPU test run holds: the same code
paths, a copy of each stream and two sessions' worth of frames."""

CATALOG94 = dict(overrides={"variants": 2}, config_overrides={
    "catalog": [{"streams": [["music_a.dcs94", 1], ["music_b.dcs94", 1]]}]})
CATALOG93 = dict(overrides={"variants": 2}, config_overrides={
    "catalog": [{"t1": False, "streams": [["music_a.dcs93b", 1],
                                          ["music_b.dcs93a", 1]]},
                {"t1": True, "streams": [["dense_t1.dcs93a1", 1],
                                         ["dense_t1b.dcs93a1", 1]]}]})
SESSIONS = dict(overrides={"sessions": 4, "frames": 300, "batches": 2,
                           "check_sessions": 3})
CELLS = {"os94.catalog": CATALOG94, "os93.catalog": CATALOG93,
         "os94.sessions": SESSIONS, "os93.sessions": SESSIONS}
