"""The share of the profiled rounds' wall time in which no kernel or copy
ran on the card, in percent: 1 - busy / wall, busy the union of the
device's intervals in the trace."""


def read(run):
    p = run.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
