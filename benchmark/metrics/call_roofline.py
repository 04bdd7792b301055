"""call_roofline (device trace): the least time the card could take for one
call's work (``benchmark/work.py``: the longer of its bytes at the HBM peak
and its operations at the f32 peak, ``benchmark/peaks.py``) over the
device's busy time a call in the traced window (rank 0's, with its share of
the work on several ranks). It reads the same work whatever kernels
implement it. Percent."""

from benchmark import peaks


def read(run):
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0 or not tr["calls"]:
        return None
    least = peaks.least_seconds(run.work.flops, run.work.bytes)
    return 100.0 * least / (tr["busy_s"] / tr["calls"])
