"""device_idle: the share of the traced window in which no operation ran on
the card, in % (device trace)."""

from zkb.trace import busy


def read(run):
    t = run.trace
    if not t or not t["window"] or not t["device"]:
        return None
    lo, hi = t["window"]
    return 100.0 * (1.0 - busy(t["device"], lo, hi) / (hi - lo))
