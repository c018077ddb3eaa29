"""msm_roofline: the MSM problem's least time (``zkb.peaks``: the larger of
its IMADs over 16.75e12 IMAD/s and its bytes over 3.35e12 B/s, counted from
the key's query sizes) over the card's busy time inside the MSM phases'
spans, in %, whatever kernels run there (device trace)."""

from zkb.trace import busy_in


def read(run):
    t = run.trace
    if not t or not run.proofs:
        return None
    windows = [(s, e) for name, s, e in t["spans"] if name.startswith(("g1_", "g2_"))]
    busy = busy_in(t["device"], windows)
    return 100.0 * run.msm_least_s * run.proofs / busy if busy > 0 else None
