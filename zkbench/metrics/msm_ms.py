"""msm_ms: the MSMs (K1 and the finish, every g1_* and g2_* phase), in ms a
proof (program spans)."""

from zkb.trace import per_proof_ms


def read(run):
    return per_proof_ms(run, lambda name: name.startswith(("g1_", "g2_")))
