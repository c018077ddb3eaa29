"""proofs_per_s: the proofs of every request the window completed over the
window's seconds, from its opening to the last request's return (host
clock; closed loop of batches): what a batch prover pays for."""


def read(run):
    return run.proofs / run.window_s if run.window_s > 0 else None
