"""prove_s: the window's seconds, from its opening to the last request's
return, over the proofs it completed one at a time (host clock; closed
loop of single proofs): what a member waits for a proof."""


def read(run):
    return run.window_s / run.proofs if run.proofs else None
