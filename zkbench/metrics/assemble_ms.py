"""assemble_ms: the host assembly of A, B and C with r and s
(``prove_lm._assemble``), in ms a proof (program spans)."""

from zkb.trace import per_proof_ms

PHASES = ("assemble",)


def read(run):
    return per_proof_ms(run, lambda name: name in PHASES)
