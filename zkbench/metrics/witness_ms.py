"""witness_ms: the host witness, the native CSR matrix evaluations
(``groth16._matrix_evals_native``) and the witness planes
(``prove_lm._z_rows16``), in ms a proof (program spans)."""

from zkb.trace import per_proof_ms

PHASES = ("matrix_evals", "witness_planes")


def read(run):
    return per_proof_ms(run, lambda name: name in PHASES)
