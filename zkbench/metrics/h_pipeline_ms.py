"""h_pipeline_ms: the H pipeline (``ntt.lm.groth16_h_batch``, coset NTTs
on K2), in ms a proof (program spans)."""

from zkb.trace import per_proof_ms

PHASES = ("h_pipeline",)


def read(run):
    return per_proof_ms(run, lambda name: name in PHASES)
