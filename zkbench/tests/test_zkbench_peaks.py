"""The frozen peaks and the MSM problem's work against the program's work
model (``utils/obs.py``) at today's shapes."""

from zkb import peaks


def test_the_peaks_are_the_h100_sxm_data_sheets_and_the_programs():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.IMAD_PER_S == 16.75e12 == 67e12 / 4  # float32 FMA lanes halved
    from zkmember_tpu_torch.utils import obs

    assert (peaks.IMAD_PER_S, peaks.HBM_BYTES_PER_S) == (obs.IMAD_PER_S, obs.HBM_BYTES_PER_S)
    for n in (16, 24, 48):
        assert peaks.mont_mul_imads(n) == obs.mont_mul_imads(n)


def test_the_msm_problems_work_equals_k1_and_the_finish_at_todays_shapes():
    """K1 plus the finish, as obs counts them over the prover's lanes (M for
    the four G1 rows at M = 2^15 and 2^17, the G2 row's power of two), do the
    problem's work over as many points."""
    from zkmember_tpu_torch.snark import groth16, prove_lm

    cfg = groth16.pairing_config("bls12_381")
    n, nbits = cfg.fq_spec.n, cfg.r.bit_length()
    nwin = (nbits + 3) // 4
    for M in (1 << 15, 1 << 17):
        for g2, R, B, max_lanes in ((False, 4, M, 1 << 18), (True, 1, M // 2, 1 << 17)):
            ops = prove_lm.sw_ops(cfg, g2, "cpu")
            obs_imads = prove_lm._family_imads(ops, R, B, nwin, True, max_lanes, 1)
            assert obs_imads == R * peaks.msm_imads(n, g2, nbits, B)


def test_a_proofs_least_time_is_bound_by_operations():
    rows = [(24, False, 255, 16, 32_000)] * 4 + [(24, True, 255, 16, 13_831)]
    t, which, imads, nbytes = peaks.least_seconds(rows)
    assert which == "operations" and t == imads / 16.75e12 > nbytes / 3.35e12
    assert 4e-3 < t < 5.5e-3  # K1 and the finish bound a 16-member proof at 3.1 ms; M = 2^15 doubles G1
