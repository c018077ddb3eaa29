"""The traffic generator and the seeded streams."""

import itertools

import pytest

from zkb import traffic

BATCH = {"pool": 8, "proofs_per_request": 8, "entry": "prove_batch"}
SINGLE = dict(BATCH, pool=4, proofs_per_request=1, entry="prove")


def test_the_same_seed_gives_the_same_pool_and_another_seed_another():
    big = 2**31 + 12345
    for mix in (BATCH, SINGLE):
        assert traffic.pool(mix, 1024, big) == traffic.pool(mix, 1024, big)
        assert traffic.pool(mix, 1024, big) != traffic.pool(mix, 1024, big + 1)
    assert traffic.pool(SINGLE, 1 << 32, 2**33 + 1) != traffic.pool(SINGLE, 1 << 32, 2**33 + 2)


def test_the_pool_draws_distinct_members_across_the_whole_registrar():
    for seed in (1, 2**32 + 7):
        pools = [traffic.pool(BATCH, 1024, seed + k) for k in range(100)]
        assert all(len(set(p)) == 8 and all(0 <= i < 1024 for i in p) for p in pools)
        assert len({i for p in pools for i in p}) > 500
        deep = traffic.pool(SINGLE, 1 << 32, seed)
        assert len(set(deep)) == 4 and all(0 <= i < 1 << 32 for i in deep)


def test_requests_go_round_robin_over_the_pool():
    assert list(itertools.islice(traffic.requests(SINGLE), 6)) == [[0], [1], [2], [3], [0], [1]]
    assert list(itertools.islice(traffic.requests(BATCH), 2)) == [list(range(8))] * 2
    three = dict(BATCH, pool=6, proofs_per_request=4)
    assert list(itertools.islice(traffic.requests(three), 3)) == [[0, 1, 2, 3], [4, 5, 0, 1],
                                                                  [2, 3, 4, 5]]


@pytest.mark.parametrize("mix", [SINGLE, BATCH, dict(BATCH, pool=6, proofs_per_request=4)])
def test_the_warm_up_proves_every_member_of_the_pool_in_requests_of_the_mixs_shape(mix):
    reqs = traffic.warm_up(mix)
    assert {i for r in reqs for i in r} == set(range(mix["pool"]))
    assert all(len(r) == mix["proofs_per_request"] for r in reqs)


@pytest.mark.parametrize("bad", [
    {"proofs_per_request": 9}, {"pool": 9, "proofs_per_request": 8}, {"proofs_per_request": 0},
])
def test_a_mix_the_generator_cannot_run_is_refused(bad):
    with pytest.raises(ValueError):
        traffic.pool(dict(BATCH, **bad), 8, 1)  # 8 members


def test_a_stream_replays_from_its_seed_and_streams_differ():
    a, b = traffic.stream(2**31 + 3, "proofs"), traffic.stream(2**31 + 3, "proofs")
    va = [a.randrange(1 << 255) for _ in range(5)] + [a.randrange(1, 7)]
    vb = [b.randrange(1 << 255) for _ in range(5)] + [b.randrange(1, 7)]
    assert va == vb
    assert traffic.stream(2**31 + 3, "toxic_waste").randrange(1 << 255) != va[0]
