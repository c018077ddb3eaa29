"""The one traffic generator: a mix file's parameters and a seed -> the
pool of members set-up synthesizes, the stream of requests over it, and
the seeded random streams the run draws from.

A mix (``zkbench/traffic/<mix>.json``):
  pool                how many members' circuits set-up synthesizes: the
                      memberships the window re-presents
  proofs_per_request  P: the request proves P of them
  entry               the proof system's prover call for a request (for
                      Groth16, ``systems/groth16.py``: "prove", P = 1, or
                      "prove_batch")
Every mix is a closed loop with one client (one prover process; the next
request goes when the last returns), round-robin over the pool: request k
proves the pool's members k P .. k P + P - 1, modulo the pool.

The pool's members are drawn from the seed, distinct and uniform over the
configuration's registrar.  Every member's circuit has the same shape, so
every seed gives the same sizes and the same order of work; only which
members, and every proof's randomizers, differ.
"""

from __future__ import annotations

import random


def stream(seed: int, name: str) -> random.Random:
    """An independent seeded stream of the run (one a purpose).  The check
    replays a second copy of a stream to know what the program drew."""
    return random.Random(f"{int(seed)}:{name}")


def validate(mix: dict, members: int) -> None:
    P, pool = mix["proofs_per_request"], mix["pool"]
    if not 1 <= P <= pool <= members:
        raise ValueError(f"{P} proofs a request from a pool of {pool} of {members} members")


def pool(mix: dict, members: int, seed: int) -> list:
    """The members whose circuits set-up synthesizes, in the order the
    requests take them."""
    validate(mix, members)
    return stream(seed, "pool").sample(range(members), mix["pool"])


def requests(mix: dict):
    """Endless requests: each a list of P positions in the pool."""
    P, n = mix["proofs_per_request"], mix["pool"]
    k = 0
    while True:
        yield [(k * P + j) % n for j in range(P)]
        k += 1


def warm_up(mix: dict) -> list:
    """Requests of the mix's shape that prove every member of the pool once
    before the window, so each circuit's first-use costs fall in set-up."""
    P, n = mix["proofs_per_request"], mix["pool"]
    gen = requests(mix)
    return [next(gen) for _ in range(-(-n // P))]
