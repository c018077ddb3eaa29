"""Entry point on the flagship compute path (counterpart of ``__graft_entry__.entry``).

``entry(device)`` returns ``(fn, (left, right))``: one batched two-to-one
Pedersen Merkle-level hash (the reference's hot loop) of 8 node pairs on
the pedersen381 stack, its inputs made from ``np.random.default_rng(0)`` as
the reference makes them.  ``fn(left, right)`` returns canonical (8, 16)
int32 digest limbs on the inputs' device.

Run: python -c "from zkmember_tpu_torch import entry; fn, args = entry.entry(); print(fn(*args))"
"""

from __future__ import annotations

import numpy as np
import torch

from zkmember_tpu_torch import device as devices

BATCH = 8


def _params():
    from zkmember_tpu_torch.app import circuits as app
    from zkmember_tpu_torch.utils import rng as frng

    cfg = app.get_config("pedersen381")
    leaf_params, node_params = cfg.setup_params(frng.test_rng())
    return cfg, leaf_params, node_params


def entry(device=None):
    """(fn, example_args) on ``device.resolve(device)``: the card unless the
    caller passes "cpu"."""
    from zkmember_tpu_torch.fields import spec as fs
    from zkmember_tpu_torch.hash import pedersen as ph

    dev = devices.resolve(device)
    _, _, node_params = _params()
    n = node_params.spec.n

    def fn(left, right):
        return ph.two_to_one_device(node_params, left, right)

    rng = np.random.default_rng(0)

    def digests():
        limbs = fs.ints_to_limbs([int(rng.integers(1 << 62)) for _ in range(BATCH)], n)
        return torch.as_tensor(limbs.astype(np.int32), device=dev)

    left = digests()
    right = digests()
    return fn, (left, right)
