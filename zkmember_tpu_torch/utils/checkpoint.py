"""Save and load Groth16 proving keys in the format of zkmember_tpu.utils.checkpoint.

The checkpoint is two files: ``<path>.npz`` holds the (k, n) uint32
Montgomery query planes and ``<path>.json`` the host data (curve, domain
size, nonzero index lists, serialized beta/delta points, the verifying key
and the npz's sha256).  Keys saved by either package load in both.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from zkmember_tpu_torch.snark import groth16, prove_lm
from zkmember_tpu_torch.utils import serialize as ser


def _ints(pt):
    """Host affine point -> plain ints ((x, y) or ((x0, x1), (y0, y1)))."""
    def coord(c):
        if hasattr(c, "coeffs"):
            return tuple(int(ci.v) for ci in c.coeffs)
        return int(c.v)

    return (coord(pt[0]), coord(pt[1]))


QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


def _host_u32(c) -> np.ndarray:
    if isinstance(c, torch.Tensor):
        return c.cpu().numpy().astype(np.uint32)
    return np.asarray(c, np.uint32)


def query_arrays(pk: "groth16.ProvingKey") -> dict:
    """pk's query planes as host uint32 arrays under the npz's names:
    '<q>_x', '<q>_y', and '<q>_x_c0' ... '<q>_y_c1' for Fp2 coordinates."""
    store: dict = {}

    def put(name, c):
        if isinstance(c, tuple):
            for i, ci in enumerate(c):
                put(f"{name}_c{i}", ci)
        else:
            store[name] = _host_u32(c)

    for name in QUERIES:
        pa = getattr(pk, name)
        put(f"{name}_x", pa.x)
        put(f"{name}_y", pa.y)
    return store


def save_groth16_keys(path: str, pk: "groth16.ProvingKey") -> None:
    """Write pk and its vk: <path>.npz (query planes) + <path>.json (host data)."""
    np.savez_compressed(path + ".npz", **query_arrays(pk))
    with open(path + ".npz", "rb") as f:
        npz_sha = hashlib.sha256(f.read()).hexdigest()

    g1 = groth16.pairing_config(pk.curve).mod.G1
    meta = {
        "npz_sha256": npz_sha,
        "curve": pk.curve,
        "domain_size": pk.domain_size,
        "num_instance": pk.num_instance,
        "a_nonzero": pk.a_nonzero,
        "b_nonzero": pk.b_nonzero,
        "l_nonzero": pk.l_nonzero,
        "beta_g1": ser.sw_point_to_bytes(g1, pk.beta_g1).hex(),
        "delta_g1": ser.sw_point_to_bytes(g1, pk.delta_g1).hex(),
        "vk": ser.vk_to_bytes(pk.vk).hex(),
    }
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_groth16_keys(path: str, device=None) -> "prove_lm.Groth16KeysLM":
    """Read <path>.{json,npz} -> the port's Groth16KeysLM on `device`.

    The npz is checked against ``npz_sha256`` when the meta records one; a
    meta without it still loads."""
    with open(path + ".json") as f:
        meta = json.load(f)
    curve = meta["curve"]
    cfg = groth16.pairing_config(curve)
    g1 = cfg.mod.G1
    with open(path + ".npz", "rb") as f:
        raw = f.read()
    if "npz_sha256" in meta and hashlib.sha256(raw).hexdigest() != meta["npz_sha256"]:
        raise ValueError(
            f"checkpoint {path}.npz does not match its recorded sha256; "
            "delete the artifact and regenerate"
        )
    vk = ser.vk_from_bytes(curve, bytes.fromhex(meta["vk"]))
    with np.load(path + ".npz") as data:
        planes = {k: data[k] for k in data.files}
    return prove_lm.keys_from_numpy(
        planes,
        curve=curve,
        a_nonzero=meta["a_nonzero"],
        b_nonzero=meta["b_nonzero"],
        l_nonzero=meta["l_nonzero"],
        domain_size=meta["domain_size"],
        num_instance=meta["num_instance"],
        vk={
            "alpha_g1": _ints(vk.alpha_g1),
            "beta_g2": _ints(vk.beta_g2),
            "gamma_g2": _ints(vk.gamma_g2),
            "delta_g2": _ints(vk.delta_g2),
            "gamma_abc_g1": [_ints(p) for p in vk.gamma_abc_g1],
        },
        beta_g1=_ints(ser.sw_point_from_bytes(g1, bytes.fromhex(meta["beta_g1"]))),
        delta_g1=_ints(ser.sw_point_from_bytes(g1, bytes.fromhex(meta["delta_g1"]))),
        device=device,
    )
