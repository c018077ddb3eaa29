"""A gloo world of the port's ranks, run in a background thread (a helper of
the tests/test_torch_parallel*.py files; imports no JAX).

``run_calls`` is a rank function for ``dist.run_ranks`` that runs a list of
calls over one world, each with the mesh layout it names.  ``World(n_ranks,
calls)`` starts ``dist.run_ranks(run_calls, ...)`` on the CPU at once;
``result(i)`` waits for it and returns rank 0's result of call i, or raises
what the world raised.  A test module keeps one world per layout in a
module-scoped fixture: a 4-rank spawn costs seconds, and the JAX side runs
meanwhile.  Spawned ranks import this module by name: they inherit the
parent's sys.path."""

import threading

import torch

from zkmember_tpu_torch.parallel import dist


class _MeshArg:
    """Stands for a mesh in an argument list of ``run_calls``."""


MESH = _MeshArg()


def run_calls(mesh, calls):
    """Rank function for ``dist.run_ranks``: each call (fn, dp, args) runs
    fn(*args) with every ``MESH`` in args replaced by a mesh of dp over this
    world (built once per dp, in the order of first use, the same on every
    rank); returns the results in order."""
    meshes = {mesh.shape["dp"]: mesh}
    out = []
    for fn, dp, args in calls:
        if dp not in meshes:
            meshes[dp] = dist.make_mesh(dp=dp, device=mesh.device)
        m = meshes[dp]
        out.append(fn(*(m if isinstance(a, _MeshArg) else a for a in args)))
    return out


class World:
    def __init__(self, n_ranks: int, calls):
        torch.set_num_threads(1)  # each rank takes this process's thread count
        self.box: dict = {}
        self.thread = threading.Thread(target=self._run, args=(n_ranks, calls), daemon=True)
        self.thread.start()

    def _run(self, n_ranks, calls):
        try:
            self.box["out"] = dist.run_ranks(run_calls, n_ranks, device="cpu", args=(calls,))
        except BaseException as e:  # noqa: BLE001 - raised again by result()
            self.box["err"] = e

    def result(self, i: int):
        self.thread.join(timeout=900)
        assert not self.thread.is_alive(), "the ranks did not finish"
        if "err" in self.box:
            raise self.box["err"]
        return self.box["out"][i]
