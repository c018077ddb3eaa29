"""setup_s: seconds from the process's start to the window's (host clock):
imports, the kernel library, the registrar, the pool's synthesis, setup,
the key, the warm-up requests."""


def read(run):
    return run.setup_s
