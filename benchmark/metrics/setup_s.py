"""setup_s: seconds from the process's start to the window's start (host
clock): imports, CUDA contexts, the kernel library's build or load, the
warm-up search."""


def read(run):
    return run.setup_s
