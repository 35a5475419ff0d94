"""setup_s: seconds from the process's start to the window's opening:
imports, the inputs, the index build, the executor's upload and bucket
warm-up, the kernels' build and the warm-up batches."""


def read(run):
    return run.setup_s
