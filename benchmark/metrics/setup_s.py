"""setup_s (end to end, host clock): from the process's start to the first
timed request: imports, the CUDA context, the weights, the uploads, the
warm-up (kernel builds, cuDNN plans, CUDA graph captures) and one round of
jobs through the host path."""


def read(run):
    return run.setup_s
