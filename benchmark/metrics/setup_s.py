"""Process start to the first timed step: imports, building or loading
the kernels, making the weights and inputs, the checked steps that warm
up every shape."""


def read(run):
    return run.setup_s
