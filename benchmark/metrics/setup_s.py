"""Set-up: from the process's start to the window's, loading, building the
weights and the model, warming up (and, in a checkout's first run,
building the kernels)."""


def read(measured):
    return measured["setup_s"]
