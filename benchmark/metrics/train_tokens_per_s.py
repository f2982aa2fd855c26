"""Every token trained in the window (batch x (seq - 1) a step) over the
window's seconds, the first step's start to the last step's end."""


def read(measured):
    w = measured["window"]
    if "step_s" not in w:
        return None
    return w["tokens"] / w["elapsed_s"]
