"""Every served token of every call over the time from the first call's
start to the last call's end (no call is cut)."""


def read(measured):
    w = measured["window"]
    if "call_s" not in w:
        return None
    return w["tokens"] / w["elapsed_s"]
