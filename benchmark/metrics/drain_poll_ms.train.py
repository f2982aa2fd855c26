"""The mean host time of the drain watcher's poll a step
(``DrainSignalWatcher.check_and_acknowledge``, timed by the benchmark's
wrapper), in ms, over the window's steps."""


def read(measured):
    polls = measured.get("polls")
    if not polls:
        return None
    return sum(polls) / len(polls) * 1e3
