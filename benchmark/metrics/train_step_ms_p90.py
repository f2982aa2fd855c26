"""The 90th percentile of every step time of the window (one
``CheckpointingTrainer.run(1)``, ending in the loss's host read), in ms,
by ``statistics.quantiles`` with n = 10 (a lone step is its own)."""

import statistics


def read(measured):
    steps = measured["window"].get("step_s")
    if not steps:
        return None
    if len(steps) == 1:
        return steps[0] * 1e3
    return statistics.quantiles(steps, n=10)[-1] * 1e3
