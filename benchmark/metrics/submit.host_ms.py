"""submit.host_ms (layer: submission; program span): the mean ms a job spends
in api/submit.py:submit_job outside the restorator (validate, preprocess,
moderation, the job record, credits), from the benchmark's timers around
submit_job and ctx.restorator.restore."""

from benchmark.readers import self_ms


def read(run):
    return self_ms(run, "submit", "restore")
