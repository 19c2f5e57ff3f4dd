"""images_per_s (end to end, host clock): the jobs that succeeded inside the
window over the window's seconds, all the work and all the time of it."""


def read(run):
    t0, t1 = run.window
    return sum(1 for j in run.jobs if j.ok and t0 <= j.end <= t1) / run.seconds
