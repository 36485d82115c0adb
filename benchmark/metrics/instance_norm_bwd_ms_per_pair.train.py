"""Device time of instance norm's backward kernel a trained pair (None
where no such kernel ran)."""


def read(r):
    t, _ = r.summary.kernel_s(("instance_norm_bwd",))
    if r.pairs == 0 or t <= 0:
        return None
    return t * 1e3 / r.pairs
