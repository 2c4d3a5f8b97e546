"""``device_idle_share`` (%, device trace; layer: device): one less the
union of the intervals in which a kernel, copy or fill ran, over the
wall of the profiled epochs."""


def read(run):
    prof = run.profile
    if not prof or not prof["window_s"] or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
