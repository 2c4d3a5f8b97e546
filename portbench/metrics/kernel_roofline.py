"""``kernel_roofline`` (%, device trace; layer: kernels): the port's
hand-written kernels (K1, K3, K4, K6, K7) in the profiled epochs: the
sum of each call's least time (``costs.kernel_bound_s`` of the shapes
the port counted the call under) over the sum of their kernels' device
time."""


def read(run):
    shares = run.kernel_shares()
    measured = sum(m for _, m, _ in shares.values())
    if not measured:
        return None
    return 100.0 * sum(least for least, _, _ in shares.values()) / measured
