"""Milliseconds of the traced window per iteration of the regenerative
pool: the traced renders' wall time over the sum of ``render_pool``'s
iterations. Nothing to read where no pool ran."""


def read(trace):
    iters = trace.counters.get("pool_iterations", 0)
    return trace.window_ns() / 1e6 / iters if iters else None
