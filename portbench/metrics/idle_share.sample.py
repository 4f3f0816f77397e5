"""The device's idle share of an untraced walk, in %: one less the traced
walk's device busy time (the union of its operations' intervals,
``yardstick/trace.py``) over the median host time of the window's untraced
walks, which do the same work. The traced walk's own share counts as idle
what recording its thousands of launches costs the host; it goes to the
log beside this one."""

import statistics


def read(ctx):
    if not ctx.unit_seconds:
        return None
    median = statistics.median(ctx.unit_seconds)
    t = ctx.trace
    ctx.log(f"[idle] traced walk: busy {t.busy_s:.6f} of {t.window_s:.6f} s, idle "
            f"{100 * (1 - t.busy_s / t.window_s):.4f}%; untraced walks: median {median:.6f} s of "
            f"{len(ctx.unit_seconds)} ({min(ctx.unit_seconds):.6f}-{max(ctx.unit_seconds):.6f})")
    return 100 * (1 - t.busy_s / median)
