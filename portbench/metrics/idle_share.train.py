"""The device's idle share of the traced chunk of train steps, in %: one
less the union of its operations' intervals over the window
(``yardstick/trace.py``). Each step is one graph launch, so recording
costs the host little here; and the untraced chunks' host time (what
``idle_share.sample`` divides by) is no measure here: the traced chunk's
busy time reads a few tenths of a percent longer than it, the device
being all but never idle."""


def read(ctx):
    return 100 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
