"""The host's own ms a train step of the traced chunk: the mean, over its
``sinddm.train_step`` spans (``training/trainer.py`` ``_run``: the graph
replay or eager step, the loss copy and ``_after_step``), of each span's
duration less the parts in which the host waits: for a full launch queue,
in a synchronizing CUDA call, or on CUPTI's buffers (``yardstick/spans.py``).
The log gives the steps that update the EMA and the others apart, each
kind's count, the device's busy ms a step, the headroom, and the chunk's
idle gaps named by program span."""

from portbench.yardstick import spans


def read(ctx):
    placed = spans.place(ctx.trace, ctx.log)
    if not placed:
        return None
    chunk, steps = spans.last_unit(placed, "sinddm.train_chunk", "sinddm.train_step")
    if not steps:
        return None
    waits = spans.host_ranges(ctx.trace, spans.is_wait)
    host = spans.host_us(steps, waits)
    mean_ms = sum(host) / len(host) / 1e3
    busy_ms = 1e3 * ctx.trace.busy_s / len(steps)
    kinds = {}
    for s in steps:
        kinds[s.attrs.get("kind")] = kinds.get(s.attrs.get("kind"), 0) + 1
    for label, want in (("EMA", True), ("other", False)):
        part = [h / 1e3 for s, h in zip(steps, host) if bool(s.attrs.get("ema")) == want]
        if part:
            ctx.log(f"[host_ms_per_step.train] {label} steps: host ms {spans.summary(part)}")
    ctx.log(f"[host_ms_per_step.train] host ms a step: {spans.summary([h / 1e3 for h in host])} sinddm.train_step "
            f"spans of a {chunk.attrs.get('mode')} chunk of {chunk.attrs.get('n_steps')}, kinds {kinds}; device busy "
            f"{busy_ms:.4f} ms a step; headroom {busy_ms / max(mean_ms, 1e-9):.3f}x (device ms / host ms a step)")
    ctx.log(f"[host_ms_per_step.train] {spans.in_launches_us(steps, ctx.trace, waits) / 1e3:.3f} of the steps' "
            f"{sum(host) / 1e3:.3f} host ms inside launch calls (a replay's is cudaGraphLaunch), the rest between them")
    ctx.log(f"[host_ms_per_step.train] idle by program span | CUDA call: {spans.idle_by_span(ctx.trace, placed)}")
    return mean_ms
