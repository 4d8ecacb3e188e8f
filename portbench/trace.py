"""The traced stretch of a ``--trace 1`` run: a torch.profiler window over
a few steady steps, read into the device's activities and the
benchmark's own host spans, and the busy time, the idle gaps and the
top device operations taken from them."""

from __future__ import annotations

import contextlib

import torch

# the benchmark's host spans inside a traced step
SPAN_PREFIX = "portbench."
WINDOW = SPAN_PREFIX + "window"


def span(name, on):
    """A host span the traced window records (nothing outside it)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


@contextlib.contextmanager
def profiled():
    """Yields a dict that holds, after the block, the window's device
    activities and host spans (``read``)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            yield out
            sync()
    out.update(read(prof))


def _fields(e):
    start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
    dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") \
        else e.duration_us()
    return e.name(), start, start + dur


def read(prof):
    """{"device": [(name, start_us, end_us)] of every device activity
    (kernels, copies, fills; not the device-side copies of the host
    spans), "host": [(span, start_us, end_us)] of the benchmark's spans,
    "window": (start_us, end_us)}."""
    device, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if on_device and not e.name().startswith(SPAN_PREFIX):
            device.append(_fields(e))
        elif not on_device and e.name().startswith(SPAN_PREFIX):
            name, a, b = _fields(e)
            if name == WINDOW:
                window = (a, b)
            else:
                host.append((name[len(SPAN_PREFIX):], a, b))
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return {"device": sorted(device, key=lambda x: x[1]), "host": host,
            "window": window}


def is_kernel(name):
    return not name.startswith(("Memcpy", "Memset"))


def busy_intervals(device, window):
    """The union of the device's activities inside ``window``."""
    lo, hi = window
    merged = []
    for _, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_s(traced):
    return sum(b - a for a, b in busy_intervals(traced["device"],
                                                traced["window"])) / 1e6


def window_s(traced):
    a, b = traced["window"]
    return (b - a) / 1e6


def top_device_ops(traced, n=10):
    """[[name, seconds]] of the device operations that took most time."""
    by_name = {}
    for name, a, b in traced["device"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    return [[k[:160], v] for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:n]]


def idle_gaps(traced, n=10):
    """[[host activity, seconds]]: the device's idle time inside the
    window by the benchmark span the host was in at each gap's middle
    ("other" outside every span), largest first."""
    busy = busy_intervals(traced["device"], traced["window"])
    lo, hi = traced["window"]
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    by_span = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [s for s in traced["host"] if s[1] <= mid <= s[2]]
        # the innermost span holds the middle
        name = min(inside, key=lambda s: s[2] - s[1])[0] if inside \
            else "other"
        by_span[name] = by_span.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by_span.items(),
                                      key=lambda kv: -kv[1])[:n]]
