"""Reading a ``torch.profiler`` trace of a few whole calls: the device's
operations by name and kind, its busy time (the union of the operations'
intervals, as ``chip_smoke.device_busy`` takes it), and the idle gaps
between them, each named by what the host was doing then (the innermost
span or operator of the host's timeline that covers the gap)."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Interval:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self):
        return self.end_us - self.start_us


@dataclass
class Trace:
    """The device's operations (kernels, copies and fills) and the host's
    operators and spans of the traced calls."""
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    fills: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def device_ops(self):
        return self.kernels + self.copies + self.fills

    def time_us(self, part, ops=None):
        """Device microseconds of the operations whose name holds
        ``part``."""
        ops = self.kernels if ops is None else ops
        return sum(op.us for op in ops if part in op.name)

    def count(self, part, ops=None):
        ops = self.kernels if ops is None else ops
        return sum(1 for op in ops if part in op.name)


def from_profiler(prof):
    """A :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = Trace()
    for e in prof.events():
        iv = Interval(e.name, float(e.time_range.start),
                      float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # operator ranges projected onto the device timeline repeat
            # their kernels' time
            if e.is_user_annotation:
                continue
            if e.name.startswith("Memcpy"):
                out.copies.append(iv)
            elif e.name.startswith("Memset"):
                out.fills.append(iv)
            else:
                out.kernels.append(iv)
        else:
            out.host.append(iv)
    return out


def merged(intervals):
    """The union of ``intervals`` as sorted, disjoint (start, end) pairs."""
    spans = sorted((iv.start_us, iv.end_us) for iv in intervals)
    out = []
    for s, t in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_us(intervals):
    return sum(t - s for s, t in merged(intervals))


def idle_gaps(trace, lo_us, hi_us):
    """The device's idle gaps inside [lo_us, hi_us]: (start, end) pairs."""
    gaps, at = [], lo_us
    for s, t in merged(trace.device_ops):
        if s > at:
            gaps.append((at, min(s, hi_us)))
        at = max(at, t)
    if at < hi_us:
        gaps.append((at, hi_us))
    return [(s, t) for s, t in gaps if t > s]


def host_labels(trace, times_us):
    """What the host was doing at each of ``times_us`` (ascending): the
    innermost host span or operator that covers it, prefixed by the
    innermost harness span (``layer:...``) when another covers it;
    "host (no operator)" where none does.  One sweep over the host's
    timeline."""
    events = sorted(trace.host, key=lambda iv: iv.start_us)
    active, j, out = [], 0, []
    for t in times_us:
        while j < len(events) and events[j].start_us <= t:
            active.append(events[j])
            j += 1
        active = [iv for iv in active if iv.end_us >= t]
        if not active:
            out.append("host (no operator)")
            continue
        inner = min(active, key=lambda iv: iv.us)
        layers = [iv for iv in active if iv.name.startswith("layer:")]
        layer = min(layers, key=lambda iv: iv.us).name if layers else None
        out.append(inner.name if layer in (None, inner.name)
                   else f"{layer} / {inner.name}")
    return out


def breakdown(trace, lo_us, hi_us, top=10, name_len=120):
    """The contract's ``breakdown``: the device operations that took most
    time (seconds, summed by name) and the idle gaps' seconds summed by
    what the host was doing during each, the ``top`` of each."""
    by_op = {}
    for op in trace.device_ops:
        key = op.name[:name_len]
        by_op[key] = by_op.get(key, 0.0) + op.us * 1e-6
    by_gap = {}
    gaps = idle_gaps(trace, lo_us, hi_us)
    labels = host_labels(trace, [0.5 * (s + t) for s, t in gaps])
    for (s, t), label in zip(gaps, labels):
        key = label[:name_len]
        by_gap[key] = by_gap.get(key, 0.0) + (t - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}
