"""The program's own spans and counters of a traced window
(``repro_torch.obs.device``): the recorder the program keeps for a
``torch.profiler`` session, which the traced window runs under, read once
the window has closed, each span's device start and end set from its CUDA
events. A program without that recorder, or one that recorded no span or
no device time, gives None, and so does every metric read from it."""

from __future__ import annotations

import statistics
from typing import List, Optional


def timeline() -> Optional[list]:
    """The spans of the program's profiler session in order of entry, or
    None."""
    try:
        from repro_torch.obs import device
    except ImportError:
        return None
    rec = device.session()
    if rec is None or not rec.timeline:
        return None
    return device.resolve(rec)


def _median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def device_ms(name: str, spans=None) -> Optional[float]:
    """The median device milliseconds of the spans ``name``: from the
    device event at entry to the one at exit."""
    spans = timeline() if spans is None else spans
    return _median([(r.device_end_ns - r.device_start_ns) / 1e6 for r in spans or ()
                    if r.name == name and r.device_start_ns is not None])


def host_ms(name: str, spans=None) -> Optional[float]:
    """The median host milliseconds of the spans ``name`` (entry to exit)."""
    spans = timeline() if spans is None else spans
    return _median([(r.end_ns - r.start_ns) / 1e6 for r in spans or () if r.name == name])


def per_span(name: str, counter: str, spans=None) -> Optional[float]:
    """How far ``counter`` moved inside a span ``name``, over all of them."""
    spans = timeline() if spans is None else spans
    got = [r.counts[counter] for r in spans or ()
           if r.name == name and r.counts and counter in r.counts]
    return sum(got) / len(got) if got else None


def host_lead_ms(root: str, child: str, spans=None) -> Optional[float]:
    """The median over the spans ``root`` of the smallest host lead among
    the spans ``child`` inside each: a span's device start less its host
    start, how far the device was behind the host when it was entered. A
    lead near a launch's latency means the device had run dry there."""
    spans = timeline() if spans is None else spans
    if not spans:
        return None

    def root_of(i):
        while spans[i].parent >= 0:
            i = spans[i].parent
        return i

    least = {}
    for i, r in enumerate(spans):
        if r.name != child or r.device_start_ns is None:
            continue
        top = root_of(i)
        if spans[top].name == root:
            lead = (r.device_start_ns - r.start_ns) / 1e6
            least[top] = min(lead, least.get(top, lead))
    return _median(list(least.values()))
