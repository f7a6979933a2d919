"""Fault timelines (port of ``repro.chaos``): the data model of
:mod:`repro_torch.chaos.faults`. Scenarios opt in with
``Scenario.with_faults``; the batched lowering turns a timeline into
per-tick row-alive masks and budget scales. The injector that applies a
timeline to the event-driven fleet waits for the port of the fleet.
"""

from repro_torch.chaos.faults import (  # noqa: F401
    FAULT_EVENT_BUILDERS,
    FaultEvent,
    FaultSpec,
)

__all__ = [
    "FAULT_EVENT_BUILDERS",
    "FaultEvent",
    "FaultSpec",
]
