"""Chaos engine: injectable fault timelines for oversubscribed fleets (port
of ``repro.chaos``).

The data model (:class:`FaultSpec` / :class:`FaultEvent`, pure data, JSON
round-trippable) lives in :mod:`repro_torch.chaos.faults`; the runtime
(:class:`ChaosInjector`, polled by ``FleetSimulator`` between telemetry
ticks) in :mod:`repro_torch.chaos.injector`. Scenarios opt in with
``Scenario.with_faults``; see DESIGN.md §13 and the ``chaos-*`` scenario
family. The batched lowering (``provisioning.batched``) turns the same
timeline into per-tick row-alive masks and budget scales.
"""

from repro_torch.chaos.faults import (  # noqa: F401
    FAULT_EVENT_BUILDERS,
    FaultEvent,
    FaultSpec,
)
from repro_torch.chaos.injector import ChaosInjector, FaultRecord  # noqa: F401

__all__ = [
    "FAULT_EVENT_BUILDERS",
    "FaultEvent",
    "FaultSpec",
    "ChaosInjector",
    "FaultRecord",
]
