"""Table-4 workload mix and the occupancy-generator registry
(port of ``repro.core.traces``).

Workload mix = Table 4 (BLOOM-176B): Summarize (LP, 25%), Search (HP, 25%),
Chat (50:50, 50%). An occupancy generator maps (t_grid, seed, peak,
row-context, params) to a busy-server occupancy curve in [0, 1];
``TrafficSpec.generator`` names one. Only "diurnal" is built in; the
scenario families in ``repro_torch.provisioning.ensembles`` register on
import. Request-trace generation and the Fig.-16 replication report wait for
the event-driven simulator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.power_model import A100, ServerPower
from repro_torch.core.simulator import WorkloadClass
from repro_torch.core.workload import request_timing

DAY = 86_400.0
WEEK = 7 * DAY


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    prompt_range: Tuple[int, int]
    out_range: Tuple[int, int]
    share: float  # fraction of cluster traffic / servers
    priority_mix: float  # fraction high-priority


# Table 4
TABLE4 = (
    WorkloadSpec("summarize", (2048, 8192), (256, 512), 0.25, 0.0),
    WorkloadSpec("search", (512, 2048), (1024, 2048), 0.25, 1.0),
    WorkloadSpec("chat", (2048, 4096), (128, 2048), 0.50, 0.5),
)


def build_workload_classes(model_name: str = "bloom-176b",
                           server: ServerPower = None) -> Tuple[List[WorkloadClass], List[float]]:
    server = server or ServerPower(A100)
    cfg = get_config(model_name)
    classes, shares = [], []
    for spec in TABLE4:
        p_mid = int(np.sqrt(spec.prompt_range[0] * spec.prompt_range[1]))
        timing = request_timing(cfg, p_mid, 1, server)
        classes.append(WorkloadClass(spec.name, timing, spec.priority_mix))
        shares.append(spec.share)
    return classes, shares


def occupancy_curve(t: np.ndarray, *, peak: float = 0.62, trough: float = 0.30,
                    noise: float = 0.02, seed: int = 1) -> np.ndarray:
    """Diurnal + weekly interactive-load curve in [0,1] (busy-server fraction)."""
    rng = np.random.default_rng(seed)
    mid = 0.5 * (peak + trough)
    amp = 0.5 * (peak - trough)
    diurnal = mid + amp * np.sin(2 * np.pi * (t / DAY - 0.375))
    weekly = 1.0 - 0.06 * (np.sin(2 * np.pi * t / WEEK - 1.1) > 0.62)  # weekend dip
    slow_noise = np.interp(t, t[:: max(1, len(t) // 200)],
                           rng.normal(0, noise, size=len(t[:: max(1, len(t) // 200)])))
    return np.clip(diurnal * weekly + slow_noise, 0.05, 0.98)


# ---------------------------------------------------------------------------
# occupancy-generator registry
# ---------------------------------------------------------------------------

OccupancyGenerator = Callable[..., np.ndarray]

_OCC_GENERATORS: Dict[str, OccupancyGenerator] = {}


def register_occupancy_generator(name: str, gen: OccupancyGenerator, *,
                                 overwrite: bool = False) -> OccupancyGenerator:
    if name in _OCC_GENERATORS and not overwrite:
        raise ValueError(f"occupancy generator {name!r} already registered")
    _OCC_GENERATORS[name] = gen
    return gen


def get_occupancy_generator(name: str) -> OccupancyGenerator:
    try:
        return _OCC_GENERATORS[name]
    except KeyError:
        known = ", ".join(sorted(_OCC_GENERATORS))
        raise KeyError(
            f"unknown occupancy generator {name!r}; registered: {known}. "
            "The scenario families register on `import repro_torch.provisioning`."
        ) from None


def _diurnal_generator(t_grid: np.ndarray, *, seed: int = 1, peak: float = 0.62,
                       n_rows: int = 1, row: int = 0, **kw) -> np.ndarray:
    # The member/scenario seed is deliberately NOT forwarded: the diurnal
    # baseline models one fixed production curve (occupancy-noise seed 1,
    # exactly the legacy generate_requests default), so passing gen_params
    # does not discontinuously re-seed the occupancy realization. Override
    # explicitly with gen_params={"seed": ...} to vary the curve itself.
    return occupancy_curve(t_grid, peak=peak, **kw)


register_occupancy_generator("diurnal", _diurnal_generator)

