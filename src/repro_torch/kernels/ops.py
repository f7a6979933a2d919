"""Public wrappers for the port's kernels (port of ``repro.kernels.ops``).

Each wrapper dispatches on the device of its input: a CUDA tensor launches
the hand-written kernel (or raises), a CPU tensor takes the kernel's plain
PyTorch version. There is no fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels import tick as _tick


def polca_tick(occ, bscale, row_budget, *, consts, oob_ticks, brake_ticks,
               ring_depth, esc):
    """Non-predictive POLCA tick loop (power fold + latch/ring update):
    ``csrc/tick.cu`` on CUDA tensors, :func:`~repro_torch.kernels.tick.
    polca_tick_plain` on CPU tensors. ``consts`` is a
    :class:`~repro_torch.kernels.tick.TickConsts`."""
    fn = _tick.polca_tick_plain if occ.device.type == "cpu" else _tick.polca_tick_loop
    return fn(occ, bscale, row_budget, consts, oob_ticks=oob_ticks,
              brake_ticks=brake_ticks, ring_depth=ring_depth, esc=esc)
