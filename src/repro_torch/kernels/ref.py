"""Plain-torch reference for the POLCA tick kernel (port of
``repro.kernels.ref.polca_tick_reference``).

The JAX reference is a ``lax.scan`` over the shared step function, kept
apart from the Pallas kernel so a test isolates the kernel's plumbing. In
the port the kernel's plain version already is that loop over the shared
step (``tick._tick_body``), on the whole member block and with no
plumbing of its own, so the reference is that function.
"""

from repro_torch.kernels.tick import polca_tick_plain as polca_tick_reference

__all__ = ["polca_tick_reference"]
