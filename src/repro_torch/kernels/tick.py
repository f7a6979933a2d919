"""POLCA tick inner loop: the plain PyTorch step math and the CUDA kernel wrapper.

Port of ``repro.kernels.tick``. The batched ensemble engine
(``provisioning.batched``) advances N members x T ticks of the POLCA state
machine; its inner loop is three fused pieces: the closed-form power fold
over rows, the :class:`~repro_torch.core.policy.PolcaPolicy`
latch/escalation update, and the actuation-delay ring.

* The step functions below (:func:`row_power_w`, :func:`polca_latch_step`,
  :func:`apply_ring_tick`, :func:`push_ring_commands`, :func:`_tick_body`)
  are that math as float64 torch functions on ``[C, R]`` tensors, line for
  line the JAX functions of the same names (a NaN-sentinel ring).
  :func:`polca_tick_plain` runs them over T ticks: the kernel's plain
  version, which ``ops.polca_tick`` takes for CPU tensors and
  ``chip_smoke.py`` holds the kernel against.
* :func:`polca_tick_loop` launches the hand-written CUDA kernel
  (``csrc/tick.cu``, built by ``_build``) on CUDA tensors: two (member, row)
  lanes a thread with the whole T-tick loop inside the thread, its ring
  holding codes into :func:`freq_table`. It counts its launches in
  ``polca_tick_loop.launches``; :func:`launch_plan` reports its launch
  shape and residency.

Both write the four per-tick planes as ``[N, T, R]``-shaped views of
time-major ``[T, N, R]`` storage: a tick's lanes are contiguous, which is
what the kernel's warps need, and a caller sees the JAX kernel's shapes.

Unlike the JAX versions, the ring helpers update ``ring`` in place (it is
the only copy of the ring state, so nothing is lost and a ``[D, 2, C, R]``
copy per tick is saved).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import _build


class TickConsts(NamedTuple):
    """Per-scenario scalar constants of the tick program (policy thresholds
    + the closed-form power plane), as plain floats."""

    t1: float
    t2: float
    t1_buf: float
    t2_buf: float
    lp_t1: float
    lp_t2: float
    hp_t2: float
    brake_freq: float
    p0_srv_w: float
    k_lp_w: float
    k_hp_w: float
    lp_share: float
    gamma: float
    n_servers: float
    power_scale: float


class PolcaLatches(NamedTuple):
    """The boolean cap/brake state machine of one policy instance,
    vectorized over arbitrary leading shape (rows, or members x rows)."""

    t1c: torch.Tensor  # T1 cap active
    t2c: torch.Tensor  # T2 cap active
    hpc: torch.Tensor  # HP cap active (escalated)
    brk: torch.Tensor  # braking right now
    t2s: torch.Tensor  # escalation tick counter (int32)


def row_power_w(c, occ, f_lp, f_hp):
    """Per-row watts at occupancy + frequency state — the expression the
    numpy tick oracle evaluates (kept in lockstep by the parity tests)."""
    return row_power_from_pows(c, occ, f_lp ** c.gamma, f_hp ** c.gamma)


def row_power_from_pows(c, occ, pow_lp, pow_hp):
    """:func:`row_power_w` with the frequency powers ``f ** gamma`` given
    (the torch scan engine looks them up in a per-scenario table)."""
    busy = c.k_lp_w * pow_lp + c.k_hp_w * pow_hp
    return c.power_scale * c.n_servers * (c.p0_srv_w + occ * busy)


def lp_power_w(c, occ, f_lp):
    return lp_power_from_pow(c, occ, f_lp ** c.gamma)


def lp_power_from_pow(c, occ, pow_lp):
    """:func:`lp_power_w` with ``f_lp ** gamma`` given."""
    return (c.power_scale * c.n_servers
            * (c.lp_share * c.p0_srv_w + occ * c.k_lp_w * pow_lp))


def polca_latch_step(latches: PolcaLatches, p_obs, p_raw, lp_frac, c, *,
                     esc: int, predictive: bool):
    """One vectorized tick of ``PolcaPolicy.observe`` over any batch shape.

    Mirrors ``core.policy`` line for line: the overload path sets every cap
    flag and skips releases; cap/escalation branches run only out of
    overload; releases read the *post-cap* flags, and the T1 release
    additionally requires T2 to have just released or been clear.
    ``predictive`` adds the informed-escalation shortcut of
    ``PredictivePolcaPolicy`` (p_obs is then the extrapolated power).

    Returns ``(latches', fire, lp_cmd, hp_cmd)`` — ``fire`` marks brake
    firings; the command planes are NaN where no command is issued, in the
    policy's cmd-list order (later overwrites earlier, the DES
    same-due-time rule).
    """
    t1c, t2c, hpc, brk, t2s = latches
    over = p_obs > 1.0
    fire = over & ~brk
    rel_brake = ~over & brk
    if predictive:
        informed = (t2c & ~hpc & (p_raw > c.t2)
                    & (lp_frac < p_raw - c.t2))
        t2s = torch.where(informed, esc, t2s)
    hi2 = p_obs > c.t2
    cap_t2 = ~over & hi2 & ~t2c
    esc_tick = ~over & hi2 & t2c & ~hpc
    t2s = torch.where(cap_t2, 0, torch.where(esc_tick, t2s + 1, t2s))
    cap_hp = esc_tick & (t2s >= esc)
    cap_t1 = ~over & ~hi2 & (p_obs > c.t1) & ~t1c
    t2c_mid = t2c | over | cap_t2
    t1c_mid = t1c | over | cap_t2 | cap_t1
    hpc_mid = hpc | over | cap_hp
    rel_t2 = ~over & t2c_mid & (p_obs < c.t2 - c.t2_buf)
    t2c = t2c_mid & ~rel_t2
    hpc = hpc_mid & ~rel_t2
    rel_t1 = (~over & t1c_mid & ~t2c
              & (p_obs < c.t1 - c.t1_buf))
    t1c = t1c_mid & ~rel_t1
    nanv = torch.full_like(p_obs, float("nan"))
    lp_cmd = torch.where(rel_brake, c.lp_t2, nanv)
    hp_cmd = torch.where(rel_brake, c.hp_t2, nanv)
    lp_cmd = torch.where(cap_t2, c.lp_t2, lp_cmd)
    hp_cmd = torch.where(cap_hp, c.hp_t2, hp_cmd)
    lp_cmd = torch.where(cap_t1, c.lp_t1, lp_cmd)
    lp_cmd = torch.where(rel_t2, c.lp_t1, lp_cmd)
    hp_cmd = torch.where(rel_t2, 1.0, hp_cmd)
    lp_cmd = torch.where(rel_t1, 1.0, lp_cmd)
    return (PolcaLatches(t1c=t1c, t2c=t2c, hpc=hpc, brk=over, t2s=t2s),
            fire, lp_cmd, hp_cmd)


def apply_ring_tick(ring, f_lp, f_hp, k, *, ring_depth: int):
    """Pop the actuation ring at tick k: apply any due command per frequency
    field, clear the slot (in place). ``ring`` is ``[D, 2, ...]`` (NaN = no
    command). Returns ``(ring, f_lp', f_hp')``."""
    pend = ring[k % ring_depth]
    has = ~torch.isnan(pend)
    f_lp = torch.where(has[0], pend[0], f_lp)
    f_hp = torch.where(has[1], pend[1], f_hp)
    pend.fill_(float("nan"))
    return ring, f_lp, f_hp


def push_ring_commands(ring, fire, lp_cmd, hp_cmd, brake_freq, k, *,
                       oob_ticks: int, brake_ticks: int, ring_depth: int):
    """Queue this tick's commands (in place): OOB cap/release commands land
    ``oob_ticks`` ahead, brake commands ``brake_ticks`` ahead and overwrite
    both frequency fields (issued last, the DES same-due-time rule)."""
    oob_slot = ring[(k + oob_ticks) % ring_depth]
    oob_slot[0] = torch.where(torch.isnan(lp_cmd), oob_slot[0], lp_cmd)
    oob_slot[1] = torch.where(torch.isnan(hp_cmd), oob_slot[1], hp_cmd)
    brk_slot = ring[(k + brake_ticks) % ring_depth]
    brk_slot.copy_(torch.where(fire[None], brake_freq, brk_slot))
    return ring


def _tick_init(C: int, R: int, D: int, dtype, device):
    f_lp = torch.ones((C, R), dtype=dtype, device=device)
    f_hp = torch.ones((C, R), dtype=dtype, device=device)
    ring = torch.full((D, 2, C, R), float("nan"), dtype=dtype, device=device)
    zeros = dict(dtype=torch.bool, device=device)
    lat = PolcaLatches(
        t1c=torch.zeros((C, R), **zeros), t2c=torch.zeros((C, R), **zeros),
        hpc=torch.zeros((C, R), **zeros), brk=torch.zeros((C, R), **zeros),
        t2s=torch.zeros((C, R), dtype=torch.int32, device=device))
    nbr = torch.zeros((C, R), dtype=torch.int32, device=device)
    return f_lp, f_hp, ring, lat, nbr


def _tick_body(k, carry, occ_k, bscale_k, row_budget, c: TickConsts, *,
               oob_ticks, brake_ticks, ring_depth, esc):
    """One tick on a ``[C, R]`` member block (the kernel's per-thread loop
    body, vectorized)."""
    f_lp, f_hp, ring, lat, nbr = carry
    ring, f_lp, f_hp = apply_ring_tick(ring, f_lp, f_hp, k,
                                       ring_depth=ring_depth)
    rw = row_power_w(c, occ_k, f_lp, f_hp)
    tick_budget = row_budget * bscale_k  # [R] broadcast over members
    p_raw = rw / tick_budget
    # the non-predictive step reads no LP power share
    lat, fire, lp_cmd, hp_cmd = polca_latch_step(
        lat, p_raw, p_raw, None, c, esc=esc, predictive=False)
    ring = push_ring_commands(ring, fire, lp_cmd, hp_cmd, c.brake_freq, k,
                              oob_ticks=oob_ticks, brake_ticks=brake_ticks,
                              ring_depth=ring_depth)
    nbr = nbr + fire.to(torch.int32)
    return (f_lp, f_hp, ring, lat, nbr), rw, fire


def _planes(N: int, T: int, R: int, device) -> Dict[str, torch.Tensor]:
    """The four per-tick output planes, ``[N, T, R]``-shaped views of
    time-major ``[T, N, R]`` storage (the kernel's coalesced layout)."""
    def plane(dtype):
        return torch.empty((T, N, R), dtype=dtype,
                           device=device).permute(1, 0, 2)
    return dict(row_w=plane(torch.float64), fire=plane(torch.bool),
                f_lp=plane(torch.float64), f_hp=plane(torch.float64))


def polca_tick_plain(occ, bscale, row_budget, consts: TickConsts, *,
                     oob_ticks: int, brake_ticks: int, ring_depth: int,
                     esc: int) -> Dict[str, torch.Tensor]:
    """The kernel's plain PyTorch version: the same T-tick loop on the whole
    ``[N, R]`` lane block at once, writing the same output planes as
    :func:`polca_tick_loop` (time-major storage, ``[N, T, R]`` views)."""
    N, T, R = occ.shape
    carry = _tick_init(N, R, ring_depth, occ.dtype, occ.device)
    out = _planes(N, T, R, occ.device)
    for k in range(T):
        carry, rw, fi = _tick_body(
            k, carry, occ[:, k], bscale[k], row_budget, consts,
            oob_ticks=oob_ticks, brake_ticks=brake_ticks,
            ring_depth=ring_depth, esc=esc)
        out["row_w"][:, k] = rw
        out["fire"][:, k] = fi
        out["f_lp"][:, k] = carry[0]
        out["f_hp"][:, k] = carry[1]
    return dict(out, n_brakes=carry[4])


def freq_table(c: TickConsts) -> tuple:
    """Every value ``f_lp`` and ``f_hp`` can hold: the initial 1.0 and the
    value of each command the policy issues, in the order of the kernel's
    codes 1..5 (``csrc/tick.cu``: kOne, kLpT1, kLpT2, kHpT2, kBrake). The
    kernel's ring carries these codes in place of the values."""
    return (1.0, c.lp_t1, c.lp_t2, c.hp_t2, c.brake_freq)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/tick.cu)
# ---------------------------------------------------------------------------

# csrc/tick.cu kMaxRingDepth: the ring takes 2 bytes a slot for each of a
# block's 128 threads in shared memory, within the 227 KB a block can have
MAX_RING_DEPTH = 896

# the scalars the kernel reads, in the order of polca_tick_launch
_KERNEL_CONSTS = ("t1", "t2", "t1_buf", "t2_buf", "p0_srv_w", "k_lp_w",
                  "k_hp_w", "gamma", "n_servers", "power_scale")
_LAUNCH_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3   # occ, strides
                    + [ctypes.c_void_p] * 7    # bscale, row_budget, 5 outputs
                    + [ctypes.c_int] * 7       # N, T, R, oob, brake, D, esc
                    + [ctypes.c_double] * len(_KERNEL_CONSTS)
                    + [ctypes.POINTER(ctypes.c_double),  # freq_table
                       ctypes.c_int, ctypes.c_void_p])   # device, stream
_PLAN_ARGTYPES = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p]
_PLAN_KEYS = ("threads", "lanes_per_thread", "blocks", "blocks_per_sm",
              "sms", "ring_bytes", "max_ring_depth")


def _tick_lib() -> ctypes.CDLL:
    lib = _build.load("tick")
    if lib.polca_tick_launch.argtypes is None:
        lib.polca_tick_launch.argtypes = _LAUNCH_ARGTYPES
        lib.polca_tick_launch.restype = ctypes.c_int
        lib.polca_tick_plan.argtypes = _PLAN_ARGTYPES
        lib.polca_tick_plan.restype = ctypes.c_int
    return lib


def _check_ring(oob_ticks: int, brake_ticks: int, ring_depth: int) -> int:
    D = int(ring_depth)
    if not (1 <= int(oob_ticks) < D and 1 <= int(brake_ticks) < D):
        raise ValueError(f"ring_depth={D} must exceed oob_ticks={oob_ticks} "
                         f"and brake_ticks={brake_ticks} (both >= 1)")
    if D > MAX_RING_DEPTH:
        raise ValueError(f"ring_depth={D} exceeds the tick kernel's "
                         f"{MAX_RING_DEPTH} slots (its ring lives in shared "
                         f"memory)")
    return D


def _check(name, t, shape, dtype, device, contiguous=True):
    if t.device != device:
        raise ValueError(f"polca_tick_loop: {name} is on {t.device}, "
                         f"occ on {device}")
    if t.dtype != dtype:
        raise ValueError(f"polca_tick_loop: {name} must be {dtype}, "
                         f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"polca_tick_loop: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"polca_tick_loop: {name} must be contiguous")


def launch_plan(n_members: int, n_rows: int, ring_depth: int,
                device=None) -> Dict[str, float]:
    """How the kernel launches for ``n_members x n_rows`` lanes on a CUDA
    device: threads a block, lanes a thread, blocks, resident blocks an SM
    (CUDA's occupancy calculator for this build), SMs, ring bytes a block,
    the largest ring depth, and ``waves`` = blocks / (resident blocks a SM
    x SMs)."""
    index = None if device is None else torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    err = _tick_lib().polca_tick_plan(int(n_members) * int(n_rows),
                                      int(ring_depth), index, out)
    if err != 0:
        raise RuntimeError(f"polca_tick_plan failed: CUDA error {err} "
                           f"(ring_depth={ring_depth})")
    plan = dict(zip(_PLAN_KEYS, (int(v) for v in out)))
    plan["waves"] = plan["blocks"] / (plan["blocks_per_sm"] * plan["sms"])
    return plan


def polca_tick_loop(occ, bscale, row_budget, consts: TickConsts, *,
                    oob_ticks: int, brake_ticks: int, ring_depth: int,
                    esc: int) -> Dict[str, torch.Tensor]:
    """The non-predictive POLCA tick loop as one CUDA kernel launch.

    ``occ`` is the *effective* per-tick occupancy ``[N, T, R]`` (60 s-grid
    interpolation x row-alive mask, precomputed by the engine) in any
    layout: the kernel reads it through its strides, coalesced when it is a
    view of time-major ``[T, N, R]`` storage, as
    ``provisioning.batched.effective_occupancy`` builds it. ``bscale`` is
    the ``[T, R]`` fault budget scale, ``row_budget`` the ``[R]`` static
    budgets, both contiguous; all float64 on one CUDA device. ``ring_depth``
    is at most :data:`MAX_RING_DEPTH`. The kernel runs on PyTorch's current
    stream and does not synchronize.

    Returns ``dict(row_w=[N, T, R], fire=[N, T, R] bool,
    f_lp=[N, T, R], f_hp=[N, T, R], n_brakes=[N, R] int32)``; the four
    planes are views of time-major ``[T, N, R]`` storage.
    """
    D = _check_ring(oob_ticks, brake_ticks, ring_depth)
    if occ.device.type != "cuda":
        raise ValueError(f"polca_tick_loop launches a CUDA kernel; occ is on "
                         f"{occ.device} (ops.polca_tick takes the plain "
                         f"version for CPU tensors)")
    if occ.dim() != 3:
        raise ValueError(f"polca_tick_loop: occ must be [N, T, R], got "
                         f"shape {tuple(occ.shape)}")
    N, T, R = occ.shape
    dev = occ.device
    _check("occ", occ, (N, T, R), torch.float64, dev, contiguous=False)
    _check("bscale", bscale, (T, R), torch.float64, dev)
    _check("row_budget", row_budget, (R,), torch.float64, dev)
    out = dict(_planes(N, T, R, dev),
               n_brakes=torch.zeros((N, R), dtype=torch.int32, device=dev))
    if N * R == 0 or T == 0:
        return out
    freq = (ctypes.c_double * 5)(*freq_table(consts))
    err = _tick_lib().polca_tick_launch(
        occ.data_ptr(), *occ.stride(), bscale.data_ptr(),
        row_budget.data_ptr(), *(out[k].data_ptr() for k in
                                 ("row_w", "fire", "f_lp", "f_hp", "n_brakes")),
        N, T, R, int(oob_ticks), int(brake_ticks), D, int(esc),
        *(float(getattr(consts, f)) for f in _KERNEL_CONSTS), freq,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"polca_tick kernel launch failed: CUDA error "
                           f"{err} (N={N}, T={T}, R={R}, ring_depth={D})")
    polca_tick_loop.launches += 1
    return out


polca_tick_loop.launches = 0
