"""The card's identity, as every measurement of the port records it, and
the timers of `chip_smoke.py` and `tools/occupancy_ab.py`, whose primer
`tools/profile_step.py` shares."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# What opens every profile of these timers, inside its window: idle
# seconds, then spin kernels (torch.cuda._sleep, a few us each) and a
# synchronisation. On an H100 80GB HBM3 torch.profiler lost the records
# of a window's first kernels: in a process that slept between profiles,
# more of them as the process aged, which a few ms of lead ended; late in
# `chip_smoke.py` (after its learning run), a handful in about half the
# profiles whatever the lead, which spin kernels ahead of the calls took
# instead. The spin kernels' records are left out of the results.
PROFILE_LEAD_S = 0.01
PRIMER_KERNELS = 32
PRIMER_SYMBOL = "spin_kernel"
# device_ms: the median of this many complete profiles, out of at most
# ATTEMPTS
PROFILES = 3
ATTEMPTS = 6


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W". Raises where nvidia-smi is missing
    or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, windows: int = 5, warmup: int = 3) -> float:
    """Time of one fn() call in ms: after `warmup` calls, one CUDA-event
    pair around `reps` back-to-back calls, divided by `reps`; the median
    over `windows` such windows. Where the host work of a call outlasts
    the kernels it launches, the device waits and this time is the
    host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, reps: int = 50, windows: int = 5) -> float:
    """Host time of one fn() call in us: a host clock over `reps`
    back-to-back calls with no synchronisation among them (after one
    that empties the queue), divided by `reps`; the median over `windows`
    such windows. The device's time is not in it while the queue holds
    fewer launches than it takes."""
    times = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def prime() -> None:
    """The primer above, first inside a profile's window: PROFILE_LEAD_S
    of idle, PRIMER_KERNELS spin kernels, a synchronisation."""
    time.sleep(PROFILE_LEAD_S)
    for _ in range(PRIMER_KERNELS):
        torch.cuda._sleep(10_000)
    torch.cuda.synchronize()


def profiled(fn, reps: int) -> list:
    """torch.profiler (CPU and CUDA) over `reps` back-to-back fn() calls,
    after the primer above inside the window -> the device ops of the
    calls (key_averages' CUDA entries, the primer's left out)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        prime()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [e for e in p.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and PRIMER_SYMBOL not in e.key]


def device_ms(fn, reps: int = 50) -> float:
    """The device's self time of every op that one fn() call runs, in ms:
    `profiled` over `reps` calls, divided by `reps`; the median of
    PROFILES profiles. Host time between the ops is not in it. A
    profile counts only where it kept every op of those calls: each port
    kernel's events equal the launches its wrapper counted in the window,
    and every other op's events are a multiple of `reps`. One that lost
    some is taken again, up to ATTEMPTS profiles in all; then it
    raises. (The median: one complete profile late in `chip_smoke.py`'s
    run read half of its kernel's time, below the kernel's bound.)"""
    from voxelnet_tpu_torch.kernels import launch_counts
    from voxelnet_tpu_torch.tools.profile_step import port_kernel

    got, lost = [], {}
    for _ in range(ATTEMPTS):
        before = launch_counts()
        ops = profiled(fn, reps)
        want = {k: n - before[k] for k, n in launch_counts().items()}
        kept = dict.fromkeys(want, 0)
        busy, lost = 0.0, {}
        for e in ops:
            busy += e.self_device_time_total
            kernel = port_kernel(e.key)
            if kernel is not None:
                kept[kernel] += e.count
            elif e.count % reps:
                lost[e.key[:80]] = f"{e.count} events in {reps} calls"
        lost.update({k: f"{kept[k]} events of {n} launches"
                     for k, n in want.items() if kept[k] != n})
        if busy > 0 and not lost:
            got.append(busy / 1e3 / reps)
            if len(got) == PROFILES:
                return statistics.median(got)
    raise RuntimeError(f"torch.profiler lost device events in "
                       f"{ATTEMPTS - len(got)} of {ATTEMPTS} profiles of "
                       f"{reps} calls, the last: "
                       f"{lost or 'no device time'}")


def device_ops(fn, reps: int = 10) -> dict:
    """Each device op (kernel, memcpy, memset) that one fn() call runs ->
    its events a call: `profiled` over `reps` calls after a warm-up
    call."""
    fn()
    torch.cuda.synchronize()
    return {e.key: e.count / reps for e in profiled(fn, reps)}
