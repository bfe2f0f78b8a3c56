"""One profiled slice of a cell's work, read from the profiler's device
trace: how long the device was busy, which device operations took the
time, and what the host was doing while the device stood idle.

The profiler is driven through the calls ``torch.profiler`` itself makes,
and its raw events are read without building ``torch.profiler``'s table
of events, which costs about 0.1 ms an event: a slice of millions of
events is read in seconds.  Only the summary is kept; no trace file is
written.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

TOP = 10
#: idle gaps shorter than this are counted together, not named
NAMED_GAP_S = 20e-6
SHORT_GAPS = "gaps under 20 us between device operations"
BEFORE_FIRST = "before the first device operation"
#: a gap no recorded host event covers
HOST_IDLE = {True: "host idle", False: "host outside any CUDA call"}


def _merge(starts: np.ndarray, ends: np.ndarray
           ) -> Tuple[float, np.ndarray, np.ndarray]:
    """(busy seconds, gap starts, gap ends) of the union of intervals."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    gap = s[1:] > e[:-1]
    gap_start, gap_end = e[:-1][gap], s[1:][gap]
    span = e[-1] - s[0]
    return float(span - np.sum(gap_end - gap_start)), gap_start, gap_end


def _host_names(cpu: List[Tuple[int, int, str]], times: List[float],
                idle: str) -> List[str]:
    """The innermost host event running at each of ``times`` (sorted): the
    latest to start among those that cover it.  ``cpu`` is sorted by
    start; one sweep, so a slice of many gaps and events stays cheap."""
    names, active, j = [], [], 0
    for t in times:
        while j < len(cpu) and cpu[j][0] <= t:
            active.append(cpu[j])
            j += 1
        while active and active[-1][1] < t:
            active.pop()
        names.append(active[-1][2] if active else idle)
    return names


def profiled(fn: Callable[[], object], host_ops: bool = True
             ) -> Dict[str, object]:
    """Run ``fn`` once under the profiler -> ``window_s`` (host clock, the
    device synchronised at both ends), ``busy_s`` (the union of the device
    operations' intervals), ``device_ops`` (the ``TOP`` operations by
    time), ``idle_gaps`` (idle time by what the host was doing, ``TOP``
    names) and ``kernel_s`` (every device operation's seconds by name).

    ``host_ops`` records every host operation; without it the host is
    seen only in its CUDA calls, which keeps a slice of many eager
    operations cheap to record."""
    from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
    from torch.autograd.profiler import (
        ProfilerConfig, ProfilerState, _disable_profiler, _enable_profiler,
        _prepare_profiler,
    )

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ({ProfilerActivity.CUDA} if cuda else set())
    if host_ops or not cuda:
        acts.add(ProfilerActivity.CPU)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    _prepare_profiler(config, acts)
    sync()
    _enable_profiler(config, acts)
    t0 = time.perf_counter()
    try:
        fn()
        sync()
    finally:
        window_s = time.perf_counter() - t0
        results = _disable_profiler()
    dev_s, dev_e, cpu = [], [], []
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for ev in results.events():
        start, dur = ev.start_ns(), ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation() or ev.name().startswith("bench."):
                continue        # a host range mirrored on the device
            dev_s.append(start)
            dev_e.append(start + dur)
            kernel_s[ev.name()] += dur * 1e-9
        else:
            cpu.append((start, start + dur, ev.name()))
    if not dev_s:
        return {"window_s": window_s, "busy_s": 0.0, "device_ops": [],
                "idle_gaps": [], "kernel_s": {}}
    starts, ends = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    busy_ns, g0, g1 = _merge(starts, ends)
    cpu.sort()
    idle: Dict[str, float] = collections.defaultdict(float)
    lead = (int(starts.min()) - cpu[0][0]) if cpu else 0
    if lead > 0:
        idle[BEFORE_FIRST] += lead * 1e-9
    sec = (g1 - g0) * 1e-9
    short = sec < NAMED_GAP_S
    idle[SHORT_GAPS] += float(np.sum(sec[short]))
    mids = ((g0[~short] + g1[~short]) / 2).tolist()
    for name, s in zip(_host_names(cpu, mids, HOST_IDLE[host_ops]),
                       sec[~short].tolist()):
        idle[name] += s
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy_ns * 1e-9,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in gaps],
            "kernel_s": dict(kernel_s)}
