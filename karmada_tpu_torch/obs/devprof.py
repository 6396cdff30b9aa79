"""Device cost and memory attribution, and on-demand profiler capture.

Counterpart of the JAX package's ``obs/devprof.py``, with its contract:

  * **Cost ledger** -- ``record_cost()`` files one entry a warmed
    dispatch label (ops/aotcache feeds it a pow2 shape x variant).  The
    port has no XLA ``cost_analysis``: an entry is the CUDA-event device
    time of that label's one warm dispatch on the card, ``{"device_ms":
    t}``, and no flop or byte estimate.
  * **Memory attribution** -- ``refresh_memory_gauges()`` reads each
    card's ``torch.cuda.memory_stats`` / ``mem_get_info`` into the three
    kinds of the JAX package (in_use, peak, limit), plus the process RSS
    floor, sets the JAX package's gauges (karmada_device_memory_bytes by
    device and kind, karmada_process_memory_bytes) and keeps them in
    ``state_payload()["last_memory"]``.
  * **Profiler capture** -- ``capture_profile(seconds, out_dir)`` wraps a
    ``torch.profiler.profile(activities=[CPU, CUDA])`` window around K15
    ``marker_affine`` (ops/probe.py: it stamps a kernel of that name into
    an otherwise idle window, at the window's start and then every
    MARKER_EVERY_S) on the scheduler's card, exports a chrome trace
    under ``out_dir/profile-<stamp>/`` and reads it back: on a card the
    trace must hold a ``marker_affine`` kernel, or the capture answers
    not ok.  On a card the window lasts at least MIN_DEVICE_WINDOW_S: in a
    process that has profiled before, shorter windows lost their device
    records to the profiler (PERF.md §7); a window that lost them all is
    taken again, up to CAPTURE_WINDOWS.  One capture at a time: a second
    concurrent request answers busy.
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch

from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.utils.metrics import REGISTRY

DEVICE_MEMORY = REGISTRY.gauge(
    "karmada_device_memory_bytes",
    "Per-device memory_stats() attribution (bytes), by device and kind "
    "(in_use / peak / limit); absent on backends that report no stats",
    ("device", "kind"),
)
PROCESS_MEMORY = REGISTRY.gauge(
    "karmada_process_memory_bytes",
    "Host process memory (bytes) by kind (rss) — the attribution floor "
    "on backends whose devices report no memory_stats",
    ("kind",),
)
CAPTURES = REGISTRY.counter(
    "karmada_devprof_captures_total",
    "On-demand jax.profiler capture windows completed, by outcome",
    ("outcome",),
)

#: memory kinds exported per card: the JAX key -> its kind label
_MEM_KEYS = (("bytes_in_use", "in_use"),
             ("peak_bytes_in_use", "peak"),
             ("bytes_limit", "limit"))

#: the capture window's cap: a capture is a debugging act, not a service
MAX_CAPTURE_S = 60.0

#: the chrome trace's file name inside a capture's directory
TRACE_FILE = "trace.json"

#: the shortest capture window on a card: in a process that had profiled
#: before, 1 s windows lost their device records in most captures and 4 s
#: windows in none (torch 2.11 with CUDA 12.8 on an H100; PERF.md §7)
MIN_DEVICE_WINDOW_S = 4.0

#: K15 is launched at the window's start and then every MARKER_EVERY_S
MARKER_EVERY_S = 1.0

#: windows a capture on a card takes at most: a window whose device
#: records the profiler lost is taken again (one 4 s window in 14 lost
#: them all; tools/profile_windows.py, PERF.md §7)
CAPTURE_WINDOWS = 2

_LOCK = threading.Lock()
# guarded-by: _LOCK
_STATE: Dict[str, object] = {
    "costs": {},          # label -> {"device_ms": t}
    "last_memory": None,  # the last refresh
    "last_capture": None, # the last capture_profile outcome
}
_CAPTURE_GATE = threading.Lock()  # one profiler window at a time


def record_cost(label: str, cost: Optional[dict]) -> None:
    """File one warmed dispatch's cost under its shape x variant label."""
    if not cost:
        return
    with _LOCK:
        _STATE["costs"][label] = dict(cost)


def cost_ledger() -> Dict[str, dict]:
    with _LOCK:
        return {k: dict(v) for k, v in _STATE["costs"].items()}


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def _cards(devices: Optional[Sequence]) -> List[int]:
    """Card indices of `devices` (indices, "cuda:i" or torch.devices);
    None: every visible card (none without CUDA)."""
    if devices is None:
        return (list(range(torch.cuda.device_count()))
                if torch.cuda.is_available() else [])
    return [d if isinstance(d, int) else torch.device(d).index or 0
            for d in devices]


def _card_stats(i: int) -> dict:
    s = torch.cuda.memory_stats(i)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1])}


def memory_stats_payload(devices: Optional[Sequence] = None) -> List[dict]:
    """Per card ``{"device": "cuda:i", "memory_stats": {bytes_in_use,
    peak_bytes_in_use, bytes_limit}}``: the probe's MEMSTATS shape."""
    return [{"device": f"cuda:{i}", "memory_stats": _card_stats(i)}
            for i in _cards(devices)]


def refresh_memory_gauges(devices: Optional[Sequence] = None) -> int:
    """Read every card's memory kinds (+ the process RSS) into
    state_payload()["last_memory"]; returns how many per-card values were
    read."""
    updated = 0
    summary: List[dict] = []
    for rec in memory_stats_payload(devices):
        row = {"device": rec["device"]}
        for key, kind in _MEM_KEYS:
            row[kind] = rec["memory_stats"][key]
            DEVICE_MEMORY.set(float(row[kind]), device=rec["device"],
                              kind=kind)
            updated += 1
        summary.append(row)
    rss = _rss_bytes()
    if rss is not None:
        PROCESS_MEMORY.set(float(rss), kind="rss")
    with _LOCK:
        _STATE["last_memory"] = {"at_unix": round(time.time(), 3),
                                 "devices": summary, "rss_bytes": rss}
    return updated


def _artifacts_under(root: str) -> List[dict]:
    files = []
    for r, _dirs, fns in os.walk(root):
        for fn in fns:
            p = os.path.join(r, fn)
            try:
                files.append({"path": os.path.relpath(p, root),
                              "bytes": os.path.getsize(p)})
            except OSError:
                continue
    return sorted(files, key=lambda f: f["path"])


def _note_capture(rec: dict) -> dict:
    with _LOCK:
        _STATE["last_capture"] = rec
    return rec


def _trace_kernels(path: str) -> List[str]:
    """The names of the device kernel events in a chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [str(e.get("name", "")) for e in events
            if e.get("cat") == "kernel"]


def _window(acts, a: torch.Tensor, window: float) -> "torch.profiler.profile":
    """One profiler window of `window` seconds with K15 launched on `a`
    at its start and every MARKER_EVERY_S (each launch synchronised)."""
    from karmada_tpu_torch.ops import probe

    marks = max(1, math.ceil(window / MARKER_EVERY_S))
    with torch.profiler.profile(activities=acts) as prof:
        w0 = time.perf_counter()
        for i in range(marks):
            wait = w0 + i * MARKER_EVERY_S - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            with torch.profiler.record_function("marker_affine"):
                probe.marker_affine(a)
            if a.is_cuda:
                torch.cuda.synchronize(a.device)
        remaining = w0 + window - time.perf_counter()
        if remaining > 0:
            time.sleep(remaining)
    return prof


def capture_profile(seconds: float, out_dir: str, device=None) -> dict:
    """One bounded profiler capture: start the profiler, launch K15 on
    `device` (the first card by default; "cpu" runs its plain version
    under a CPU-only window) at the window's start and every
    MARKER_EVERY_S, keep the window open `seconds` (capped at
    MAX_CAPTURE_S; at least MIN_DEVICE_WINDOW_S on a card), stop, export
    the chrome trace and inventory what landed on disk.  On a card the
    trace must hold a ``marker_affine`` kernel: a window whose device
    records the profiler lost (its trace kept as ``lost-<i>.json``) is
    taken again, up to CAPTURE_WINDOWS windows, and the capture answers
    not ok when every one lost them.  `windows` / `lost_windows` say how
    it went.  A failure is answered as ``{"ok": False, "error": ...}``:
    the debug surface answers, it does not raise."""
    requested = min(max(float(seconds), 0.0), MAX_CAPTURE_S)
    if not _CAPTURE_GATE.acquire(blocking=False):
        CAPTURES.inc(outcome="busy")
        # `busy` is the structured flag a caller maps to 409
        return {"ok": False, "busy": True,
                "error": "a profiler capture is already running; one "
                         "window at a time"}
    t0 = time.perf_counter()
    window = requested
    try:
        dev = resolve_device(device)
        on_card = dev.type == "cuda"
        if on_card:
            window = min(max(requested, MIN_DEVICE_WINDOW_S), MAX_CAPTURE_S)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        dest = os.path.join(out_dir, f"profile-{stamp}")
        os.makedirs(dest, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        a = torch.arange(128, device=dev)
        trace = os.path.join(dest, TRACE_FILE)
        lost = 0
        for _ in range(CAPTURE_WINDOWS if on_card else 1):
            _window(acts, a, window).export_chrome_trace(trace)
            names = _trace_kernels(trace)
            seen = sum(1 for n in names if "marker_affine" in n)
            if seen or not on_card:
                break
            lost += 1
            os.replace(trace, os.path.join(dest, f"lost-{lost}.json"))
        marks = max(1, math.ceil(window / MARKER_EVERY_S))
        files = _artifacts_under(dest)
        rec = {
            "ok": True,
            "dir": dest,
            "device": str(dev),
            "seconds": window,
            "requested_s": requested,
            "wall_s": round(time.perf_counter() - t0, 3),
            "windows": lost + (1 if seen or not on_card else 0),
            "lost_windows": lost,
            "markers": marks,
            "device_kernels": len(names),
            "marker_kernels": seen,
            # the window's device kernels by name (the 32 most launched):
            # K15's marker and whatever the serving cycles launched
            "kernels": dict(collections.Counter(names).most_common(32)),
            "files": files,
            "total_bytes": sum(f["bytes"] for f in files),
        }
        if on_card and not seen:
            rec.update(ok=False, error=(
                f"the profiler recorded no device activity in any of "
                f"{lost} windows (none of their marker_affine kernels "
                "is in the traces)"))
        CAPTURES.inc(outcome="ok" if rec["ok"] else "error")
        return _note_capture(rec)
    except Exception as e:  # noqa: BLE001 — answered as the outcome
        CAPTURES.inc(outcome="error")
        return _note_capture({"ok": False, "error": repr(e)[:400],
                              "seconds": window})
    finally:
        _CAPTURE_GATE.release()


def state_payload() -> dict:
    """The cost ledger, the last memory refresh and the last capture."""
    with _LOCK:
        return {
            "costs": {k: dict(v) for k, v in _STATE["costs"].items()},
            "last_memory": _STATE["last_memory"],
            "last_capture": _STATE["last_capture"],
        }


def reset_for_tests() -> None:
    with _LOCK:
        _STATE["costs"] = {}
        _STATE["last_memory"] = None
        _STATE["last_capture"] = None
