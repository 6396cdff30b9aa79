#!/usr/bin/env python3
"""Which torch.profiler windows keep their device records, on one card.

obs/devprof.capture_profile stamps K15 marker_affine into a profiler
window and reads the kernel back from the chrome trace.  In a process
that has profiled before, short windows can come back with the CPU side
whole (the launch's cuda_runtime event) and no device kernel event.  This
script measures that: rounds of a gap (idle, or K15 and an elementwise op
on the card from two threads, in turns), each followed by back-to-back
windows, in this order:

  start1   a 1 s window, K15 launched at its start
  mid1     a 1 s window, K15 launched half-way
  start4   a 4 s window, K15 launched at its start
  capture  devprof.capture_profile(1.0) as the port runs it (a 4 s
           window on a card, K15 every second, a lost window taken
           again); its line also says how many windows it lost
  mid1b    as mid1
  start1b  as start1

and prints, per window kind, in how many rounds the trace held K15's
kernel, with each kept kernel's start minus its launch (microseconds, by
correlation id).  Run from the root of a checkout, on a machine with a
card and nvcc (the kernels build first):

    python3 tools/profile_windows.py [--rounds 7] [--gap 20]

The profiler's own environment switches (TEARDOWN_CUPTI=0, ...) are set
by the caller, as in ``TEARDOWN_CUPTI=0 python3 tools/profile_windows.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from karmada_tpu_torch.obs import devprof  # noqa: E402
from karmada_tpu_torch.ops import kernels, probe  # noqa: E402

WINDOWS = (("start1", 1.0, False), ("mid1", 1.0, True),
           ("start4", 4.0, False), ("capture", None, None),
           ("mid1b", 1.0, True), ("start1b", 1.0, False))


def marker_kernels(path: str):
    """(kept, [kernel start - launch, us]) of K15 in a chrome trace."""
    with open(path) as f:
        ev = json.load(f).get("traceEvents", [])
    launch = {e["args"].get("correlation"): float(e["ts"]) for e in ev
              if e.get("cat") == "cuda_runtime" and "args" in e}
    ks = [e for e in ev if e.get("cat") == "kernel"
          and e.get("name") == "marker_affine_i64"]
    return bool(ks), [round(float(k["ts"]) - launch[k["args"]["correlation"]])
                      for k in ks
                      if k.get("args", {}).get("correlation") in launch]


def window(seconds: float, mid: bool):
    a = torch.arange(128, device="cuda:0")
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if mid:
                time.sleep(seconds / 2)
            probe.marker_affine(a)
            torch.cuda.synchronize()
            left = seconds - (time.perf_counter() - t0)
            if left > 0:
                time.sleep(left)
        prof.export_chrome_trace(path)
        return marker_kernels(path)


def capture():
    with tempfile.TemporaryDirectory() as tmp:
        rec = devprof.capture_profile(1.0, tmp)
        if not rec.get("files"):
            return False, [], rec.get("lost_windows")
        return marker_kernels(os.path.join(
            rec["dir"], devprof.TRACE_FILE)) + (rec["lost_windows"],)


def load(seconds: float) -> None:
    """K15 on 2^20 elements from one thread, an elementwise op from
    another, for `seconds`."""
    stop = time.perf_counter() + seconds
    x = torch.randn(2048, 2048, device="cuda:0")
    a = torch.arange(1 << 20, device="cuda:0")

    def marks():
        while time.perf_counter() < stop:
            for _ in range(50):
                probe.marker_affine(a)
            torch.cuda.synchronize()
    t = threading.Thread(target=marks)
    t.start()
    while time.perf_counter() < stop:
        x = x * 1.0001
        torch.cuda.synchronize()
    t.join()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--gap", type=float, default=20.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_windows: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}", flush=True)
    kernels.build()
    t0 = time.perf_counter()
    kept = {name: 0 for name, _s, _m in WINDOWS}
    kept["capture's first window"] = 0
    for r in range(args.rounds):
        if r % 2:
            load(args.gap)
        else:
            time.sleep(args.gap)
        line = []
        for name, seconds, mid in WINDOWS:
            if seconds is None:
                ok, offs, lost = capture()
                kept["capture's first window"] += lost == 0
                line.append(f"{name} {'kept' if ok else 'lost'} {offs} "
                            f"(windows lost {lost})")
            else:
                ok, offs = window(seconds, mid)
                line.append(f"{name} {'kept' if ok else 'lost'} {offs}")
            kept[name] += ok
        print(f"round {r} (t={time.perf_counter() - t0:.1f} s, after "
              f"{'load' if r % 2 else 'idle'}): " + "; ".join(line),
              flush=True)
    print("kept, of " + str(args.rounds) + " rounds: " + ", ".join(
        f"{k} {v}" for k, v in kept.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
