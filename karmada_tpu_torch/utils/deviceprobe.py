"""Out-of-process device health probe and the serve path's backend policy.

Counterpart of the JAX package's ``utils/deviceprobe.py``, with its
contract and return shapes.  A card fails in two ways a process cannot
recover from in-process: a fast error at context creation, and a hang
inside a launch or a synchronise.  Probing in a subprocess under a
timeout bounds both.

The probe subprocess (``_PROBE_SNIPPET``, run with this interpreter)
imports only ``karmada_tpu_torch.ops.kernels`` and ``.ops.probe``, builds
the kernels (a cache hit once this process has built them, nvcc for every
source on a cold build directory: ``timeout_s`` has to cover that), and
launches K14 ``probe_mm`` (ops/csrc/probe.cu, not a library matmul) on a
128 x 128 bf16 matrix of ones on every visible card, checking that every
entry is 128.  So an ``ok`` probe says that the port's own kernel path
works on each card: the build, the ctypes load and a launch.  It prints
``PLATFORM=gpu``, ``NDEV=`` (``torch.cuda.device_count()``), ``LAUNCHES=``
(its own K14 launch count) and ``MEMSTATS=`` (one entry per card,
``{"device": "cuda:i", "memory_stats": {...}}`` with the JAX key names:
``bytes_in_use`` from ``allocated_bytes.all.current``,
``peak_bytes_in_use`` from ``allocated_bytes.all.peak``, ``bytes_limit``
the card's total from ``torch.cuda.mem_get_info``).  Without a card the
snippet fails and the probe reports ``ok: False``; it never answers
"cpu".

``resolve_backend`` is the JAX package's serve policy: a scheduler asked
for the device backend runs on the card only when the probe answered with
an accelerator, and otherwise takes the fastest working host backend
(native, else serial), always saying why in ``diag["degraded"]``.

The port has no metrics registry yet, so the probe history lives in
``last_probe()`` alone; the JAX package's probe gauges wait for it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

_LAST_LOCK = threading.Lock()
# guarded-by: _LAST_LOCK
_LAST: dict = {"probed": False, "ok": None, "platform": None,
               "devices": None, "elapsed_s": None,
               "consecutive_failures": 0, "at_unix": None, "error": None}

#: the checkout root the subprocess imports the port from
_ROOT = str(Path(__file__).resolve().parents[2])


def record_probe(diag: dict) -> None:
    """Fold one probe_backend() result into the history last_probe()
    reads."""
    attempts = diag.get("attempts") or []
    last = attempts[-1] if attempts else {}
    ok = bool(diag.get("ok"))
    with _LAST_LOCK:
        _LAST.update(
            probed=True, ok=ok,
            platform=diag.get("platform"),
            devices=diag.get("device_count"),
            elapsed_s=last.get("s"),
            at_unix=round(time.time(), 3),
            error=None if ok else str(last.get("err", ""))[:200],
        )
        _LAST["consecutive_failures"] = (
            0 if ok else _LAST["consecutive_failures"] + 1)


def last_probe() -> dict:
    """Snapshot of the most recent probe outcome."""
    with _LAST_LOCK:
        return dict(_LAST)


_PROBE_SNIPPET = (
    "import json, sys\n"
    f"sys.path.insert(0, {_ROOT!r})\n"
    "import torch\n"
    "from karmada_tpu_torch.ops import kernels, probe\n"
    "n = torch.cuda.device_count()\n"
    "if n == 0:\n"
    "    raise SystemExit('no CUDA device is visible')\n"
    "kernels.build()\n"
    "ms = []\n"
    "for i in range(n):\n"
    "    with torch.cuda.device(i):\n"
    "        a = torch.ones((128, 128), dtype=torch.bfloat16,\n"
    "                       device=f'cuda:{i}')\n"
    "        c = probe.probe_mm(a)\n"
    "        torch.cuda.synchronize(i)\n"
    "        if not bool((c.float() == 128).all()):\n"
    "            raise SystemExit(f'probe_mm on cuda:{i} gave wrong values')\n"
    "        s = torch.cuda.memory_stats(i)\n"
    "        total = torch.cuda.mem_get_info(i)[1]\n"
    "    ms.append({'device': f'cuda:{i}', 'memory_stats': {\n"
    "        'bytes_in_use': int(s.get('allocated_bytes.all.current', 0)),\n"
    "        'peak_bytes_in_use': int(s.get('allocated_bytes.all.peak', 0)),\n"
    "        'bytes_limit': int(total)}})\n"
    "print('PLATFORM=gpu')\n"
    "print('NDEV=' + str(n))\n"
    "print('LAUNCHES=' + json.dumps(\n"
    "    {'probe_mm': kernels.LAUNCHES['probe_mm']}))\n"
    "print('MEMSTATS=' + json.dumps(ms))\n"
)

#: platforms worth running the device backend on
ACCELERATOR_PLATFORMS = ("tpu", "gpu", "cuda", "rocm")


def probe_backend(timeout_s: float = 330.0) -> dict:
    """Probe the cards out of process.

    Returns ``{"ok": bool, "platform": str|None, "device_count": int|None,
    "memory_stats": [...]|None, "launches": {...}|None, "attempts":
    [...]}``: ``ok`` means the subprocess built the kernels and ran K14 on
    every visible card within the budget; ``platform`` is then "gpu";
    ``device_count`` how many cards answered; ``launches`` the
    subprocess's own launch counts (K14 once a card)."""
    diag = {"ok": False, "platform": None, "device_count": None,
            "memory_stats": None, "launches": None, "attempts": []}
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_SNIPPET],
            capture_output=True, text=True, timeout=timeout_s,
        )
        elapsed = round(time.perf_counter() - t0, 1)
        platform = None
        for line in r.stdout.splitlines():
            key, _, val = line.partition("=")
            try:
                if key == "NDEV":
                    diag["device_count"] = int(val)
                elif key == "MEMSTATS":
                    diag["memory_stats"] = json.loads(val)
                elif key == "LAUNCHES":
                    diag["launches"] = json.loads(val)
            except ValueError:
                pass
            if key == "PLATFORM":
                platform = val
        if platform is not None and r.returncode == 0:
            diag.update(ok=True, platform=platform)
            diag["attempts"].append({"ok": True, "s": elapsed})
            record_probe(diag)
            return diag
        diag["attempts"].append({
            "ok": False, "s": elapsed, "rc": r.returncode,
            "err": (r.stderr or r.stdout)[-400:],
        })
    except subprocess.TimeoutExpired:
        diag["attempts"].append({
            "ok": False, "s": round(time.perf_counter() - t0, 1),
            "err": f"probe timed out after {timeout_s}s (backend init hang)",
        })
    record_probe(diag)
    return diag


def resolve_backend(requested: str, probe_timeout_s: float = 240.0,
                    probe=None) -> tuple:
    """Pick the backend a long-lived scheduler should actually run.

    - ``requested != "device"``: returned unchanged, no probe spent.
    - ``requested == "device"``: probe the cards out of process.  Only a
      live accelerator keeps the device backend; a dead or hung probe --
      or one that answered with the host CPU -- degrades to ``native``
      (the compiled C++ control) when its toolchain works, else
      ``serial``.

    Returns ``(effective_backend, diag)``; ``diag["degraded"]`` explains a
    reroute.  ``probe`` is injectable for tests."""
    if requested != "device":
        return requested, {"probed": False}
    diag = dict((probe or probe_backend)(timeout_s=probe_timeout_s))
    if probe is not None:
        # probe_backend records its own history; an injected probe's
        # outcome reaches it the same way
        record_probe(diag)
    platform = str(diag.get("platform") or "").lower()
    if diag.get("ok") and any(p in platform for p in ACCELERATOR_PLATFORMS):
        return "device", diag
    from karmada_tpu_torch import native

    if diag.get("ok"):
        # the device program works but only on the host CPU: the native
        # control is faster there, the serial loop slower
        if not native.available():
            return "device", diag
        fallback = "native"
        why = f"device probe answered platform={platform!r} (no accelerator)"
    else:
        # the card is dead or hung: take the fastest engine without it
        fallback = "native" if native.available() else "serial"
        why = "device probe failed"
    diag["degraded"] = (
        f"{why}; the device program on the host CPU is slower than the "
        f"{fallback} backend — rerouting to backend={fallback}")
    return fallback, diag
