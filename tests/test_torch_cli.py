"""The port CLI (`python -m karmada_tpu_torch.cli`) against the JAX CLI,
on temporary plane directories, in process (`cli.main`), tolerance 0.

- `init` / `join` / `apply` / `tick` / `get` / `delete`: stdout equal,
  command for command (uids from a counter on both sides: a template's
  uid breaks scheduling ties).  The first tick disables `unified-auth`
  on both planes: the JAX package runs that controller (the port has not
  taken it, ROADMAP Queue A item 9) and its reconciles would show in the
  tick's count.
- `serve`'s argument errors: the same exit code and stderr.
- `loadgen`: the catalog equal; `loadgen steady`'s, `chaos`'s and
  `hotspot`'s SOAK JSON equal but for `wall_s`, the seconds of
  `stage_utilization` (its span names and counts stay) and the chaos
  fire log's wall-clock stamps (tests/torch_soak.comparable; the
  rebalance and resident sections without the keys one package alone
  reports, named in tests/torch_soak.cross_comparable), each run
  into a fresh process ledger with the Schedulers' host clock still (the
  e2e samples are floored at a cycle's wall seconds: tests/torch_soak).
- `serve --chaos SPEC --telemetry RING --slo-deadline S` on a host
  backend arms the chaos, telemetry and incident planes, serves until
  interrupted and exits 0.
- Every verb and flag the port refuses exits 1 and names its ROADMAP
  Queue A item.
- `estimate` against a port FacadeService over TCP: both CLIs get the
  same answer (trace and batch ids masked).
"""

import dataclasses
import importlib
import itertools
import json
import threading

import pytest

from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_soak import (
    comparable,
    cross_comparable,
    fresh_ledger,
    frozen_cycle_clock,
)

PKGS = ("karmada_tpu", "karmada_tpu_torch")
CLI = {pkg: importlib.import_module(f"{pkg}.cli") for pkg in PKGS}

APP = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: nginx
  namespace: default
spec:
  replicas: 5
  template:
    spec:
      containers:
      - name: nginx
        image: nginx
        resources:
          requests:
            cpu: 500m
---
apiVersion: policy.karmada.io/v1alpha1
kind: PropagationPolicy
metadata:
  name: nginx-pp
  namespace: default
spec:
  resourceSelectors:
  - apiVersion: apps/v1
    kind: Deployment
    name: nginx
  placement:
    replicaScheduling:
      replicaSchedulingType: Divided
      replicaDivisionPreference: Weighted
"""


@pytest.fixture(autouse=True)
def deterministic_uids(monkeypatch):
    for name in PKGS:
        seq = itertools.count(1)
        monkeypatch.setattr(importlib.import_module(f"{name}.store.store"),
                            "new_uid", lambda seq=seq: f"uid-{next(seq):06d}")


def run(pkg, argv, capsys):
    capsys.readouterr()
    try:
        rc = CLI[pkg].main(argv)
    except SystemExit as e:  # argparse
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


FLOW = [
    ["init"],
    ["join", "m1", "--cpu", "8"],
    ["join", "m2", "--cpu", "16", "--region", "r1"],
    ["join", "m2"],
    ["apply", "-f", "app.yaml"],
    ["tick", "--controllers", "*,-unified-auth"],
    ["get", "ResourceBinding"],
    ["get", "ResourceBinding", "nginx-deployment", "-n", "default"],
    ["get", "Cluster"],
    ["get", "Deployment", "-n", "default"],
    ["label", "Cluster", "m1", "tier=gold"],
    ["cordon", "m2"],
    ["tick"],
    ["get", "Cluster"],
    ["uncordon", "m2"],
    ["taint", "m1", "k=v:NoSchedule"],
    ["taint", "m1", "k-"],
    ["delete", "Deployment", "nginx", "-n", "default"],
    ["delete", "Deployment", "nginx", "-n", "default"],
    ["tick"],
    ["get", "ResourceBinding"],
    ["unjoin", "m1"],
    ["get", "Cluster"],
]


def test_plane_flow_stdout_equal(tmp_path, capsys, monkeypatch):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        (d / "app.yaml").write_text(APP)
        monkeypatch.chdir(d)
        got[pkg] = [run(pkg, ["--dir", "plane", *argv], capsys)[:2]
                    for argv in FLOW]
    j, p = got["karmada_tpu"], got["karmada_tpu_torch"]
    for argv, a, b in zip(FLOW, j, p):
        assert b == a, argv
    # the schedule really landed: the binding's placement is printed
    assert "m1:" in p[6][1] and "m2:" in p[6][1]


def test_tick_device_without_a_card_refuses(tmp_path, capsys, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the device tick runs there")
    monkeypatch.chdir(tmp_path)
    run("karmada_tpu_torch", ["--dir", "plane", "init"], capsys)
    rc, out, err = run("karmada_tpu_torch",
                       ["--dir", "plane", "tick", "--backend", "device"],
                       capsys)
    assert rc == 1 and "no CUDA device" in err


SERVE_ERRORS = [
    ["serve", "--backend", "tpu"],
    ["serve", "--batch-window", "many"],
    ["serve", "--explain", "2"],
    ["serve", "--explain", "lots"],
    ["serve", "--shortlist", "-3"],
    ["serve", "--shortlist", "k"],
    ["serve", "--rebalance", "0"],
    ["serve", "--rebalance", "soon"],
    ["serve", "--loadgen", "no-such-scenario"],
    ["serve", "--facade", "nowhere"],
    ["serve", "--chaos", "nope.site:raise"],
    ["serve", "--chaos", "estimator.rpc:error@2.0"],
    ["serve", "--no-such-flag"],
    ["bogus-verb"],
]


@pytest.mark.parametrize("argv", SERVE_ERRORS, ids=" ".join)
def test_serve_argument_errors_equal(argv, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    j, p = (run(pkg, ["--dir", "plane", *argv], capsys) for pkg in PKGS)
    assert p == j
    assert p[0] in (1, 2) and p[2]


def test_loadgen_catalog_equal(capsys):
    j, p = (run(pkg, ["loadgen"], capsys) for pkg in PKGS)
    assert p == j and p[0] == 0
    for name in ("steady", "storm", "megafleet-heavy", "hotspot"):
        assert name in p[1]


def test_loadgen_steady_json_equal(capsys):
    out = {}
    for pkg in PKGS:
        with fresh_ledger(pkg), frozen_cycle_clock():
            rc, text, _ = run(pkg, ["loadgen", "steady", "--seed", "3"],
                              capsys)
        assert rc == 0
        out[pkg] = comparable(json.loads(text))
    assert out["karmada_tpu_torch"] == out["karmada_tpu"]
    assert out["karmada_tpu"]["scheduled"] == out["karmada_tpu"]["injected"]


def test_loadgen_unknown_and_chaotic(capsys):
    """An unknown scenario exits 1 on both CLIs; the chaotic ones (chaos,
    hotspot) run on both, the chaos plane armed and disarmed, and print
    the same SOAK JSON (the fire log's wall-clock stamps aside), its
    `chaos` and `safety_audit` sections included."""
    j, p = (run(pkg, ["loadgen", "no-such-scenario"], capsys)
            for pkg in PKGS)
    assert p == j and p[0] == 1
    for name in ("chaos", "hotspot"):
        out = {}
        for pkg in PKGS:
            # the port asks for the CPU (its hotspot slice's rebalance
            # plane runs K13's plain version there)
            argv = ["loadgen", name, "--seed", "3"] + (
                ["--device", "cpu"] if pkg == "karmada_tpu_torch" else [])
            with fresh_ledger(pkg), frozen_cycle_clock():
                rc, text, err = run(pkg, argv, capsys)
            assert rc == 0, err
            out[pkg] = json.loads(text)
            assert not importlib.import_module(f"{pkg}.chaos").armed()
        j, p = cross_comparable(out["karmada_tpu"], out["karmada_tpu_torch"])
        assert p == j, name
        out["karmada_tpu"] = j
        assert "safety_audit" in out["karmada_tpu"]
        assert out["karmada_tpu"]["chaos"]["fired_total"] > 0


REFUSED = [
    (["logs", "p", "--cluster", "m1"], 9),
    (["exec", "p", "--cluster", "m1", "ls"], 9),
    (["attach", "p", "--cluster", "m1"], 9),
    (["top"], 9),
    (["top", "--endpoint", "http://x"], 9),
    (["vet"], 9),
    (["--server", "http://x", "get", "Cluster"], 9),
    (["get", "Deployment", "--cluster", "m1"], 9),
    (["describe", "Deployment", "x", "--cluster", "m1"], 9),
    (["events", "--endpoint", "http://x"], 7),
    (["describe", "ns/x", "--endpoint", "http://x"], 7),
    (["explain", "ResourceBinding"], 7),
    (["trace", "--endpoint", "http://x"], 7),
    (["resident", "--endpoint", "http://x"], 7),
    (["rebalance", "--endpoint", "http://x"], 7),
    (["profile", "--endpoint", "http://x"], 7),
    (["incidents", "--endpoint", "http://x"], 7),
    (["whatif", "--endpoint", "http://x"], 7),
    (["loadgen", "--endpoint", "http://x"], 7),
    (["serve", "--metrics-port", "0"], 7),
    (["serve", "--api-port", "0"], 9),
    (["serve", "--check-invariants"], 9),
    (["serve", "--mesh", "2x4"], 10),
]


@pytest.mark.parametrize("argv,item", REFUSED,
                         ids=[" ".join(a) for a, _ in REFUSED])
def test_refused_verbs_and_flags_name_their_item(argv, item, tmp_path,
                                                 capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, out, err = run("karmada_tpu_torch", ["--dir", "plane", *argv],
                       capsys)
    assert rc == 1 and not out
    assert "not part of the PyTorch port yet" in err
    assert f"ROADMAP Queue A item {item})" in err
    # refused before any plane loads
    assert not (tmp_path / "plane").exists()


def test_every_missing_entry_is_reachable():
    """Every verb and flag in the port CLI's MISSING table is one a user
    can type (a refusal nobody can reach would hide a silent path)."""
    parser = CLI["karmada_tpu_torch"].build_parser()
    verbs = set(parser._subparsers._group_actions[0].choices)  # noqa: SLF001
    serve = parser._subparsers._group_actions[0].choices["serve"]  # noqa: SLF001
    flags = {o for a in serve._actions for o in a.option_strings}  # noqa: SLF001
    for what in CLI["karmada_tpu_torch"].MISSING:
        head = what.split()[0]
        assert head in verbs or head in flags or head in (
            "--server", "--cluster"), what


def test_serve_arms_chaos_telemetry_and_incidents(tmp_path, capsys,
                                                  monkeypatch):
    """`serve --chaos SPEC --telemetry RING --slo-deadline S` on the
    serial backend: the chaos plane armed with SPEC, the telemetry ring
    sampling on the scheduler's clock with the SLO evaluator judging it,
    the incident plane armed under DIR/incidents; SIGINT (here an
    interrupt of the main thread) stops it with exit 0."""
    import _thread

    monkeypatch.chdir(tmp_path)
    cli = "karmada_tpu_torch"
    assert run(cli, ["--dir", "plane", "init"], capsys)[0] == 0
    assert run(cli, ["--dir", "plane", "join", "m1", "--cpu", "8"],
               capsys)[0] == 0
    chaos = importlib.import_module(f"{cli}.chaos")
    ts = importlib.import_module(f"{cli}.obs.timeseries")
    slo = importlib.import_module(f"{cli}.obs.slo")
    incidents = importlib.import_module(f"{cli}.obs.incidents")
    timer = threading.Timer(3.0, _thread.interrupt_main)
    timer.start()
    try:
        rc, out, err = run(cli, [
            "--dir", "plane", "serve", "--backend", "serial",
            "--chaos", "worker.reconcile:error#1", "--chaos-seed", "4",
            "--telemetry", "64", "--telemetry-interval", "0",
            "--slo-deadline", "2", "--sync-period", "0.05"], capsys)
        assert rc == 0, err
        assert "CHAOS PLANE ARMED (seed 4): worker.reconcile:error#1" in out
        assert "telemetry plane armed: 64-sample" in out
        assert "incident plane armed" in out
        plane = chaos.active()
        assert chaos.armed() and plane.seed == 4
        assert [(r["site"], r["mode"], r["count"])
                for r in plane.state()["rules"]] == [
                    ("worker.reconcile", "error", 1)]
        assert len(ts.active()) > 0 and ts.active().capacity == 64
        judged = slo.state_payload()
        assert judged["enabled"]
        assert {o["name"] for o in judged["objectives"]} >= {
            "schedule_p99", "conservation"}
        assert incidents.active() is None  # disarmed at exit
    finally:
        timer.cancel()
        chaos.disarm()
        ts.disarm()


def test_incident_plane_named_in_the_serve_help():
    """--no-incidents is accepted (the parser keeps the JAX flags)."""
    parser = CLI["karmada_tpu_torch"].build_parser()
    args = parser.parse_args(["--dir", "d", "serve", "--no-incidents"])
    assert args.no_incidents and CLI["karmada_tpu_torch"]._refused_serve_flag(
        args) is None


def _mask(payload):
    payload = dict(payload)
    payload.pop("traceId", None)
    payload.pop("batchId", None)
    return payload


def test_estimate_against_a_port_facade(capsys):
    L = importlib.import_module("karmada_tpu_torch.loadgen")
    F = importlib.import_module("karmada_tpu_torch.facade")
    scenario = dataclasses.replace(L.get_scenario("steady"), n_clusters=4)
    plane = L.ServeSlice(scenario, L.VirtualClock(), L.ServiceModel())
    svc = F.FacadeService(plane.scheduler, plane.store, batch_window=4,
                          batch_deadline_s=0.02)
    host, port = svc.serve(host="127.0.0.1", port=0)
    addr = f"{host}:{port}"
    try:
        answers = {}
        for pkg in PKGS:
            rc, out, err = run(pkg, ["estimate", "--facade-addr", addr,
                                     "--replicas", "6", "--cpu", "500m",
                                     "--format", "json"], capsys)
            assert rc == 0, err
            answers[pkg] = _mask(json.loads(out))
        assert answers["karmada_tpu_torch"] == answers["karmada_tpu"]
        assert answers["karmada_tpu"]["outcome"] == "scheduled"
        assert sum(a["replicas"] for a in
                   answers["karmada_tpu"]["assignments"]) == 6
        rc, out, _ = run("karmada_tpu_torch",
                         ["estimate", "--facade-addr", addr, "--replicas",
                          "2"], capsys)
        assert rc == 0 and out.startswith("outcome: scheduled")
        # an unschedulable ask: exit 1 on both
        big = [run(pkg, ["estimate", "--facade-addr", addr, "--replicas",
                         "1", "--cpu", "10000"], capsys)[0] for pkg in PKGS]
        assert big == [1, 1]
        rc, _, err = run("karmada_tpu_torch",
                         ["estimate", "--facade-addr", "bad"], capsys)
        assert rc == 1 and "HOST:PORT" in err
        assert svc.state_payload()["calls"] >= 5
    finally:
        svc.close()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("facade") and t.is_alive()]
