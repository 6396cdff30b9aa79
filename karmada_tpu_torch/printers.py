"""Kind-aware table printers (reference pkg/printers; the JAX package's
``printers.py``): the port CLI's `get` renders through them."""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

Row = List[str]


def _meta_cols(o) -> Tuple[str, str]:
    return (o.metadata.namespace or "-", o.metadata.name)


def _cluster_row(o) -> Row:
    ns, name = _meta_cols(o)
    return [
        name,
        str(getattr(o, "ready", "-")),
        o.spec.sync_mode,
        o.spec.region or "-",
        o.spec.provider or "-",
        str(len(o.spec.taints)),
    ]


def _binding_row(o) -> Row:
    ns, name = _meta_cols(o)
    clusters = ",".join(
        f"{tc.name}:{tc.replicas}" for tc in o.spec.clusters) or "-"
    return [ns, name, str(o.spec.replicas), clusters]


def _work_row(o) -> Row:
    ns, name = _meta_cols(o)
    applied = "-"
    for c in o.status.conditions:
        if c.type == "Applied":
            applied = c.status
    return [ns, name, str(len(o.spec.workload)), applied]


def _unstructured_row(o) -> Row:
    ns, name = _meta_cols(o)
    spec = o.manifest.get("spec", {}) if hasattr(o, "manifest") else {}
    status = o.manifest.get("status", {}) if hasattr(o, "manifest") else {}
    replicas = spec.get("replicas", "-")
    ready = status.get("readyReplicas", status.get("ready", "-"))
    return [ns, name, o.KIND, str(replicas), str(ready)]


def _default_row(o) -> Row:
    ns, name = _meta_cols(o)
    return [ns, name, type(o).__name__]


_PRINTERS: Dict[str, Tuple[List[str], Callable]] = {
    "Cluster": (
        ["NAME", "READY", "MODE", "REGION", "PROVIDER", "TAINTS"],
        _cluster_row,
    ),
    "ResourceBinding": (
        ["NAMESPACE", "NAME", "REPLICAS", "CLUSTERS"],
        _binding_row,
    ),
    "ClusterResourceBinding": (
        ["NAMESPACE", "NAME", "REPLICAS", "CLUSTERS"],
        _binding_row,
    ),
    "Work": (
        ["NAMESPACE", "NAME", "MANIFESTS", "APPLIED"],
        _work_row,
    ),
}

_DEFAULT = (["NAMESPACE", "NAME", "TYPE"], _default_row)
_UNSTRUCTURED = (["NAMESPACE", "NAME", "KIND", "REPLICAS", "READY"],
                 _unstructured_row)


def table_for(kind: str, objs) -> Tuple[List[str], List[Row]]:
    """(headers, rows) for a homogeneous object list."""
    headers, fn = _PRINTERS.get(kind, _DEFAULT)
    if kind not in _PRINTERS and objs and hasattr(objs[0], "manifest"):
        headers, fn = _UNSTRUCTURED
    rows = []
    for o in objs:
        try:
            rows.append(fn(o))
        # vet: ignore[exception-hygiene] a malformed object still renders a table row
        except Exception:  # noqa: BLE001 — a malformed object still prints
            rows.append(_default_row(o))
    return headers, rows


def render(headers: List[str], rows: List[Row]) -> str:
    cells = [headers] + rows
    widths = [max(len(str(r[i])) for r in cells) for i in range(len(headers))]
    return "\n".join(
        "  ".join(str(v).ljust(w) for v, w in zip(r, widths)) for r in cells
    )
