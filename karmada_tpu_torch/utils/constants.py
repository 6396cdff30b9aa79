"""Shared well-known labels/annotations (reference pkg/util/constants.go).

Counterpart of the JAX package's ``utils/constants.py``.
"""

# set on a resource template to make the apply engine keep each member
# cluster's own spec.replicas (member-side HPAs in control): constants.go:62
RETAIN_REPLICAS_LABEL = "resourcetemplate.karmada.io/retain-replicas"
RETAIN_REPLICAS_VALUE = "true"
