"""Runtime invariant guards of the port (analysis/guards.py): the JAX
package's ``analysis/guards.py``.  The JAX package's static passes
(`karmadactl vet`) are not part of the port."""
