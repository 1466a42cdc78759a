"""MDQT ultracold-neutral-plasma simulation framework in JAX."""

__version__ = "0.1.0"
