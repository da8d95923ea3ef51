"""The port's counterpart of the JAX package's ``repro.nn``."""
