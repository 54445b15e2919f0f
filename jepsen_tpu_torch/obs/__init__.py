"""Observability of the port: a metrics registry (:mod:`.metrics`) and a
span tracer (:mod:`.trace`), copies of the JAX package's ``obs``."""
