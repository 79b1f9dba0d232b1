"""Drivers of the benchmark's cells, one module per kind of timed unit:
``render`` (offline renders), ``preview`` (progressive frames) and ``fit``
(inverse-rendering training steps). Each has ``run(ctx) -> harness.Outcome``."""
