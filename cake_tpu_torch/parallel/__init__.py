"""The serving engine's programs, the rank mesh and its collectives, and
the cross-host topology and runners (port of ``cake_tpu/parallel``)."""
