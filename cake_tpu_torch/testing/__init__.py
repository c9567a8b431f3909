"""Fault injection for tests and drills (port of ``cake_tpu/testing``)."""
