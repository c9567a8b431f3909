"""Program builders of the serving engine (port of ``cake_tpu/parallel``
for one device: no mesh)."""
