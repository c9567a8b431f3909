"""The serving plane of the port (copies of ``cake_tpu/serve``): an HTTP
API over an SLO-aware scheduler that owns one continuous-batching engine
(:class:`~cake_tpu_torch.runtime.batch_generator.BatchGenerator`)."""
