"""The operator's tools (port of ``cake_tpu/tools``): offline quantization
and splitting of checkpoints, deployment of worker bundles, and the live
watch over workers' status pages."""
