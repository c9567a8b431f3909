"""The operator's tools (port of ``cake_tpu/tools``): offline quantization
and splitting of checkpoints, deployment of worker bundles, the live watch
over workers' status pages, the card's measurement tools, the HTTP load
generator and the bench ledger's regression gate."""
