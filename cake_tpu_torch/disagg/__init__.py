"""Moving one stream's KV pages and state between engines (port of
``cake_tpu/disagg``): so far the snapshot format
(:mod:`cake_tpu_torch.disagg.snapshot`), which the paged engine's
``export_stream``/``import_stream`` write and read, and the serve
scheduler's spill store parks. The transfer channel between replicas and
the prefill/decode roles are not ported yet."""

from cake_tpu_torch.disagg.snapshot import (  # noqa: F401
    SNAPSHOT_VERSION,
    Snapshot,
    SnapshotError,
    SnapshotMismatch,
    decode_snapshot,
    encode_snapshot,
    peek_xfer_id,
)
