"""Moving one stream's KV pages and state between engines (port of
``cake_tpu/disagg``): the snapshot format
(:mod:`cake_tpu_torch.disagg.snapshot`), which the paged engine's
``export_stream``/``import_stream`` write and read and the serve
scheduler's spill store parks, and the transfer channel between replicas
(:mod:`cake_tpu_torch.disagg.transfer`), over which a prefill replica
hands a stream to a decode replica and a draining replica migrates its
streams to a sibling."""

from cake_tpu_torch.disagg.snapshot import (  # noqa: F401
    SNAPSHOT_VERSION,
    Snapshot,
    SnapshotError,
    SnapshotMismatch,
    decode_snapshot,
    encode_snapshot,
    peek_xfer_id,
)
from cake_tpu_torch.disagg.transfer import (  # noqa: F401
    XFER_ACK,
    XFER_REJECT,
    XFER_SNAPSHOT,
    TransferError,
    TransferRejected,
    TransferServer,
    send_snapshot,
)
