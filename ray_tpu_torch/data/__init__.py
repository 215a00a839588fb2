"""ray_tpu_torch.data — lazy streaming distributed datasets (reference: Ray Data).

Blocks flow through fused stages as remote tasks with bounded in-flight
windows; `iter_device_batches` stages host batches in pinned memory and
copies them to the card on a side stream ahead of the consumer, so
training steps never stall on input.

The port's copy of ray_tpu/data, on the port's runtime (its tasks in
worker processes and its actor pool in actor processes by default), with the
shared ingest service (`ingest.py`: IngestClient, IngestIterator,
IngestService, get_ingest_service, shutdown_ingest_service) and its
fair-share tenants (`tenant.py`: TenantSpec).
"""

from .aggregate import AggregateFn, Count, Max, Mean, Min, Std, Sum  # noqa: F401
from .block import Block, BlockAccessor, BlockMetadata  # noqa: F401
from .dataset import Dataset, GroupedData  # noqa: F401
from .ingest import (  # noqa: F401
    IngestClient,
    IngestIterator,
    IngestService,
    get_ingest_service,
    shutdown_ingest_service,
)
from .iterator import DataIterator  # noqa: F401
from .read_api import (  # noqa: F401
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)
from .tenant import TenantSpec  # noqa: F401
