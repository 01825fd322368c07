from cova_tpu_torch.query.metrics import (  # noqa: F401
    arange_ts,
    calculate_query,
    exclude_regions,
    local_region,
    parse_query,
    QueryResult,
)
