"""ray_tpu_torch.data: distributed data processing over numpy blocks (the
port of ``ray_tpu/data``; reference: ``python/ray/data``)."""

from ray_tpu_torch.data.datasource import (
    BinaryFilesDatasource,
    CSVDatasource,
    Datasource,
    JSONDatasource,
    ParquetDatasource,
    TextDatasource,
    read_datasource,
)
from ray_tpu_torch.data.dataset import (
    ActorPoolStrategy,
    DataIterator,
    Dataset,
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_csv,
    read_json,
    read_parquet,
    read_text,
)

__all__ = [
    "Datasource", "read_datasource",
    "BinaryFilesDatasource", "CSVDatasource", "JSONDatasource",
    "ParquetDatasource", "TextDatasource",
    "ActorPoolStrategy", "DataIterator", "Dataset", "from_arrow",
    "from_items", "from_numpy", "from_pandas", "range", "read_binary_files",
    "read_csv", "read_json", "read_parquet", "read_text",
]
