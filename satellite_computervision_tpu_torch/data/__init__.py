"""Host-side ingestion: the TFRecord codec (own copy), file-ID matching
(own copy), chip datasets, the pinned-memory device prefetcher and the
on-device batch preprocess."""

from satellite_computervision_tpu_torch.data.matching import get_file_id, match_files, split_files
from satellite_computervision_tpu_torch.data.pipeline import (
    ChipDataset,
    TrainIterator,
    get_eval_dataset,
    get_training_dataset,
    make_preprocess_fn,
    prefetch_to_device,
)
from satellite_computervision_tpu_torch.data.tfrecord import (
    TFRecordReader,
    TFRecordWriter,
    build_example,
    parse_example,
    read_tfrecord_file,
    write_tfrecord_file,
)

__all__ = [
    "TFRecordReader",
    "TFRecordWriter",
    "read_tfrecord_file",
    "write_tfrecord_file",
    "parse_example",
    "build_example",
    "get_file_id",
    "match_files",
    "split_files",
    "ChipDataset",
    "TrainIterator",
    "get_training_dataset",
    "get_eval_dataset",
    "make_preprocess_fn",
    "prefetch_to_device",
]
