"""The port's data pipeline: host-side numpy / pandas code copied from
afft_tpu/data (annotations, anticipation windows, feature stores, clip
datasets, the batch loader) plus the device-resident feature cache."""

from .anticipation import convert_to_anticipation, RULSTM_TSN_FPS  # noqa: F401
from .dataset import FeatureClipDataset, ZeroMaskFeats  # noqa: F401
from .epic import EPICKitchens  # noqa: F401
from .loader import BatchLoader, get_dataset, shard_indices  # noqa: F401
from .readers import (EpicRULSTMFeatsReader, DictFeatureStore,  # noqa: F401
                      PackedFeatureStore, LmdbFeatureStore, open_store)
