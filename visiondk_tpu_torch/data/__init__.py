from visiondk_tpu_torch.data.class_augmenter import ClassWiseAugmenter
from visiondk_tpu_torch.data.dataprocessor import SmartDataProcessor
from visiondk_tpu_torch.data.datasets import (
    CBIRDatasets,
    EmbeddingDistillDataset,
    ImageDatasets,
    PredictImageDatasets,
    read_image,
    read_label_csv,
    smooth_labels,
    tell_data_distribution,
)
from visiondk_tpu_torch.data.loader import DataLoader, DevicePrefetcher, loader_kind
from visiondk_tpu_torch.data.transforms import (
    AUG_METHODS,
    SPATIAL_TRANSFORMS,
    Compose,
    create_aug_transforms,
    extract_normalization,
    seed_sample,
    set_pipeline_size,
)

__all__ = [
    "AUG_METHODS",
    "CBIRDatasets",
    "ClassWiseAugmenter",
    "Compose",
    "DataLoader",
    "DevicePrefetcher",
    "EmbeddingDistillDataset",
    "ImageDatasets",
    "PredictImageDatasets",
    "SPATIAL_TRANSFORMS",
    "SmartDataProcessor",
    "create_aug_transforms",
    "extract_normalization",
    "loader_kind",
    "read_image",
    "read_label_csv",
    "seed_sample",
    "set_pipeline_size",
    "smooth_labels",
    "tell_data_distribution",
]
