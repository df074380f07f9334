"""The data layer: PNG folders, the transform chain, the unpaired A/B
dataset, paired 3-D volumes and the batching loader."""

from dfmir_tpu_torch.data.image_folder import (IMG_EXTENSIONS, ImageCache,
                                               is_image_file, load_image,
                                               make_dataset)
from dfmir_tpu_torch.data.loader import (DataLoader, create_dataset,
                                         find_dataset_using_name,
                                         get_option_setter)
from dfmir_tpu_torch.data.transforms import (TransformParams,
                                             apply_transform, get_params,
                                             to_array)
from dfmir_tpu_torch.data.unaligned import UnalignedDataset
from dfmir_tpu_torch.data.volume import VolumeDataset

__all__ = [
    "IMG_EXTENSIONS", "ImageCache", "is_image_file", "load_image",
    "make_dataset", "DataLoader", "create_dataset",
    "find_dataset_using_name", "get_option_setter", "TransformParams",
    "apply_transform", "get_params", "to_array", "UnalignedDataset",
    "VolumeDataset",
]
