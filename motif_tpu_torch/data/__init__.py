"""The port's data: the reference test datasets, the Vimeo septuplet
training set, the threaded batch loader and the copy to the card."""

from motif_tpu_torch.data.datasets import create_dataset, read_img  # noqa: F401
from motif_tpu_torch.data.pipeline import (  # noqa: F401
    BatchLoader, collate_stack, device_prefetch)
