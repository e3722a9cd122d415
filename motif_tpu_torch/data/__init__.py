"""The port's data: the reference test datasets, the training sets (Vimeo
septuplets, Adobe240 fixed and arbitrary scale, Vimeo arbitrary scale),
the arbitrary-scale collate, the threaded batch loader, a process's shard
of a data-parallel run and the copy to the card."""

from motif_tpu_torch.data.datasets import create_dataset, read_img  # noqa: F401
from motif_tpu_torch.data.pipeline import (  # noqa: F401
    BatchLoader, Subset, collate_adobe_arbitrary, collate_stack,
    device_prefetch)
