"""The port's eval data: the reference test datasets and the threaded
batch loader."""

from motif_tpu_torch.data.datasets import create_dataset, read_img  # noqa: F401
from motif_tpu_torch.data.pipeline import BatchLoader, collate_stack  # noqa: F401
