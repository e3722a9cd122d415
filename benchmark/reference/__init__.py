"""The plain reference of the benchmark: MoTIF (two and four anchors; RAFT-
small, the ZSM encoder with PCD alignment and its deformable convolutions,
the SIRENs, the softmax splat and the synthesis) in plain PyTorch, frozen
from the model's published description as the program implements it, with
every kernel written as plain torch (`plain.py`); the eval plan of a
request (`infer.py`); the loss, the schedule and Adam of a training step
(`train.py`). It imports nothing of the program, and works out again
everything the program derives from the inputs it is given.

Every comparison on the card runs with TF32 off (`precise`): float32
products and convolutions in float32, as the configurations state."""

import contextlib


@contextlib.contextmanager
def precise(torch, tf32: bool = False):
    """TF32 off (or on, for the control) in matmuls and cuDNN for the
    block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
