"""The port's models: RAFT-small, the ZSM encoder with PCD alignment, SIRENs
and MoTIF."""
