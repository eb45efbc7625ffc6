"""RSM apply layer: session dedup, membership, snapshot IO, managed SMs.

Re-expression of the reference's ``internal/rsm`` (SURVEY §2.5): the layer
between committed raft entries and user state machines."""

from dragonboat_tpu_torch.rsm.session import LRUSession, Session
from dragonboat_tpu_torch.rsm.membership import MembershipStore
from dragonboat_tpu_torch.rsm.statemachine import StateMachine, Task

__all__ = ["LRUSession", "Session", "MembershipStore", "StateMachine", "Task"]
