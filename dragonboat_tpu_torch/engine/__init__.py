"""engine — execution engines that advance raft shards.

The loopback engine (NodeHost's thread stepping host-Python ``Node``s) is
the reference-shaped path (engine.go worker pools collapsed to one
executor).  ``KernelEngine`` is the TPU-native replacement: every
device-resident shard lives as one lane of a batched ``[G]`` kernel state,
one jitted step advances all of them, and the host marshals client
requests, transport messages, persistence and RSM applies around it
(engine.go:1107-1364 re-expressed as a data-parallel device program).
"""

from dragonboat_tpu_torch.engine.kernel_engine import KernelEngine

__all__ = ["KernelEngine"]
