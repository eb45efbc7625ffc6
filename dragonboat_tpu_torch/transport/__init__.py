"""Transport layer: message batches + snapshot streaming behind
raftio.ITransport (SURVEY §2.7)."""

from dragonboat_tpu_torch.transport.chan import ChanTransport, ChanTransportFactory
from dragonboat_tpu_torch.transport.hub import TransportHub

__all__ = ["ChanTransport", "ChanTransportFactory", "TransportHub"]
