"""Static kernel geometry and the shared counter-based PRNG.

The port's own copy of the reference's ``core/params.py``: the same
``KernelParams`` fields and defaults, the same role, kind and progress
constants, the same static inbox slot families and the same splitmix32
mixer, plus a tensor form of the mixer.

torch has no ``add``, ``>>`` or ``%`` on ``uint32``, so the tensor mixer
works on int64 values masked to 32 bits.  A product of two 32-bit values
does not fit in int64, so ``mul32`` forms the low 32 bits of a product from
16-bit halves; every intermediate stays below 2**49.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class KernelParams:
    num_peers: int = 3          # P: peer slots per shard (max replicas)
    log_cap: int = 1024         # CAP: term-ring capacity (power of two)
    inbox_cap: int = 8          # K: inbound messages per shard per step
    msg_entries: int = 8        # E: max entries carried per replicate message
    proposal_cap: int = 8       # B: proposals per shard per step
    readindex_cap: int = 8      # RI: pending ReadIndex contexts per shard
    apply_batch: int = 64       # max committed entries released per step
    compaction_overhead: int = 64  # retained entries below the compact floor
    # inline payload lanes (lv ring + ent_val routing) for device-resident
    # state machines
    inline_payloads: bool = False
    # read dynamically indexed state by one-hot compare+select+sum instead
    # of a gather; bitwise identical either way (the tests pin both)
    onehot_reads: bool = False
    # kept for field parity with the reference, where it flips the family
    # scans' unroll flag; the port's slot loop is a Python loop either way
    unroll_scans: bool = False

    def __post_init__(self) -> None:
        if self.log_cap & (self.log_cap - 1):
            raise ValueError("log_cap must be 2^n")
        if self.readindex_cap & (self.readindex_cap - 1):
            raise ValueError("readindex_cap must be 2^n")


def slot_families(K: int) -> tuple[str, ...]:
    """Static per-slot message families for the kernel inbox.

    Per remote peer the router's layout holds two response lanes, a
    replicate lane, a heartbeat lane and a vote/TimeoutNow lane; slots
    beyond whole 5-slot units accept every type ('any')."""
    u = K // 5
    return ("resp", "resp", "rep", "hb", "vote") * u + ("any",) * (K - 5 * u)


# role encoding
FOLLOWER = 0
CANDIDATE = 1
PRE_VOTE_CANDIDATE = 2
LEADER = 3
NON_VOTING = 4
WITNESS = 5

# peer-slot kinds
K_ABSENT = 0
K_VOTER = 1
K_NON_VOTING = 2
K_WITNESS = 3

# remote flow-control states
R_RETRY = 0
R_WAIT = 1
R_REPLICATE = 2
R_SNAPSHOT = 3

NO_LEADER = 0

_U = np.uint32
U32_MASK = 0xFFFFFFFF


def splitmix32(x):
    """Deterministic 32-bit mixer for Python ints and numpy uint32 values.

    Constants are np.uint32 so numpy wraps mod 2^32."""
    if isinstance(x, (int, np.integer)):
        m = U32_MASK
        x = (int(x) + 0x9E3779B9) & m
        z = ((x ^ (x >> 16)) * 0x85EBCA6B) & m
        z = ((z ^ (z >> 13)) * 0xC2B2AE35) & m
        return _U(z ^ (z >> 16))
    x = x + _U(0x9E3779B9)
    z = (x ^ (x >> _U(16))) * _U(0x85EBCA6B)
    z = (z ^ (z >> _U(13))) * _U(0xC2B2AE35)
    return z ^ (z >> _U(16))


def randomized_timeout(seed: int, counter: int, election_timeout: int) -> int:
    """election_timeout + uniform-ish [0, election_timeout) — host flavor,
    bit-identical to the kernel's ``_next_rand_timeout`` draw."""
    mixed = splitmix32((seed & U32_MASK)
                       ^ (((counter & U32_MASK) * 0x632BE5AB) & U32_MASK))
    return election_timeout + int(mixed) % election_timeout


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 reading of an integer tensor, as int64 in [0, 2**32)."""
    return x.to(torch.int64) & U32_MASK


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant c,
    without overflowing int64."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & U32_MASK


def splitmix32_t(x: torch.Tensor) -> torch.Tensor:
    """Tensor splitmix32: int64 in [0, 2**32) to int64 in [0, 2**32),
    bit-identical to ``splitmix32`` on uint32."""
    x = (x + 0x9E3779B9) & U32_MASK
    z = mul32(x ^ (x >> 16), 0x85EBCA6B)
    z = mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)
