"""Client sessions — at-most-once proposal dedup handles.

Parity with the reference's ``client/`` package: a Session is
{client_id, series_id, responded_to} (client/session.pb.go:47-52); a NoOP
session (:79) skips dedup.  ``proposal_completed`` advances series_id
(:420) after a successful SyncPropose; ``prepare_for_*`` flags the session
record for registration/unregistration proposals.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field

from dragonboat_tpu_torch import raftpb as pb

NOT_SESSION_MANAGED_CLIENT_ID = 0


@dataclass
class Session:
    shard_id: int
    client_id: int
    series_id: int = pb.SERIES_ID_FIRST_PROPOSAL
    responded_to: int = 0

    @staticmethod
    def new_session(shard_id: int) -> "Session":
        # reference uses a random uint64 client id
        return Session(shard_id=shard_id, client_id=secrets.randbits(63) | 1)

    @staticmethod
    def new_noop_session(shard_id: int) -> "Session":
        return Session(
            shard_id=shard_id,
            client_id=NOT_SESSION_MANAGED_CLIENT_ID,
            series_id=pb.NOOP_SERIES_ID,
        )

    def is_noop_session(self) -> bool:
        return self.series_id == pb.NOOP_SERIES_ID and self.client_id == 0

    def prepare_for_register(self) -> None:
        self.series_id = pb.SERIES_ID_FOR_REGISTER

    def prepare_for_unregister(self) -> None:
        self.series_id = pb.SERIES_ID_FOR_UNREGISTER

    def prepare_for_propose(self) -> None:
        self.series_id = pb.SERIES_ID_FIRST_PROPOSAL

    def proposal_completed(self) -> None:
        """Advance after a completed proposal (client/session.pb.go:420)."""
        self.responded_to = self.series_id
        self.series_id += 1

    def valid_for_proposal(self, shard_id: int) -> bool:
        if self.shard_id != shard_id:
            return False
        if self.is_noop_session():
            return True
        return (
            self.client_id != 0
            and self.series_id != pb.SERIES_ID_FOR_REGISTER
            and self.series_id != pb.SERIES_ID_FOR_UNREGISTER
        )

    def valid_for_session_op(self, shard_id: int) -> bool:
        if self.shard_id != shard_id or self.is_noop_session():
            return False
        return self.client_id != 0 and self.series_id in (
            pb.SERIES_ID_FOR_REGISTER,
            pb.SERIES_ID_FOR_UNREGISTER,
        )
