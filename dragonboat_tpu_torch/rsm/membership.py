"""Replicated membership store.

Parity with ``internal/rsm/membership.go``: the {config_change_id,
addresses, non_votings, witnesses, removed} record replicated through
config-change entries, with ordered-CC enforcement and the rejection rules
(:111-206).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from dragonboat_tpu_torch import raftpb as pb


class MembershipStore:
    def __init__(self, shard_id: int, ordered: bool) -> None:
        self.shard_id = shard_id
        self.ordered = ordered
        self._mu = threading.RLock()
        self.membership = pb.Membership(config_change_id=0)

    def set(self, m: pb.Membership) -> None:
        with self._mu:
            self.membership = m.copy()

    def get(self) -> pb.Membership:
        with self._mu:
            return self.membership.copy()

    def get_hash(self) -> int:
        """Membership hash oracle for chaos tests (monkey.go:118)."""
        import zlib

        with self._mu:
            m = self.membership
            parts = [
                str(sorted(m.addresses.items())),
                str(sorted(m.non_votings.items())),
                str(sorted(m.witnesses.items())),
                str(sorted(m.removed)),
            ]
            return zlib.crc32("|".join(parts).encode())

    # -- config change application (membership.go:111-280) ----------------

    def _rejected(self, cc: pb.ConfigChange) -> str | None:
        m = self.membership
        rid = cc.replica_id
        if self.ordered and cc.config_change_id != m.config_change_id:
            return "config change id not matched"
        if rid in m.removed:
            return "replica already removed"
        if cc.type == pb.ConfigChangeType.ADD_NODE:
            if rid in m.witnesses:
                return "cannot promote witness"
            if cc.address in m.addresses.values() and m.addresses.get(rid) != cc.address:
                return "address already in use"
            if rid in m.addresses and m.addresses[rid] != cc.address:
                return "replica exists with different address"
        elif cc.type == pb.ConfigChangeType.ADD_NON_VOTING:
            if rid in m.addresses or rid in m.witnesses:
                return "replica already a member"
            if cc.address in m.addresses.values():
                return "address already in use"
        elif cc.type == pb.ConfigChangeType.ADD_WITNESS:
            if rid in m.addresses or rid in m.non_votings:
                return "replica already a member"
        elif cc.type == pb.ConfigChangeType.REMOVE_NODE:
            pass
        return None

    def handle_config_change(self, cc: pb.ConfigChange, index: int) -> bool:
        """Apply (or reject) one committed config change; returns accepted."""
        with self._mu:
            reason = self._rejected(cc)
            if reason is not None:
                return False
            m = self.membership.copy()
            rid = cc.replica_id
            if cc.type == pb.ConfigChangeType.ADD_NODE:
                m.non_votings.pop(rid, None)
                m.addresses[rid] = cc.address
            elif cc.type == pb.ConfigChangeType.ADD_NON_VOTING:
                m.non_votings[rid] = cc.address
            elif cc.type == pb.ConfigChangeType.ADD_WITNESS:
                m.witnesses[rid] = cc.address
            elif cc.type == pb.ConfigChangeType.REMOVE_NODE:
                m.addresses.pop(rid, None)
                m.non_votings.pop(rid, None)
                m.witnesses.pop(rid, None)
                m.removed[rid] = True
            self.membership = pb.Membership(
                config_change_id=index,
                addresses=m.addresses,
                non_votings=m.non_votings,
                witnesses=m.witnesses,
                removed=m.removed,
            )
            return True
