"""DeviceKV — the device-native key-value state machine.

Port of the reference's ``rsm/device_kv.py``: committed entry lanes are
applied to a per-shard open-addressing table that lives on the device,
batched across the ``[G]`` shard axis.  Keys and values are int32; keys are
stored +1 so 0 stays the empty sentinel; a full probe window rejects the
write (result -1, ok False) instead of growing.

``apply_kernel`` is the sequential plain arm: the AB command lanes run one
after another, each vectorized over every shard.  It is also the plain arm
of K3 (``rsm/device_kv_kernels.apply_window``), the hand-written CUDA
kernel the bench loop applies through on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from dragonboat_tpu_torch.core.params import splitmix32_t, u32
from dragonboat_tpu_torch.devices import resolve_device
from dragonboat_tpu_torch.statemachine import IDeviceStateMachine

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class DeviceKV(IDeviceStateMachine):
    """Fixed-capacity linear-probe table per shard.

    Keys must be >= 0 (the +1 storage offset reserves 0 as the empty
    sentinel); negative keys are rejected at the apply boundary and return
    None from lookup."""

    table_cap: int = 1024
    probe_depth: int = 8
    # hash_keys=False direct-maps key -> slot key & (cap-1): with a key
    # space <= table_cap no two keys share a home slot, so inserts are
    # never rejected (the bench's no-loss contract); hashed mode serves
    # arbitrary key spaces, with rejects when a probe window fills
    hash_keys: bool = True

    def __post_init__(self) -> None:
        if self.table_cap & (self.table_cap - 1):
            raise ValueError("table_cap must be 2^n")
        if not 0 < self.probe_depth <= self.table_cap:
            raise ValueError("probe_depth must be in [1, table_cap]")

    def init_state(self, num_shards: int, device=None) -> dict:
        dev = resolve_device(device)
        T = self.table_cap
        return {
            "keys": torch.zeros((num_shards, T), dtype=I32, device=dev),
            "vals": torch.zeros((num_shards, T), dtype=I32, device=dev),
            "count": torch.zeros((num_shards,), dtype=I32, device=dev),
        }

    # -- apply -----------------------------------------------------------

    def home_slot(self, key: torch.Tensor) -> torch.Tensor:
        """Home slot of each key: splitmix32(key) & (T-1) when hashed (the
        uint32 mixer on the key's 32 bits), else key & (T-1)."""
        if self.hash_keys:
            return (splitmix32_t(u32(key)) & (self.table_cap - 1)).to(I32)
        return key & (self.table_cap - 1)

    def _probe_slots(self, key: torch.Tensor) -> torch.Tensor:
        """[G] keys -> [G, D] probe slots in linear-probe order."""
        d = torch.arange(self.probe_depth, dtype=I32, device=key.device)
        return (self.home_slot(key)[:, None] + d[None, :]) & (self.table_cap - 1)

    def _put_one(self, keys, vals, count, key, val, valid):
        """Insert/update one (key, val) per shard; one-hot write."""
        slots = self._probe_slots(key)                       # [G, D]
        pk = torch.gather(keys, 1, slots.long())
        hit = pk == (key + 1)[:, None]
        empty = pk == 0
        found = (hit | empty).any(dim=1)
        any_hit = hit.any(dim=1)
        # first matching slot wins; else first empty (linear probe order)
        pick = torch.where(any_hit, torch.argmax(hit.to(I32), dim=1),
                           torch.argmax(empty.to(I32), dim=1))
        slot = torch.gather(slots, 1, pick[:, None])[:, 0]
        do = valid & found & (key >= 0)
        is_new = do & ~any_hit
        oh = (torch.arange(keys.shape[1], dtype=I32, device=keys.device)[None, :]
              == slot[:, None]) & do[:, None]
        keys = torch.where(oh, (key + 1)[:, None], keys)
        vals = torch.where(oh, val[:, None], vals)
        count = count + is_new.to(I32)
        # ok is a separate status flag: a stored value of -1 must stay
        # distinguishable from a reject
        return keys, vals, count, torch.where(do, val, -1), do

    def apply_kernel(self, sm_state: dict, cmd_lanes: torch.Tensor,
                     valid_mask: torch.Tensor):
        """Apply ``[G, B, 2]`` (key, value) command lanes where
        ``valid_mask [G, B]`` holds; returns (new_state, (results [G, B]
        i32, ok [G, B] bool)).  Lanes apply in order (later writes to the
        same key win).  The input state is not modified."""
        keys, vals, count = sm_state["keys"], sm_state["vals"], sm_state["count"]
        results, oks = [], []
        for j in range(cmd_lanes.shape[1]):
            keys, vals, count, r, ok = self._put_one(
                keys, vals, count, cmd_lanes[:, j, 0], cmd_lanes[:, j, 1],
                valid_mask[:, j])
            results.append(r)
            oks.append(ok)
        return ({"keys": keys, "vals": vals, "count": count},
                (torch.stack(results, 1), torch.stack(oks, 1)))

    def apply_kernel_range(self, sm_state: dict, first_key: torch.Tensor,
                           vals: torch.Tensor, valid_mask: torch.Tensor):
        """One-pass apply of a contiguous key window to a direct-mapped
        table: lane j writes key ``(first_key + j) & (table_cap - 1)``.
        Each table slot gathers its lane.  Bit-identical to
        ``apply_kernel`` driven with the same (key, value) lanes on a
        ``hash_keys=False`` table."""
        if self.hash_keys:
            raise ValueError("range apply requires hash_keys=False")
        T = self.table_cap
        B = vals.shape[1]
        if B > T:
            raise ValueError("window wider than the table aliases keys")
        slots = torch.arange(T, dtype=I32, device=vals.device)[None, :]
        rel = (slots - first_key[:, None]) & (T - 1)          # [G, T]
        lane_of_slot = torch.clamp(rel, max=B - 1).long()
        written = (rel < B) & torch.gather(valid_mask, 1, lane_of_slot)
        new_vals = torch.gather(vals, 1, lane_of_slot)
        was_empty = sm_state["keys"] == 0
        # a direct-mapped slot's key is the slot index
        out_keys = torch.where(written, slots + 1, sm_state["keys"])
        out_vals = torch.where(written, new_vals, sm_state["vals"])
        count = sm_state["count"] + (written & was_empty).sum(dim=1, dtype=I32)
        results = torch.where(valid_mask, vals, -1)
        return ({"keys": out_keys, "vals": out_vals, "count": count},
                (results, valid_mask))

    # -- reads -----------------------------------------------------------

    def lookup(self, sm_state: dict, shard_slot: int, query: object):
        """Host-callable point lookup: the value stored under ``query`` in
        shard row ``shard_slot``, or None."""
        key = int(query)  # type: ignore[arg-type]
        if key < 0:
            return None
        row = sm_state["keys"][shard_slot]
        k = torch.tensor([key], dtype=I32, device=row.device)
        slots = self._probe_slots(k)[0].long()
        stored = ((key + 1 + 2**31) % 2**32) - 2**31   # int32 key + 1
        hit = row[slots] == stored
        if not bool(hit.any()):
            return None
        slot = slots[torch.argmax(hit.to(I32))]
        return int(sm_state["vals"][shard_slot, slot])
