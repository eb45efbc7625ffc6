"""server — host environment services (dirs, locks, identity, settings).

Parity with the reference's ``internal/server`` (environment.go) and
``internal/settings`` (hard.go): the NodeHost data-directory hierarchy,
exclusive dir locking, the on-disk flag file that pins address/hostname/
deployment-id/LogDB-type/hard-settings so an incompatible reopen is
refused, and the persistent NodeHost identity.
"""

from dragonboat_tpu_torch.server.env import (
    DirLockedError,
    Env,
    IncompatibleDataError,
    NotOwnerError,
)
from dragonboat_tpu_torch.server.settings import HardSettings, hard

__all__ = [
    "DirLockedError",
    "Env",
    "HardSettings",
    "IncompatibleDataError",
    "NotOwnerError",
    "hard",
]
