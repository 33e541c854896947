"""File and hierarchical plane fault hooks for an installed FaultPlan (the
counterpart of the JAX package's ``faults/fileplane.py``).

The comm plane injects faults through a transport interposer; the file
and hierarchical planes have no transport, so their exchange points call
these hooks directly (``fed/offline.py``, ``fed/hierarchical.py``).  Each
hook is a no-op when no plan is installed.

Keying: ``device_id`` carries the silo/client id (file plane) or the group
id (hierarchical plane); ``hop`` names the exchange leg:

- ``update``: silo -> aggregator update file (file plane);
- ``sync``:   edge group -> cloud contribution (hierarchical);
- ``seed``:   cloud -> edge group re-seed (hierarchical).

The checkpoint plane (``ckpt/streaming.py``) keys its ``ckpt_*`` hooks by
``shard x generation x op``: ``device_id`` carries the shard ordinal,
``round`` the generation step, and ``hop`` the write op (``shard`` |
``history`` | ``manifest``).  Faults fire on the ``server`` site, the
plan's default.
"""

from __future__ import annotations

import os
import time
from typing import Optional

from colearn_federated_learning_tpu_torch.faults import inject
from colearn_federated_learning_tpu_torch.faults.plan import ANY, FaultPlan

HOP_UPDATE = "update"
HOP_SYNC = "sync"
HOP_SEED = "seed"
HOP_SHARD = "shard"
HOP_HISTORY = "history"
HOP_MANIFEST = "manifest"


def _match_specs(kind: str, ident: str, round_idx: Optional[int],
                 hop: str) -> list:
    plan: FaultPlan | None = inject.active_plan()
    if plan is None:
        return []
    # ``op`` mirrors the hop so plans may key on either field.
    fired = plan.match(ident, round_idx, hop if hop != ANY else "",
                       kinds=(kind,), site="server", hop=hop)
    if fired:
        inject._count(kind, ident)
    return fired


def _match(kind: str, ident: str, round_idx: Optional[int],
           hop: str) -> bool:
    return bool(_match_specs(kind, ident, round_idx, hop))


def should_drop(ident: str, round_idx: Optional[int],
                hop: str = HOP_UPDATE) -> bool:
    """True when a ``drop_silo`` spec fires for this exchange leg — the
    caller withholds the silo/group's contribution entirely."""
    return _match("drop_silo", ident, round_idx, hop)


def stale_meta(meta: dict, ident: str, round_idx: Optional[int],
               hop: str = HOP_UPDATE) -> dict:
    """Apply a ``stale_round`` fault to an update's metadata: the round
    stamp is wound back one round, as a silo replaying an old file
    would.  Returns ``meta`` untouched when no spec fires."""
    if not _match("stale_round", ident, round_idx, hop):
        return meta
    stamped = dict(meta)
    stamped["round"] = int(meta.get("round", 0)) - 1
    return stamped


def maybe_truncate(path: str, ident: str, round_idx: Optional[int],
                   hop: str = HOP_UPDATE) -> bool:
    """Apply a ``truncate_file`` fault: cut the written file to half its
    bytes, exactly the torn npz a SIGKILLed silo without atomic writes
    would leave behind.  Returns True when the fault fired."""
    if not _match("truncate_file", ident, round_idx, hop):
        return False
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return True


# ------------------------------------------------------ checkpoint plane --

def ckpt_slow_io(shard: int, generation: Optional[int], op: str) -> bool:
    """Apply a ``slow_io`` fault: sleep the spec's ``ms`` before the
    write, which widens the save window so a kill can land between the
    shard commit and the manifest commit.  Returns True when a spec
    fired."""
    fired = _match_specs("slow_io", str(shard), generation, op)
    for spec in fired:
        if spec.ms:
            time.sleep(spec.ms / 1000.0)
    return bool(fired)


def ckpt_torn_shard(path: str, shard: int,
                    generation: Optional[int]) -> bool:
    """Apply a ``torn_shard`` fault: cut a just-committed shard file to
    half its bytes, the torn file that restore discards
    (``ckpt.generations_discarded_total{reason=torn_shard}``) by falling
    back a generation.  Returns True when the fault fired."""
    if not _match("torn_shard", str(shard), generation, HOP_SHARD):
        return False
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)
    return True


def ckpt_stale_manifest(generation: Optional[int]) -> bool:
    """True when a ``stale_manifest`` spec fires: the caller skips the
    generation's manifest write, leaving its shard files uncommitted, as
    a kill between the last shard fsync and the manifest replace
    would."""
    return _match("stale_manifest", ANY, generation, HOP_MANIFEST)
