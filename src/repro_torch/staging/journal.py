"""Failover-surviving placement directory: write-ahead journal + snapshot.

The :class:`~repro.staging.directory.PlacementDirectory` is the
Manager's only copy of "which worker holds which region" — lose the
Manager and the whole cluster's locality metadata (and the record of
which leases were outstanding) dies with it.  :class:`DirectoryService`
wraps the directory so every mutation — placement records, evictions,
worker drops, lease grants, stage completions — is appended to a
:class:`WriteAheadJournal` *before* it is applied; a restarted Manager
replays the journal (newest snapshot + tail) and comes back with
holder maps and the pending-lease queue intact, then refetches any
region payloads it needs from the workers the directory says hold
them (the Manager journals metadata only, never payload bytes).

Journal format: one JSON object per line, ``{"e": <event>, ...}``.
A snapshot (written every ``snapshot_every`` appends) serializes the
full directory + lease state into ``<path>.snap`` and truncates the
journal, bounding replay time — the classic WAL/checkpoint pair.

**Size-tiered incremental checkpoints** (``incremental=True``): a hot
serving directory never stops mutating, so full snapshots grow with
total state and the checkpoint pause grows with them.  In incremental
mode a checkpoint instead writes only the state *touched since the
last checkpoint* to a delta file ``<path>.snap.dNNNNNN`` (placement
keys with their full current holder maps — an empty map is a
tombstone — newly completed uids, dirty leases, the pending list,
dirty addresses/racks, dropped workers) and truncates the journal.
Deltas are folded into a fresh full snapshot (compaction) once their
accumulated bytes reach the base snapshot's size or their count
reaches ``compact_deltas`` — the classic size-tiered trade: checkpoint
pause proportional to churn, replay cost bounded by base + O(churn).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Iterable, Optional

from .directory import PlacementDirectory
from .tiers import RegionKey

__all__ = ["WriteAheadJournal", "DirectoryService", "decode_key"]


def _jsonable_key(key: RegionKey) -> Any:
    if isinstance(key, tuple):
        return list(key)
    return key


def decode_key(key: Any) -> RegionKey:
    """Region keys are tuples in memory but lists on JSON/wire formats;
    normalize so directory lookups match (shared with repro.transport)."""
    if isinstance(key, list):
        return tuple(key)
    return key


class WriteAheadJournal:
    """Append-only JSON-lines journal with a sidecar snapshot file."""

    def __init__(self, path: str, *, fsync: bool = False):
        self.path = path
        self.snap_path = path + ".snap"
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        self.appends = 0
        self.fsync = fsync  # flush always; fsync only when durability > rate
        self._lock = threading.Lock()
        self._repair_torn_tail(path)
        self._fh = open(path, "a", encoding="utf-8")  # noqa: SIM115
        # Journal bytes accumulated since the last truncating snapshot —
        # the byte-based compaction trigger reads this, so an existing
        # (replayed) tail counts toward the first checkpoint too.
        try:
            self.appended_bytes = os.path.getsize(path)
        except OSError:
            self.appended_bytes = 0
        # Incremental-checkpoint sequencing: continue numbering after
        # any delta files a previous incarnation left behind, so replay
        # order (lexicographic = numeric) stays correct across restarts.
        seqs = [s for s, _ in self._delta_files()]
        self.delta_seq = max(seqs) if seqs else 0

    def _delta_files(self) -> list[tuple[int, str]]:
        """Existing delta files as sorted ``(seq, path)`` pairs."""
        directory = os.path.dirname(os.path.abspath(self.snap_path))
        prefix = os.path.basename(self.snap_path) + ".d"
        out: list[tuple[int, str]] = []
        try:
            names = os.listdir(directory)
        except OSError:
            return out
        for name in names:
            if not name.startswith(prefix) or name.endswith(".tmp"):
                continue
            try:
                seq = int(name[len(prefix):])
            except ValueError:
                continue
            out.append((seq, os.path.join(directory, name)))
        out.sort()
        return out

    @staticmethod
    def _repair_torn_tail(path: str) -> None:
        """Truncate a half-written final line left by a crash.

        Appending onto a torn fragment would corrupt that line AND make
        ``load`` (which stops at the first bad line) silently discard
        every valid entry written after the restart — so the fragment
        is cut back to the last newline before the file is reopened.
        """
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size == 0:
            return
        with open(path, "rb") as f:
            f.seek(-min(size, 1 << 20), os.SEEK_END)
            tail = f.read()
        if tail.endswith(b"\n"):
            return
        keep = size - (len(tail) - (tail.rfind(b"\n") + 1))
        with open(path, "rb+") as f:
            f.truncate(keep)

    def append(self, entry: dict[str, Any]) -> None:
        with self._lock:
            line = json.dumps(entry, separators=(",", ":")) + "\n"
            self._fh.write(line)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self.appends += 1
            self.appended_bytes += len(line)

    def snapshot(self, state: dict[str, Any]) -> int:
        """Full checkpoint: persist ``state``, truncate the journal and
        delete any delta files (their contents are folded in).  Returns
        the snapshot's size in bytes (the base for size-tiered
        compaction triggers)."""
        with self._lock:
            tmp = self.snap_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.snap_path)
            for _, dpath in self._delta_files():
                try:
                    os.remove(dpath)
                except OSError:
                    pass
            self._truncate_locked()
            try:
                return os.path.getsize(self.snap_path)
            except OSError:
                return 0

    def delta(self, state: dict[str, Any]) -> int:
        """Incremental checkpoint: persist the dirty-state ``state`` to
        the next ``<snap>.dNNNNNN`` file, then truncate the journal.
        The delta is durable *before* the journal entries it subsumes
        are dropped (same ordering contract as ``snapshot``).  Returns
        the delta's size in bytes."""
        with self._lock:
            self.delta_seq += 1
            dpath = f"{self.snap_path}.d{self.delta_seq:06d}"
            tmp = dpath + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(state, f, separators=(",", ":"))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dpath)
            self._truncate_locked()
            try:
                return os.path.getsize(dpath)
            except OSError:
                return 0

    def _truncate_locked(self) -> None:
        self._fh.close()
        self._fh = open(self.path, "w", encoding="utf-8")  # noqa: SIM115
        self.appended_bytes = 0

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    @classmethod
    def load(cls, path: str) -> tuple[Optional[dict], list[dict], list[dict]]:
        """Newest full snapshot (or None), the incremental deltas after
        it (oldest first), and the journal tail after those."""
        snapshot = None
        snap_path = path + ".snap"
        if os.path.exists(snap_path):
            with open(snap_path, encoding="utf-8") as f:
                snapshot = json.load(f)
        deltas: list[dict] = []
        directory = os.path.dirname(os.path.abspath(snap_path))
        prefix = os.path.basename(snap_path) + ".d"
        try:
            names = sorted(
                n for n in os.listdir(directory)
                if n.startswith(prefix) and not n.endswith(".tmp")
            )
        except OSError:
            names = []
        for name in names:
            try:
                with open(os.path.join(directory, name), encoding="utf-8") as f:
                    deltas.append(json.load(f))
            except (OSError, json.JSONDecodeError):
                break  # torn delta: stop here, journal tail is gone anyway
        entries: list[dict] = []
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entries.append(json.loads(line))
                    except json.JSONDecodeError:
                        break  # torn tail write: everything before it is good
        return snapshot, deltas, entries


class DirectoryService:
    """A PlacementDirectory whose state survives the Manager.

    Same query surface as the directory (delegated); mutations are
    journaled write-ahead.  Additionally journals the Manager's lease
    lifecycle (``pending`` / ``lease`` / ``complete``) so a rehydrated
    Manager knows which stage instances were done and which were in
    flight when the coordinator died.

    Opening a path that already has a journal/snapshot *replays* it:
    ``DirectoryService(path)`` after a crash is the failover story.
    """

    def __init__(
        self,
        path: str,
        directory: Optional[PlacementDirectory] = None,
        *,
        snapshot_every: int = 512,
        snapshot_bytes: Optional[int] = None,
        incremental: bool = False,
        compact_deltas: int = 8,
        registry=None,
    ):
        from ..telemetry.metrics import MetricsRegistry

        self.directory = directory or PlacementDirectory()
        self.registry = registry or MetricsRegistry()
        self.snapshot_every = max(int(snapshot_every), 1)
        # Byte-keyed compaction: when set, a checkpoint triggers once the
        # journal grows past this many bytes since the last snapshot —
        # replay time is bounded by bytes-to-parse, not append count
        # (entries vary 20x in size), so this is the scale-stable knob.
        self.snapshot_bytes = snapshot_bytes
        # Size-tiered incremental checkpoints: deltas of dirty state
        # instead of full snapshots, compacted once delta bytes reach
        # the base snapshot size or ``compact_deltas`` files pile up.
        self.incremental = bool(incremental)
        self.compact_deltas = max(int(compact_deltas), 1)
        # Serializes append+apply against checkpoint: an entry journaled
        # by one thread while another builds the snapshot state must not
        # be truncated away with its mutation in neither file (mutators
        # arrive from Manager, endpoint dispatcher, and worker threads).
        self._mu = threading.RLock()
        self.completed: set[int] = set()
        self.leases: dict[int, int] = {}     # stage uid -> worker id
        self.pending: list[int] = []         # noted, never completed
        # Registry-served counters (int-like cells; see repro.telemetry).
        self.replayed = self.registry.counter("directory.replayed")
        self.full_checkpoints = self.registry.counter(
            "directory.full_checkpoints"
        )
        self.delta_checkpoints = self.registry.counter(
            "directory.delta_checkpoints"
        )
        # Dirty state since the last checkpoint (incremental mode).
        self._dirty_keys: set[RegionKey] = set()
        self._dirty_leases: set[int] = set()
        self._completed_new: set[int] = set()
        self._dirty_addrs: set[int] = set()
        self._dirty_racks: set[int] = set()
        self._dropped: set[int] = set()
        snapshot, deltas, entries = WriteAheadJournal.load(path)
        if snapshot is not None:
            self._apply_snapshot(snapshot)
        for delta in deltas:
            self._apply_delta(delta)
        for entry in entries:
            self._apply(entry)
            self.replayed += 1
        self.journal = WriteAheadJournal(path)
        self._mutations = 0
        # Compaction accounting: the base snapshot's size and the delta
        # bytes stacked on top of it since.
        self._base_bytes = 0
        self._delta_bytes = 0
        self._delta_count = len(deltas)
        if snapshot is not None:
            try:
                self._base_bytes = os.path.getsize(self.journal.snap_path)
            except OSError:
                self._base_bytes = 0
        for _, dpath in self.journal._delta_files():  # noqa: SLF001
            try:
                self._delta_bytes += os.path.getsize(dpath)
            except OSError:
                pass

    # -- replay ------------------------------------------------------------

    def _apply_snapshot(self, snap: dict) -> None:
        for key_json, holders in snap.get("placement", []):
            key = decode_key(key_json)
            for wid, nbytes in holders.items():
                self.directory.record(int(wid), key, int(nbytes))
        self.completed = set(snap.get("completed", []))
        self.leases = {int(k): int(v) for k, v in snap.get("leases", {}).items()}
        self.pending = list(snap.get("pending", []))
        for wid, addr in snap.get("addresses", {}).items():
            self.directory.set_address(int(wid), addr)
        for wid, rack in snap.get("racks", {}).items():
            self.directory.set_rack(int(wid), rack)

    def _apply(self, entry: dict) -> None:
        e = entry.get("e")
        if e == "rec":
            key = decode_key(entry["k"])
            self._mark_key(key)
            self.directory.record(int(entry["w"]), key, int(entry["n"]))
        elif e == "evi":
            key = decode_key(entry["k"])
            self._mark_key(key)
            self.directory.evict(int(entry["w"]), key)
        elif e == "addr":
            self._mark_addr(int(entry["w"]))
            self.directory.set_address(int(entry["w"]), entry["a"])
        elif e == "rack":
            self._mark_rack(int(entry["w"]))
            self.directory.set_rack(int(entry["w"]), entry["r"])
        elif e == "drop":
            wid = int(entry["w"])
            self._mark_drop(wid)
            self.directory.drop_worker(wid)
            for uid, lw in self.leases.items():
                if lw == wid:
                    self._mark_lease(uid)
            self.leases = {
                uid: w for uid, w in self.leases.items() if w != wid
            }
        elif e == "pend":
            uid = int(entry["u"])
            if uid not in self.pending:
                self.pending.append(uid)
        elif e == "lease":
            uid = int(entry["u"])
            self._mark_lease(uid)
            self.leases[uid] = int(entry["w"])
        elif e == "done":
            uid = int(entry["u"])
            self._mark_done(uid)
            self.completed.add(uid)
            self.leases.pop(uid, None)
            if uid in self.pending:
                self.pending.remove(uid)

    def _apply_delta(self, delta: dict) -> None:
        """Replay one incremental checkpoint.  Ordering matters: worker
        drops first (they clear placements wholesale), then the dirty
        placement keys — each carries its FULL holder map as of the
        checkpoint, so replace-don't-merge; an empty map is a tombstone
        — then lease/complete/pending state and identities."""
        for wid in delta.get("dropped", []):
            self.directory.drop_worker(int(wid))
        for key_json, holders in delta.get("placement", []):
            key = decode_key(key_json)
            for w in list(self.directory.holders(key)):
                self.directory.evict(w, key)
            for w, n in holders.items():
                self.directory.record(int(w), key, int(n))
        self.completed.update(int(u) for u in delta.get("completed_add", []))
        for u, w in delta.get("leases", {}).items():
            if w is None:
                self.leases.pop(int(u), None)
            else:
                self.leases[int(u)] = int(w)
        if "pending" in delta:
            self.pending = [int(u) for u in delta["pending"]]
        for wid, addr in delta.get("addresses", {}).items():
            self.directory.set_address(int(wid), addr)
        for wid, rack in delta.get("racks", {}).items():
            self.directory.set_rack(int(wid), rack)

    # -- dirty tracking (incremental checkpoints) --------------------------

    def _mark_key(self, key: RegionKey) -> None:
        if self.incremental:
            self._dirty_keys.add(key)

    def _mark_lease(self, uid: int) -> None:
        if self.incremental:
            self._dirty_leases.add(uid)

    def _mark_done(self, uid: int) -> None:
        if self.incremental:
            self._completed_new.add(uid)
            self._dirty_leases.add(uid)

    def _mark_addr(self, wid: int) -> None:
        if self.incremental:
            self._dirty_addrs.add(wid)

    def _mark_rack(self, wid: int) -> None:
        if self.incremental:
            self._dirty_racks.add(wid)

    def _mark_drop(self, wid: int) -> None:
        """A worker drop dirties every key it held (their holder maps
        change) plus its address/rack.  Enumerated BEFORE the drop is
        applied; drops are rare (elastic membership events), so the
        scan is off the hot path."""
        if not self.incremental:
            return
        self._dropped.add(wid)
        self._dirty_addrs.add(wid)
        self._dirty_racks.add(wid)
        d = self.directory
        with d._lock:  # noqa: SLF001 - consistent view of the map
            for key, holders in d._placement.items():  # noqa: SLF001
                if wid in holders:
                    self._dirty_keys.add(key)

    # -- journaled mutations ----------------------------------------------

    def _log(self, entry: dict) -> None:
        """Write-ahead append.  The periodic checkpoint runs from
        ``_applied`` — after the in-memory state reflects the entry —
        so a snapshot can never miss the mutation that triggered it."""
        self.journal.append(entry)

    def _applied(self) -> None:
        self._mutations += 1
        if self.snapshot_bytes is not None:
            if self.journal.appended_bytes >= self.snapshot_bytes:
                self.checkpoint()
        elif self._mutations % self.snapshot_every == 0:
            self.checkpoint()

    def record(self, worker_id: int, key: RegionKey, nbytes: int) -> None:
        with self._mu:
            self._log(
                {"e": "rec", "w": worker_id, "k": _jsonable_key(key), "n": nbytes}
            )
            self._mark_key(key)
            self.directory.record(worker_id, key, nbytes)
            self._applied()

    def set_address(self, worker_id: int, address: Any) -> None:
        """Journal a worker's data-plane bus address: a rehydrated
        coordinator can answer holder lookups with dialable peers even
        before the workers re-register (stale addresses fail the dial
        and fall back to the Manager route, so this is best-effort)."""
        with self._mu:
            self._log({"e": "addr", "w": worker_id, "a": address})
            self._mark_addr(worker_id)
            self.directory.set_address(worker_id, address)
            self._applied()

    def set_rack(self, worker_id: int, rack: Any) -> None:
        """Journal a worker's rack (network topology identity): a
        rehydrated coordinator keeps scoring rack-locality correctly
        before the workers re-register."""
        with self._mu:
            self._log({"e": "rack", "w": worker_id, "r": rack})
            self._mark_rack(worker_id)
            self.directory.set_rack(worker_id, rack)
            self._applied()

    def evict(self, worker_id: int, key: RegionKey) -> None:
        with self._mu:
            self._log({"e": "evi", "w": worker_id, "k": _jsonable_key(key)})
            self._mark_key(key)
            self.directory.evict(worker_id, key)
            self._applied()

    def drop_worker(self, worker_id: int) -> None:
        with self._mu:
            self._log({"e": "drop", "w": worker_id})
            self._mark_drop(worker_id)
            self.directory.drop_worker(worker_id)
            for uid, wid in self.leases.items():
                if wid == worker_id:
                    self._mark_lease(uid)
            self.leases = {
                uid: wid for uid, wid in self.leases.items() if wid != worker_id
            }
            self._applied()

    # -- lease lifecycle (Manager hooks) -----------------------------------

    def note_pending(self, uid: int) -> None:
        with self._mu:
            if uid not in self.pending:
                self._log({"e": "pend", "u": uid})
                self.pending.append(uid)
                self._applied()

    def note_lease(self, uid: int, worker_id: int) -> None:
        with self._mu:
            self._log({"e": "lease", "u": uid, "w": worker_id})
            self._mark_lease(uid)
            self.leases[uid] = worker_id
            self._applied()

    def note_complete(self, uid: int) -> None:
        with self._mu:
            self._log({"e": "done", "u": uid})
            self._mark_done(uid)
            self.completed.add(uid)
            self.leases.pop(uid, None)
            if uid in self.pending:
                self.pending.remove(uid)
            self._applied()

    def stats(self) -> dict[str, int]:
        """Thin int view over the registry cells (wire-safe)."""
        return {
            "replayed": int(self.replayed),
            "full_checkpoints": int(self.full_checkpoints),
            "delta_checkpoints": int(self.delta_checkpoints),
            "journal_appends": int(self.journal.appends),
        }

    def outstanding(self) -> list[int]:
        """Stage uids that were pending or leased but never completed —
        the work a rehydrated Manager must put back on the queue."""
        out = [u for u in self.pending if u not in self.completed]
        out += [
            u for u in self.leases
            if u not in self.completed and u not in out
        ]
        return out

    # -- checkpoint --------------------------------------------------------

    def checkpoint(self) -> None:
        with self._mu:
            self._checkpoint_locked()

    def _checkpoint_locked(self) -> None:
        if self.incremental:
            self._incremental_checkpoint_locked()
        else:
            self._full_checkpoint_locked()

    def _incremental_checkpoint_locked(self) -> None:
        """Size-tiered checkpoint: write only the dirty state as a
        delta; fold everything into a fresh full snapshot once the
        stacked deltas reach the base snapshot's size (or pile up past
        ``compact_deltas``).  First checkpoint ever is always full —
        there is no base to be incremental against."""
        compact = (
            self._base_bytes <= 0
            or self._delta_count + 1 > self.compact_deltas
            or (self._delta_bytes >= self._base_bytes > 0)
        )
        if compact:
            self._full_checkpoint_locked()
            return
        d = self.directory
        with d._lock:  # noqa: SLF001 - consistent view of dirty keys
            placement = [
                [
                    _jsonable_key(k),
                    {
                        str(w): n
                        for w, n in d._placement.get(k, {}).items()  # noqa: SLF001
                    },
                ]
                for k in self._dirty_keys
            ]
        delta = {
            "dropped": sorted(self._dropped),
            "placement": placement,
            "completed_add": sorted(self._completed_new),
            "leases": {
                str(u): self.leases.get(u) for u in self._dirty_leases
            },
            "pending": list(self.pending),
            "addresses": {
                str(w): self.directory.address_of(w)
                for w in self._dirty_addrs
                if self.directory.address_of(w) is not None
            },
            "racks": {
                str(w): self.directory.rack_of(w)
                for w in self._dirty_racks
                if self.directory.rack_of(w) is not None
            },
        }
        self._delta_bytes += self.journal.delta(delta)
        self._delta_count += 1
        self.delta_checkpoints += 1
        self._clear_dirty_locked()

    def _clear_dirty_locked(self) -> None:
        self._dirty_keys.clear()
        self._dirty_leases.clear()
        self._completed_new.clear()
        self._dirty_addrs.clear()
        self._dirty_racks.clear()
        self._dropped.clear()

    def _full_checkpoint_locked(self) -> None:
        state = {
            "placement": [
                [_jsonable_key(k), {str(w): n for w, n in holders.items()}]
                for k, holders in self._placement_items()
            ],
            "completed": sorted(self.completed),
            "leases": {str(u): w for u, w in self.leases.items()},
            "pending": list(self.pending),
            "addresses": {
                str(w): a for w, a in self.directory.addresses().items()
            },
            "racks": {
                str(w): r for w, r in self.directory.racks().items()
            },
        }
        self._base_bytes = self.journal.snapshot(state)
        self._delta_bytes = 0
        self._delta_count = 0
        self.full_checkpoints += 1
        self._clear_dirty_locked()

    def _placement_items(self) -> Iterable[tuple[RegionKey, dict[int, int]]]:
        d = self.directory
        with d._lock:  # noqa: SLF001 - consistent snapshot of the map
            return [(k, dict(h)) for k, h in d._placement.items()]  # noqa: SLF001

    def close(self) -> None:
        self.journal.close()

    # -- query delegation --------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        return getattr(self.directory, name)

    def __len__(self) -> int:
        return len(self.directory)
