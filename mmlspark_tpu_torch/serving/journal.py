"""Write-ahead request journal: epoch/commit semantics for the serving loop.

Counterpart of the reference's ``mmlspark_tpu/serving/journal.py``, with
the same on-disk format: a journal written by either package recovers in
the other. The serving loop has no task retry to lean on, so its
durability contract is a write-ahead journal: every drained batch is an
*epoch*; its requests are journaled BEFORE the transform runs, and the epoch commits once every request in it
has been answered (or abandoned by its client). After a crash, ``recover``
returns the uncommitted requests so a supervisor can re-submit them to a
fresh server — at-least-once processing for side-effecting pipelines.

Format: JSONL with an optional length-prefixed binary record variant.
JSON records (one op per line):
    {"op": "entry", "epoch": E, "id": rid, "body_b64": ..., "headers": {...}}
    {"op": "commit", "epoch": E}
Binary records (bodies that are wire frames — io/binary.py magic — would
pay a 33% base64 inflation as JSON; instead the header line carries the
byte count and the raw body follows verbatim):
    {"op": "entry_bin", "epoch": E, "id": rid, "nbytes": N, "headers": ...}
    <N raw body bytes>\\n
Readers handle both variants in one file, so a journal written before the
binary wire existed replays unchanged. ``compact`` rewrites the file
dropping committed epochs, preserving each entry's record variant.
"""

from __future__ import annotations

import base64
import errno
import json
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..core import faults
from ..core.faults import fsync_dir
from ..io.binary import is_frame

_LOG = logging.getLogger(__name__)


class RequestJournal:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        #: disk-full degrade: ENOSPC on an append flips
        #: the journal to accounted read-only mode — durability is lost
        #: (logged once, counted) but the serving loop never crashes
        self.degraded = False
        self.write_errors = 0
        self.skipped_writes = 0
        self._enospc_logged = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "ab")

    def _note_write_error(self, e: OSError) -> None:
        """ENOSPC degrades (read-only, log once); anything else re-raises —
        an unexpected I/O failure should surface, a full volume should not
        take serving down."""
        if getattr(e, "errno", None) != errno.ENOSPC:
            raise e
        with self._lock:
            self.write_errors += 1
            self.degraded = True
            logged = self._enospc_logged
            self._enospc_logged = True
        if not logged:
            _LOG.warning("request journal volume full (ENOSPC): degrading "
                         "to read-only mode — epochs are no longer durable")

    def _skip_write(self) -> bool:
        if not self.degraded:
            return False
        with self._lock:
            self.skipped_writes += 1
        return True

    # -- write side (server) ----------------------------------------------
    @staticmethod
    def _record(epoch: int, rid: int, body: bytes,
                headers: Optional[Dict[str, str]]) -> bytes:
        """One journal record, variant chosen by the body: wire frames are
        stored raw behind a length-prefixed header line (no base64
        inflation); everything else stays a plain JSONL entry."""
        body = bytes(body)
        if is_frame(body):
            head = json.dumps({
                "op": "entry_bin", "epoch": int(epoch), "id": int(rid),
                "nbytes": len(body), "headers": dict(headers or {})})
            return head.encode("utf-8") + b"\n" + body + b"\n"
        return (json.dumps({
            "op": "entry", "epoch": int(epoch), "id": int(rid),
            "body_b64": base64.b64encode(body).decode("ascii"),
            "headers": dict(headers or {})}) + "\n").encode("utf-8")

    def append(self, epoch: int, rid: int, body: bytes,
               headers: Optional[Dict[str, str]] = None) -> None:
        if self._skip_write():
            return
        rec = self._record(epoch, rid, body, headers)
        try:
            faults.fire(faults.JOURNAL_WRITE, epoch=epoch, n=1)
            with self._lock:
                self._fh.write(rec)
                self._fh.flush()
                os.fsync(self._fh.fileno())
        except OSError as e:
            self._note_write_error(e)

    def append_many(self, epoch: int, entries) -> None:
        """Journal a whole epoch with ONE flush+fsync (the hot batch path:
        durability is per-epoch, so per-request fsyncs buy nothing).
        ``entries``: iterable of (rid, body, headers)."""
        recs = [self._record(epoch, rid, body, headers)
                for rid, body, headers in entries]
        if self._skip_write():
            return
        try:
            faults.fire(faults.JOURNAL_WRITE, epoch=epoch, n=len(recs))
            with self._lock:
                self._fh.write(b"".join(recs))
                self._fh.flush()
                os.fsync(self._fh.fileno())
        except OSError as e:
            self._note_write_error(e)

    def commit(self, epoch: int) -> None:
        if self._skip_write():
            return
        try:
            faults.fire(faults.JOURNAL_COMMIT, epoch=epoch)
            with self._lock:
                self._fh.write((json.dumps({"op": "commit",
                                            "epoch": int(epoch)}) +
                                "\n").encode("utf-8"))
                self._fh.flush()
                os.fsync(self._fh.fileno())
        except OSError as e:
            self._note_write_error(e)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"degraded": int(self.degraded),
                    "write_errors": self.write_errors,
                    "skipped_writes": self.skipped_writes}

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    # -- read side (recovery) ---------------------------------------------
    @staticmethod
    def _pending_by_epoch(path: str
                          ) -> Dict[int, List[Tuple[int, bytes, Dict[str, str]]]]:
        if not os.path.exists(path):
            return {}
        entries: Dict[int, List[Tuple[int, bytes, Dict[str, str]]]] = {}
        committed = set()
        with open(path, "rb") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    # torn final line from a crash mid-append — exactly the
                    # case recovery exists for; skip it (that request never
                    # reached the transform)
                    continue
                if not isinstance(rec, dict) or "op" not in rec:
                    continue
                if rec["op"] == "commit":
                    committed.add(rec["epoch"])
                elif rec["op"] == "entry_bin":
                    # length-prefixed raw body follows the header line
                    body = fh.read(int(rec["nbytes"]))
                    if len(body) != int(rec["nbytes"]):
                        continue  # torn binary tail: crash mid-append
                    fh.read(1)  # trailing newline
                    entries.setdefault(rec["epoch"], []).append(
                        (rec["id"], body, rec.get("headers", {})))
                else:
                    entries.setdefault(rec["epoch"], []).append(
                        (rec["id"], base64.b64decode(rec["body_b64"]),
                         rec.get("headers", {})))
        return {e: v for e, v in entries.items() if e not in committed}

    @staticmethod
    def recover(path: str) -> List[Tuple[int, bytes, Dict[str, str]]]:
        """(rid, body, headers) of every request in an UNcommitted epoch —
        what a supervisor re-submits after a crash."""
        pending = RequestJournal._pending_by_epoch(path)
        out: List[Tuple[int, bytes, Dict[str, str]]] = []
        for epoch in sorted(pending):
            out.extend(pending[epoch])
        return out

    def compact(self) -> None:
        """Rewrite the journal keeping only uncommitted epochs, preserving
        their epoch numbers (a late commit of a live epoch must still match).

        Atomic AND durable: the replacement is fully written + fsynced before
        the rename, and the directory is fsynced after — a crash at any point
        mid-compact leaves either the complete old journal or the complete
        new one, never a torn file that loses uncommitted epochs."""
        with self._lock:
            self._fh.close()
            try:
                pending = self._pending_by_epoch(self.path)
                tmp = self.path + ".tmp"
                try:
                    with open(tmp, "wb") as fh:
                        for epoch in sorted(pending):
                            for rid, body, headers in pending[epoch]:
                                fh.write(self._record(epoch, rid, body,
                                                      headers))
                        fh.flush()
                        os.fsync(fh.fileno())
                    os.replace(tmp, self.path)
                except BaseException:
                    try:
                        os.remove(tmp)
                    except OSError:
                        pass
                    raise
                fsync_dir(os.path.dirname(os.path.abspath(self.path)))
            finally:
                # reopen even on failure: the journal must stay writable
                # (the old complete file is still in place)
                self._fh = open(self.path, "ab")
