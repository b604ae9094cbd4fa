"""Replicated control plane: WAL shipping, follower reads, election.

Every hardened layer so far — the WAL, the chaos engine (faults.py)
— still funnels through ONE state-server process.  This module splits
the roles the way Singularity's planet-scale store does (arxiv
2202.07848): ONE elected leader accepts writes; N follower replicas
continuously replay the leader's fsync'd WAL and serve the read-heavy
traffic (watch mirrors, /traces, /leases, vtpctl, dashboards) at a
bounded, *advertised* staleness.  docs/design/replication.md is the
full protocol; the contract in one breath:

  * SHIPPING — followers long-poll ``GET /wal?since_seq=N`` on the
    leader; the response carries raw framed WAL lines (crc32hex +
    body), ONLY up to the leader's fsync horizon.  The follower
    re-verifies every record's CRC and sequence before appending it to
    its OWN WAL and fsyncing — a torn or bit-flipped shipped record is
    refused wholesale (never silently applied) and re-requested.  A
    follower behind the leader's ship ring (compaction, heal, fresh
    boot) bootstraps from ``GET /replica_snapshot`` then tails.
  * QUORUM COMMIT — with a replica group configured, the leader's ack
    barrier extends past its local fsync: a write is acked only once a
    commit quorum (majority of the group, leader included) holds it
    durably.  The quorum wait doubles as the fence: a partitioned
    leader cannot ack anything (writes 503 + Retry-After through the
    read-only degrade machinery), so a new leader elected on the other
    side can never lose an acked write.
  * STALENESS — a follower's visible rv is gated on its own fsync
    horizon exactly like the leader's (state_server._visible_rv), so
    no follower ever serves an rv it has not durably applied; its
    advertised lag is measured, not asserted.
  * ELECTION — terms extend the BASE.BOOT epoch machinery: the term is
    journaled per replica (term.json, atomic write) and every shipped
    batch carries the leader's term.  On leader silence past the TTL a
    follower campaigns at term+1; peers grant a vote only when they
    ALSO lost the leader, the candidate's WAL prefix is at least as
    long as theirs, and they have not voted this term.  A majority
    (counting the candidate) promotes: the new leader bumps the boot
    half of the epoch (same BASE — mirrors delta-resync across the
    promotion) and starts shipping at its term.  A deposed leader
    that lost its commit quorum probes the group, finds the higher
    term, demotes itself and full-resyncs as a follower.
  * WRITE ROUTING — any mutation hitting a follower is refused with
    the read-only 503 + Retry-After shape plus a ``leader`` hint;
    cache/remote_cluster.py re-routes to the hinted leader under the
    unified retry policy.

A two-replica group cannot distinguish leader death from partition,
so automatic promotion there needs the explicit --election-quorum 1
override (the lab/smoke configuration); three or more replicas elect
on true majorities.  The split-brain argument lives in the doc.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

TERM_FILE = "term.json"
# follower tail long-poll ceiling; also the shipping heartbeat — a
# healthy idle group exchanges one empty batch per WAL_POLL_S.  Kept
# short: a blackholed poll is only noticed when its client timeout
# fires, so this bounds the leader-death detection latency
WAL_POLL_S = 2.0
# records per shipped batch: bounds both the response size and the
# follower's apply-then-fsync critical section
SHIP_BATCH = 2048


def http_json(method: str, url: str, payload=None, timeout: float = 10.0,
              token: str = ""):
    """One replication-plane RPC (stdlib only, gzip-aware).  Raises
    OSError/ValueError like any wire call; callers own the retry.
    Truncated/garbled responses (HTTPException — e.g. an injected
    connection reset cutting a /wal body mid-read) normalize to
    OSError too: the chaos conductor found a follower's tail thread
    dying on an uncaught IncompleteRead."""
    from http.client import HTTPException
    data = None
    if payload is not None:
        data = json.dumps(payload, separators=(",", ":")).encode()
    headers = {"Content-Type": "application/json",
               "Accept-Encoding": "gzip"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            from volcano_tpu_torch.server.httputil import read_json_body
            return read_json_body(resp)
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except Exception:  # noqa: BLE001
            msg = str(e)
        raise OSError(f"HTTP {e.code}: {msg}") from None
    except HTTPException as e:
        raise OSError(f"truncated response: {e!r}") from None


class ShippedCorruptionError(RuntimeError):
    """A shipped WAL record failed its CRC / frame / sequence check on
    the follower: the batch is refused wholesale — applying a prefix
    would desync the replica from the seq stream."""


class Replication:
    """Per-process replication coordinator: role, term, peers.

    Attached to a StateServer (attach()); the server handler consults
    it for write gating (may_write), shipping (/wal), votes
    (/campaign) and status (/replication + /durability.replication).
    """

    def __init__(self, replica_id: str, peers: Optional[List[str]] = None,
                 self_url: str = "", replicate_from: str = "",
                 commit_quorum: int = 0, election_quorum: int = 0,
                 ttl: float = 3.0, sync_timeout: float = 10.0,
                 token: str = ""):
        self.replica_id = replica_id
        self.peers = [p.rstrip("/") for p in (peers or []) if p]
        self.self_url = self_url.rstrip("/")
        self.replicate_from = replicate_from
        group = len(self.peers) + 1
        majority = group // 2 + 1
        # commit quorum: replicas (leader included) that must hold a
        # record durably before its ack.  1 = async shipping (a lone
        # leader, or an explicit availability-over-durability choice).
        self.commit_quorum = int(commit_quorum) or majority
        # election quorum: votes (candidate included) to promote.  A
        # 2-node lab needs the explicit =1 override; the default
        # majority is the split-brain-safe setting for >=3.
        self.election_quorum = int(election_quorum) or majority
        self.ttl = float(ttl)
        self.sync_timeout = float(sync_timeout)
        self.token = token

        self.role = "follower" if replicate_from else "leader"
        # a follower may SERVE only once it has re-proven continuity
        # with the current group (first bootstrap / promotion): a
        # deposed leader rebooting over its old dir would otherwise
        # briefly serve its locally-recovered tail — records that
        # were never quorum-acked and that the re-sync is about to
        # discard (the chaos conductor caught exactly that sub-second
        # window as an rv regression)
        self.proven = self.role == "leader"
        self.term = 0
        # the term under which this replica's WAL SUFFIX was written
        # (Raft's lastLogTerm): elections compare (log_term, seq)
        # lexicographically — length alone would let a deposed
        # leader's LONGER but stale-term tail outvote a shorter
        # history that carries quorum-acked higher-term records
        self.log_term = 0
        self.voted_for = ""
        self.leader_url = replicate_from.rstrip("/") \
            if replicate_from and replicate_from != "auto" else ""
        self.state = None               # StateServer, set by attach()
        self.promotions = 0
        self.bootstraps = 0
        self.refused_batches = 0        # CRC/seq-refused shipped batches

        self._lock = threading.Lock()
        # leader side: follower ack tracking + the two conditions the
        # protocol waits on (new durable records to ship; quorum acks)
        self._ship_cv = threading.Condition(self._lock)
        self._quorum_cv = threading.Condition(self._lock)
        self._followers: Dict[str, dict] = {}
        # follower side: lag bookkeeping (monotonic clock)
        self._last_leader_ok = time.monotonic()
        self._caught_up_at = time.monotonic()
        self._caught_up = False
        self._stop = threading.Event()
        self._tail_thread: Optional[threading.Thread] = None
        # tail generation: bumped on every role transition so a tail
        # loop from a PREVIOUS follower stint (e.g. parked in a
        # long-poll across a promote->demote bounce) exits instead of
        # running concurrently with the fresh one — two tails would
        # double-apply shipped batches
        self._tail_gen = 0
        self._promoting = False         # promote() between its two locks
        self._watchdog_thread: Optional[threading.Thread] = None
        # deterministic campaign jitter per replica (not wall-seeded:
        # two replicas must not campaign in lockstep)
        self._rng = random.Random(replica_id)

    # -- lifecycle -----------------------------------------------------

    def attach(self, state) -> None:
        self.state = state
        self._load_term()
        # the quorum FLOOR: everything recovered at boot (or held at
        # promotion) was already acked under a prior configuration's
        # quorum — it never needs re-acknowledgment by the current
        # follower set.  Only records appended past the floor gate
        # acks and watch visibility on the live quorum.
        self._quorum_floor_seq = state.durable.synced_seq
        self._quorum_floor_rv = state.durable.synced_rv
        if self.role == "leader":
            self.term = max(self.term, 1)
            self._persist_term()
        self._export_role()

    def start(self) -> None:
        """Spin the role threads (after the HTTP listener is up, so
        self_url answers peers)."""
        if self.role == "follower":
            self._start_tail()
        self._watchdog_thread = threading.Thread(
            target=self._watchdog, name="repl-watchdog", daemon=True)
        self._watchdog_thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            self._ship_cv.notify_all()
            self._quorum_cv.notify_all()

    def _start_tail(self) -> None:
        self._tail_thread = threading.Thread(
            target=self._tail_loop, name="repl-tail", daemon=True)
        self._tail_thread.start()

    # -- term persistence ----------------------------------------------

    def _term_path(self) -> str:
        return os.path.join(self.state.durable.dir, TERM_FILE)

    def _load_term(self) -> None:
        try:
            with open(self._term_path(), encoding="utf-8") as f:
                doc = json.load(f)
            self.term = int(doc.get("term", 0))
            self.log_term = int(doc.get("log_term", doc.get("term",
                                                            0)))
            self.voted_for = doc.get("voted_for", "")
        except (OSError, ValueError):
            # vtplint: disable=except-pass (first boot: no term file yet, term 0 is correct)
            pass

    def _persist_term(self) -> None:
        from volcano_tpu_torch.server.durability import atomic_write_json
        atomic_write_json(self._term_path(),
                          {"term": self.term,
                           "log_term": self.log_term,
                           "voted_for": self.voted_for})

    # -- role / gating ---------------------------------------------------

    @property
    def is_leader(self) -> bool:
        return self.role == "leader"

    def may_write(self) -> bool:
        return self.role == "leader"

    def leader_hint(self) -> str:
        """Best-known leader URL for the 503 redirect hint."""
        if self.role == "leader":
            return self.self_url
        return self.leader_url

    def _export_role(self) -> None:
        from volcano_tpu_torch import metrics
        metrics.swap_gauge_families(
            ("server_replication_role",),
            [("server_replication_role", {"role": r},
              1.0 if r == self.role else 0.0)
             for r in ("leader", "follower", "candidate")])
        metrics.set_gauge("server_replication_term", float(self.term))

    # -- leader: shipping + quorum ---------------------------------------

    def notify_durable(self) -> None:
        """Called by StateServer.commit() after the local fsync: wake
        follower long-polls parked in ship()."""
        with self._lock:
            self._ship_cv.notify_all()

    def ship(self, since_seq: int, follower: str, applied_seq: int,
             applied_rv: int, term: int, timeout: float) -> dict:
        """The /wal route: record the follower's durable position (its
        ack — this is what the commit quorum counts), then return the
        framed records past since_seq, long-polling for news."""
        from volcano_tpu_torch import metrics
        st = self.state
        if self.role != "leader":
            return {"not_leader": True, "role": self.role,
                    "term": self.term, "leader": self.leader_hint()}
        if term > self.term:
            # a higher term exists: someone won an election we missed.
            # Refuse to ship at a stale term; the watchdog will demote.
            return {"not_leader": True, "role": self.role,
                    "term": self.term, "leader": ""}
        now = time.monotonic()
        with self._lock:
            self._followers[follower] = {
                "applied_seq": int(applied_seq),
                "applied_rv": int(applied_rv),
                "last_contact": now}
            self._quorum_cv.notify_all()
        deadline = time.monotonic() + max(0.0, min(timeout, 30.0))
        while True:
            out = st.durable.ship_since(since_seq, limit=SHIP_BATCH)
            if out["records"] or out["resync"] or \
                    time.monotonic() >= deadline or self._stop.is_set() \
                    or self.role != "leader":
                break
            with self._lock:
                self._ship_cv.wait(
                    min(0.5, max(0.01, deadline - time.monotonic())))
        if out["records"]:
            metrics.inc("server_replication_shipped_records_total",
                        value=float(len(out["records"])))
            metrics.inc("server_replication_shipped_bytes_total",
                        value=float(sum(len(r) for r in out["records"])))
            metrics.set_gauge("server_replication_last_shipped_rv",
                              float(st.durable.synced_rv))
        return {"term": self.term, "epoch": st.epoch,
                "leader": self.self_url or "",
                "last_seq": out["last_seq"],
                "snapshot_rv": st.durable.snapshot_rv,
                "resync": out["resync"], "records": out["records"]}

    def _evict_stale_followers_locked(self, now: float) -> None:
        """Drop tracking for followers silent past 10x the TTL: the
        map keys on the client-supplied follower id, so restarted
        replicas under new ids (or stray probes) would otherwise grow
        it — and its ids label a metric family — without bound."""
        horizon = now - 10 * self.ttl
        stale = [fid for fid, f in self._followers.items()
                 if f["last_contact"] < horizon]
        for fid in stale:
            del self._followers[fid]

    def quorum_positions(self) -> List[int]:
        """Durable seq positions across the group, leader first."""
        now = time.monotonic()
        horizon = now - 3 * self.ttl
        with self._lock:
            self._evict_stale_followers_locked(now)
            acks = [f["applied_seq"] for f in self._followers.values()
                    if f["last_contact"] >= horizon]
        return [self.state.durable.synced_seq] + sorted(acks,
                                                        reverse=True)

    def quorum_seq(self) -> int:
        """Highest seq held durably by a commit quorum of the group.
        RATCHETED via the floor: a position once quorum-held stays
        covered (those records were durable on a quorum at that
        instant — a follower later dying cannot un-happen them), so
        the horizon never regresses when an ack drops out of the
        contact window.  The floor starts at the boot/promotion
        horizon — the prefix acked under the prior configuration."""
        pos = self.quorum_positions()
        if self.commit_quorum <= 1:
            return pos[0]
        if len(pos) >= self.commit_quorum:
            with self._lock:
                self._quorum_floor_seq = max(
                    self._quorum_floor_seq,
                    pos[self.commit_quorum - 1])
        return self._quorum_floor_seq

    def quorum_rv(self) -> int:
        """The watch-visibility cap while leading a group: an event is
        released to mirrors only once a commit quorum could survive a
        leader loss still holding it."""
        if self.role != "leader" or self.commit_quorum <= 1:
            return self.state.durable.synced_rv
        horizon = time.monotonic() - 3 * self.ttl
        with self._lock:
            acks = [f["applied_rv"] for f in self._followers.values()
                    if f["last_contact"] >= horizon]
        pos = [self.state.durable.synced_rv] + sorted(acks,
                                                      reverse=True)
        if len(pos) >= self.commit_quorum:
            # same ratchet as quorum_seq: a revision once released
            # to mirrors must never disappear because the follower
            # that acked it died — its records WERE quorum-durable
            with self._lock:
                self._quorum_floor_rv = max(
                    self._quorum_floor_rv,
                    pos[self.commit_quorum - 1])
        return self._quorum_floor_rv

    def wait_quorum(self) -> None:
        """The replicated half of the ack barrier: block until a
        commit quorum holds the leader's current fsync horizon, or
        raise ReadOnlyError (-> 503 + Retry-After) on timeout.  The
        timeout IS the fence: a partitioned leader acks nothing."""
        from volcano_tpu_torch.server.durability import ReadOnlyError
        if self.role != "leader" or self.commit_quorum <= 1:
            return
        target = self.state.durable.synced_seq
        deadline = time.monotonic() + self.sync_timeout
        while self.quorum_seq() < target:
            if self.role != "leader":
                raise ReadOnlyError("deposed mid-commit (replication "
                                    f"term {self.term})")
            remain = deadline - time.monotonic()
            if remain <= 0 or self._stop.is_set():
                raise ReadOnlyError(
                    f"replication quorum lost ({self.commit_quorum} "
                    f"needed, positions {self.quorum_positions()})")
            with self._lock:
                self._quorum_cv.wait(min(0.2, remain))

    def quorum_ok(self) -> bool:
        if self.role != "leader" or self.commit_quorum <= 1:
            return True
        return self.quorum_seq() >= self.state.durable.synced_seq

    # -- votes / promotion ------------------------------------------------

    def handle_campaign(self, body: dict) -> dict:
        """POST /campaign vote request.  Grant iff the candidate's
        term is news, its HISTORY is at least as current as ours —
        (log_term, seq) compared lexicographically, Raft's
        lastLogTerm rule: a deposed leader's longer stale-term tail
        must never outvote a shorter history carrying quorum-acked
        higher-term records — and WE also consider the leader dead
        (a follower in live contact refuses, so a partitioned
        minority cannot depose a healthy leader)."""
        term = int(body.get("term", 0))
        last_seq = int(body.get("last_seq", 0))
        log_term = int(body.get("log_term", 0))
        candidate = body.get("candidate", "")
        url = body.get("url", "")
        with self._lock:
            if self.role == "leader" or self._promoting:
                # a live leader never votes; a candidate with a higher
                # term than a DEPOSED leader reaches it via watchdog.
                # A promotion under way answers as the leader it is
                # about to publish
                return {"granted": False, "term": self.term,
                        "leader": self.self_url}
            silent = time.monotonic() - self._last_leader_ok
            my_seq = self.state.durable.synced_seq
            current = (log_term, last_seq) >= (self.log_term, my_seq)
            if term <= self.term or not current or \
                    silent < self.ttl:
                return {"granted": False, "term": self.term,
                        "reason": f"term={self.term} my_log="
                                  f"({self.log_term},{my_seq}) "
                                  f"leader_silent={silent:.2f}s"}
            self.term = term
            self.voted_for = candidate
            self._persist_term()
            if url:
                # optimistic re-target: if the candidate wins, the
                # next tail poll lands on the new leader immediately
                self.leader_url = url
        self._export_role()
        log.info("vote granted to %s at term %d", candidate, term)
        return {"granted": True, "term": term}

    def try_campaign(self) -> bool:
        """One election attempt at term+1.  Returns True on win."""
        new_term = self.term + 1
        my_seq = self.state.durable.synced_seq
        votes = 1                       # self
        body = {"term": new_term, "last_seq": my_seq,
                "log_term": self.log_term,
                "candidate": self.replica_id, "url": self.self_url}
        self.role = "candidate"
        self._export_role()
        log.info("campaigning at term %d (last_seq=%d, need %d votes)",
                 new_term, my_seq, self.election_quorum)
        for peer in self.peers:
            try:
                resp = http_json("POST", peer + "/campaign", body,
                                 timeout=max(1.0, self.ttl / 2),
                                 token=self.token)
            except (OSError, ValueError):
                # vtplint: disable=except-pass (an unreachable peer is a NO vote; the quorum count below is the signal)
                continue
            if resp.get("granted"):
                votes += 1
            elif int(resp.get("term", 0)) > new_term:
                # someone is already ahead: adopt and stand down
                self.term = int(resp["term"])
                self._persist_term()
                self.role = "follower"
                self._export_role()
                return False
        if votes >= self.election_quorum:
            return self.promote(new_term)
        self.role = "follower"
        self._export_role()
        log.info("election lost at term %d (%d/%d votes)", new_term,
                 votes, self.election_quorum)
        return False

    def promote(self, term: int) -> bool:
        """Become the leader at *term*: persist the term, bump the
        BOOT half of the epoch (same BASE — mirrors delta-resync
        across the promotion), open the write path, start shipping.

        ABANDONED (returns False) when this replica's term moved past
        *term* — OR when it granted ITS VOTE to another candidate at
        exactly *term* while its own campaign was in flight.  Two
        concurrent candidates otherwise both promote: the chaos
        conductor caught that dual-leader split twice — first on a
        higher-term grant, then on simultaneous same-term campaigns
        that cross-granted each other (both-abandon is safe; the
        per-replica campaign jitter breaks the ensuing retry tie)."""
        from volcano_tpu_torch import metrics
        st = self.state
        with self._lock:
            if self.term > term or self.role == "leader" or \
                    self._promoting or \
                    (self.term == term and
                     self.voted_for not in ("", self.replica_id)):
                log.warning("promotion at term %d ABANDONED (term "
                            "now %d, role %s): a higher-term "
                            "candidate won mid-campaign", term,
                            self.term, self.role)
                abandoned = True
            else:
                abandoned = False
                self.term = term
                self.log_term = term    # our appends write at it
                self.voted_for = self.replica_id
                # the role is published below, once the epoch is
                # bumped: a reader never sees a leader's role with the
                # follower's epoch
                self._promoting = True
                self._tail_gen += 1     # retire any parked tail loop
                self.proven = True
                self.leader_url = self.self_url
                self._followers.clear()
                self.promotions += 1
                # everything this replica holds was quorum-acked
                # under the old term (commit quorum included us); the
                # NEW follower set only gates what comes after
                self._quorum_floor_seq = st.durable.synced_seq
                self._quorum_floor_rv = st.durable.synced_rv
        if abandoned:
            if self.role != "leader":
                self.role = "follower"
            self._export_role()
            return False
        try:
            self._persist_term()
            st.on_promote()
        finally:
            # published even if the term or epoch write raised, as the
            # reference's leader is: never left promoting
            with self._lock:
                self._promoting = False
                self.role = "leader"
        metrics.inc("server_replication_promotions_total")
        self._export_role()
        log.warning("PROMOTED to leader at term %d (epoch %s, rv %d, "
                    "seq %d)", term, st.epoch, st._rv,
                    st.durable.synced_seq)
        return True

    def demote(self, leader_url: str) -> None:
        """A deposed leader rejoining the group: flip to follower and
        let the tail loop full-resync (term mismatch forces the
        snapshot bootstrap)."""
        with self._lock:
            if self.role != "leader":
                return
            self.role = "follower"
            self.leader_url = leader_url
            self._tail_gen += 1     # the fresh tail owns this stint
            # our history diverged from the group's (that is WHY we
            # are demoting): serve nothing until the re-sync proves a
            # continuous prefix again
            self.proven = False
        self._last_leader_ok = time.monotonic()
        self._export_role()
        log.warning("DEPOSED: demoting to follower of %s (our term "
                    "%d was superseded)", leader_url, self.term)
        self._start_tail()

    def _watchdog(self) -> None:
        """Leader-side self-check, every ~ttl: probe the group for a
        higher term and demote on finding one.  Covers both the
        partition-heal path (our quorum moved on without us) and the
        idle deposed leader (no writes, so the quorum gate alone
        never trips — the chaos conductor caught exactly that replica
        sitting out a run as a stale 'leader')."""
        while not self._stop.wait(max(0.5, self.ttl)):
            if self.role != "leader" or not self.peers:
                continue
            for peer in self.peers:
                try:
                    doc = http_json("GET", peer + "/replication",
                                    timeout=2.0, token=self.token)
                except (OSError, ValueError):
                    # vtplint: disable=except-pass (watchdog probe: a dark peer proves nothing, the next tick re-probes)
                    continue
                if int(doc.get("term", 0)) > self.term:
                    hint = doc.get("leader") or (
                        peer if doc.get("role") == "leader" else "")
                    if hint and hint.rstrip("/") != self.self_url:
                        self.demote(hint)
                        break

    # -- follower: bootstrap + tail ---------------------------------------

    def _discover_leader(self) -> str:
        """Scan the peer group for the current leader (highest term
        wins); used by --replicate-from auto and after a lost leader."""
        best, best_term = "", -1
        for peer in self.peers:
            try:
                doc = http_json("GET", peer + "/replication",
                                timeout=2.0, token=self.token)
            except (OSError, ValueError):
                # vtplint: disable=except-pass (discovery scan: a dark peer simply cannot be the leader we adopt)
                continue
            term = int(doc.get("term", 0))
            if doc.get("role") == "leader" and term > best_term:
                best, best_term = peer, term
            elif doc.get("leader") and term > best_term:
                best, best_term = doc["leader"], term
        return best

    def _bootstrap(self, leader: str) -> None:
        """Full re-sync: install the leader's replica snapshot (store
        + leases + req cache + wal_seq + term) over the local state —
        the path a follower behind the ship ring, a fresh dir, or an
        epoch/term mismatch all take."""
        from volcano_tpu_torch import metrics
        doc = http_json("GET", leader + "/replica_snapshot",
                        timeout=60.0, token=self.token)
        self.state.install_replica_snapshot(doc)
        new_term = int(doc.get("term", 0))
        if new_term > self.term:
            self.term = new_term
            self.voted_for = ""
        # the installed history IS the leader's: its suffix term too
        self.log_term = new_term or self.log_term
        self._persist_term()
        self.bootstraps += 1
        metrics.inc("server_replication_bootstraps_total")
        with self._lock:
            # a bootstrap installs the leader's full state: the
            # replica is provably current at this instant — and
            # provably CONTINUOUS with the group, so it may serve
            self._caught_up = True
            self._caught_up_at = time.monotonic()
            self.proven = True
        self._export_role()
        log.info("bootstrapped from %s: rv=%d seq=%d term=%d epoch=%s",
                 leader, self.state._rv, self.state.durable.synced_seq,
                 self.term, self.state.epoch)

    def _mark_behind(self) -> None:
        """The follower can no longer prove it is current (failed
        poll, partition, stale-leader answer): advertised lag starts
        counting from the LAST successful leader contact — never a
        frozen 0 (the bounded-staleness invariant audits exactly
        this)."""
        with self._lock:
            if self._caught_up:
                self._caught_up = False
                self._caught_up_at = self._last_leader_ok

    def lag_seconds(self) -> float:
        with self._lock:
            if self.role == "leader":
                return 0.0
            # a dead tail thread can never claim currency: whatever
            # killed it, the replica stopped applying — advertise the
            # drift from the last proven contact (defense in depth on
            # top of the tail loop's own exception normalization)
            tail_dead = (self._tail_thread is not None
                         and not self._tail_thread.is_alive()
                         and not self._stop.is_set())
            # a caught-up follower is current as of the response that
            # proved it, not after: the next poll may be stalled on a
            # dead link, so its lag is the age of that proof, never 0
            # (the reference's 0 here let a follower whose link was
            # blackholed right after a reply claim currency for a whole
            # poll timeout while the leader moved on)
            ref = self._last_leader_ok if tail_dead and \
                self._caught_up else self._caught_up_at
            return time.monotonic() - ref

    def _tail_loop(self) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.server.durability import ReadOnlyError
        st = self.state
        gen = self._tail_gen
        backoff = 0.1
        bootstrapped_term = None
        while not self._stop.is_set() and self.role == "follower" \
                and self._tail_gen == gen:
            leader = self.leader_url
            if not leader:
                leader = self._discover_leader()
                if not leader:
                    if self._stop.wait(min(backoff, 1.0)):
                        return
                    backoff = min(backoff * 2, 2.0)
                    self._maybe_campaign()
                    continue
                self.leader_url = leader
            try:
                resp = http_json(
                    "GET",
                    f"{leader}/wal?since_seq={st.durable.synced_seq}"
                    f"&follower={self.replica_id}"
                    f"&applied_seq={st.durable.synced_seq}"
                    f"&applied_rv={st.durable.synced_rv}"
                    f"&term={self.term}&timeout={WAL_POLL_S}",
                    timeout=WAL_POLL_S + 3.0, token=self.token)
            except (OSError, ValueError) as e:
                log.debug("wal poll to %s failed (%s)", leader, e)
                self._mark_behind()
                from volcano_tpu_torch import metrics
                metrics.set_gauge("server_replication_lag_seconds",
                                  self.lag_seconds())
                if self._stop.wait(min(backoff, 1.0)):
                    return
                backoff = min(backoff * 2, 2.0)
                self._maybe_campaign()
                continue
            backoff = 0.1
            if self.role != "follower" or self._tail_gen != gen:
                # promoted/demoted (or stopped) while this poll was
                # in flight: a retired tail must NOT apply records —
                # the new role (or the fresh tail) owns the history
                return
            if resp.get("not_leader"):
                self._mark_behind()
                r_term = int(resp.get("term", 0) or 0)
                if resp.get("role") == "leader" and r_term and \
                        r_term < self.term and \
                        time.monotonic() - self._last_leader_ok \
                        > 3 * self.ttl:
                    # liveness valve: we granted/advanced a term that
                    # never produced a leader (failed election), and
                    # the only live leader refuses our inflated term.
                    # Far past any in-flight promotion window, step
                    # back down to its term and tail it.
                    log.warning("adopting the live leader's term %d "
                                "(our term %d produced no leader)",
                                r_term, self.term)
                    self.term = r_term
                    self.voted_for = ""
                    self._persist_term()
                    continue
                hinted = (resp.get("leader") or "").rstrip("/")
                self.leader_url = hinted if hinted != self.self_url \
                    else ""
                self._maybe_campaign()
                continue
            term = int(resp.get("term", 0))
            if term < self.term:
                # stale leader from a superseded term: never apply
                self.leader_url = ""
                continue
            self._last_leader_ok = time.monotonic()
            needs_boot = (
                resp.get("resync")
                or term > self.term
                or bootstrapped_term != term
                or self._epoch_base(resp.get("epoch", "")) !=
                self._epoch_base(st.epoch))
            if needs_boot and (resp.get("resync") or
                               bootstrapped_term is None or
                               term != bootstrapped_term):
                # epoch/term mismatch or ship-ring fall-off: the tail
                # cannot prove continuity — full re-sync
                self._mark_behind()
                try:
                    self._bootstrap(leader)
                    bootstrapped_term = self.term
                except (OSError, ValueError) as e:
                    log.warning("bootstrap from %s failed (%s)",
                                leader, e)
                    if self._stop.wait(0.5):
                        return
                continue
            records = resp.get("records") or []
            if records and term != self.log_term:
                # the suffix we are about to journal was written at
                # the leader's term: record it BEFORE applying (the
                # election currency comparison reads it)
                self.log_term = term
                self._persist_term()
            if records:
                try:
                    st.apply_shipped(records)
                except ShippedCorruptionError as e:
                    # in-flight corruption: refuse the whole batch and
                    # re-request — NEVER a partial apply
                    self.refused_batches += 1
                    metrics.inc(
                        "server_replication_refused_batches_total")
                    log.error("shipped batch REFUSED (%s); "
                              "re-requesting from seq %d", e,
                              st.durable.synced_seq)
                    if self._stop.wait(0.1):
                        return
                    continue
                except ReadOnlyError as e:
                    # THIS replica's own disk degraded mid-apply:
                    # wait out the store's heal loop, then force a
                    # full re-sync — the heal writes a probe record
                    # into the local WAL, so the local seq stream
                    # has diverged from the leader's and a tail can
                    # never safely continue.  The thread must
                    # survive this (a dead tail never recovers and
                    # never campaigns).
                    self._mark_behind()
                    log.error("follower store degraded mid-apply "
                              "(%s); waiting for heal, then "
                              "re-syncing", e)
                    while not self._stop.is_set() and \
                            self._tail_gen == gen and \
                            st.readonly_reason:
                        if self._stop.wait(0.5):
                            return
                    bootstrapped_term = None    # force bootstrap
                    continue
            caught = st.durable.synced_seq >= int(
                resp.get("last_seq", 0))
            with self._lock:
                if caught:
                    self._caught_up = True
                    self._caught_up_at = time.monotonic()
                elif self._caught_up:
                    self._caught_up = False
                    self._caught_up_at = time.monotonic()
            metrics.set_gauge("server_replication_lag_seconds",
                              self.lag_seconds())
            metrics.set_gauge("server_replication_applied_rv",
                              float(st.durable.synced_rv))

    def _maybe_campaign(self) -> None:
        """Campaign when the leader has been silent past the TTL plus
        a per-replica jitter slot (staggers simultaneous candidates)."""
        if self.role != "follower" or self._stop.is_set():
            return
        silent = time.monotonic() - self._last_leader_ok
        if silent < self.ttl + self._rng.uniform(0.0, self.ttl / 2):
            return
        if self.try_campaign():
            return
        # lost or yielded: wait a beat so the winner can reach us
        self._last_leader_ok = time.monotonic() - self.ttl / 2

    @staticmethod
    def _epoch_base(epoch: str) -> str:
        return epoch.rsplit(".", 1)[0]

    # -- status ----------------------------------------------------------

    def status(self) -> dict:
        from volcano_tpu_torch import metrics
        st = self.state
        now = time.monotonic()
        out = {
            "replica_id": self.replica_id,
            "role": self.role,
            "proven": self.proven,
            "term": self.term,
            "leader": self.leader_hint(),
            "peers": self.peers,
            "commit_quorum": self.commit_quorum,
            "applied_seq": st.durable.synced_seq,
            "applied_rv": st.durable.synced_rv,
            "lag_s": round(self.lag_seconds(), 3),
            "promotions": self.promotions,
            "bootstraps": self.bootstraps,
            "refused_batches": self.refused_batches,
        }
        if self.role == "leader":
            with self._lock:
                self._evict_stale_followers_locked(now)
                out["followers"] = {
                    fid: {"applied_seq": f["applied_seq"],
                          "applied_rv": f["applied_rv"],
                          # seconds since the follower's last ack —
                          # bounded by the long-poll period on an
                          # idle group, so it measures CONTACT, not
                          # staleness (the follower's own lag_s does)
                          "ack_age_s": round(max(
                              0.0, now - f["last_contact"]), 3)}
                    for fid, f in self._followers.items()}
            out["last_shipped_rv"] = st.durable.synced_rv
            out["quorum_ok"] = self.quorum_ok()
            # whole-family swap: a departed follower's series drops
            # out instead of lingering as a stale labeled gauge
            metrics.swap_gauge_families(
                ("server_replication_follower_lag_rv",),
                [("server_replication_follower_lag_rv",
                  {"follower": fid},
                  float(st.durable.synced_rv - f["applied_rv"]))
                 for fid, f in out["followers"].items()])
        metrics.set_gauge("server_replication_lag_seconds",
                          out["lag_s"])
        return out
