"""The batched daemon over a dp x tp mesh of several ranks: a rank-0 front
end that broadcasts admissions.

In the port each rank of a mesh is a process, and the lockstep
``ContinuousBatcher(mesh=...)`` needs every rank to see the same
submissions in the same order and to call ``step()`` the same number of
times. The daemon's clients reach one process only, so:

- ``python -m qwen3_tts_tpu_torch.serve.daemon --batch 4 --tp 2 --dp 2``
  starts its own N = dp * tp ranks (daemon._launch_ranks, through
  multihost.run_own_ranks); each runs ``rank_main`` of this module, on
  ``cuda:rank`` (``cpu`` over gloo with ``--device cpu``).
- Rank 0 is the front end. It runs the socket, the HTTP gateway, the
  voice registry and the lockstep thread (``LockstepFront``, the
  batcher that the rank-0 TTSDaemon submits to). The batcher's own
  ``_loop`` thread never runs on a multi-rank mesh: on every rank the
  lockstep thread alone calls ``step()``.
- Before every ``step()`` rank 0 broadcasts one ``StepMessage`` over a
  gloo group of the host: the step's new submissions in arrival order,
  the ids of the requests cancelled since the last message, or a stop.
  Every rank submits them in that order, applies the cancellations, then
  steps (``LockstepRank``). Voices and prompt dirs are read on rank 0;
  their codes travel in the message.
- After every ``step()`` each rank sends rank 0 its events (a
  ``gather_object``): the stream segments, in order, and the finished
  requests with (codes, audio) of the slots it serves (tp rank 0 of the
  owning dp group), and the failures. Rank 0 resolves the client's
  Future and calls its ``on_chunk``; its timings come from rank 0's own
  lockstep copy of the request, admitted and harvested in the same step
  as on the serving rank.
- Cancellation: the daemon flags the front end's request objects, never
  the ones the batchers step on; a cancellation takes effect only
  through the broadcast, on every rank at the same chunk boundary.
  ``max_queue`` is decided at rank 0's front end; the ranks' batchers
  are unbounded, so a rank never refuses what rank 0 accepted.
- Idle: no collective runs while nothing is queued or decoding, but
  every KEEPALIVE_S seconds rank 0 sends an empty message (and every
  rank steps, idly: an idle step runs no collective), so the followers
  waiting in the broadcast stay inside the collective timeout
  (QWEN3_TTS_DIST_INIT_TIMEOUT).
- Stop: rank 0 drains, broadcasts stop, gathers every rank's summary
  (slots held, requests queued, free pages) and every rank leaves
  through multihost.barrier and shutdown_distributed. A rank whose
  ``step()`` raises ends the world (spawn_ranks ends the others); the
  clients waiting get an error and the daemon exits non-zero: ranks
  cannot carry on a half-failed collective. A per-request error that
  every rank decides alike on the host (an id outside the vocabulary at
  admission) fails that request only.
"""

from __future__ import annotations

import dataclasses
import sys
import threading
import time
import traceback
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from qwen3_tts_tpu_torch.serve.batching import OverloadedError

# seconds between the empty messages of an idle front end
KEEPALIVE_S = 5.0


@dataclasses.dataclass
class Submission:
    """One request as every rank submits it to its batcher."""

    id: int
    text_ids: np.ndarray
    n_text: int
    seed: int
    max_tokens: Optional[int] = None
    priority: int = 0
    stream: bool = False
    ref_codes: Optional[np.ndarray] = None
    n_target: Optional[int] = None


@dataclasses.dataclass
class StepMessage:
    """What every rank applies before a step: submissions in arrival
    order, then the ids to cancel; or ``stop``."""

    subs: List[Submission] = dataclasses.field(default_factory=list)
    cancel: List[int] = dataclasses.field(default_factory=list)
    stop: bool = False


def encode_message(msg: StepMessage) -> dict:
    """The broadcast form of a message: plain values and numpy arrays."""
    return {"subs": [dataclasses.astuple(s) for s in msg.subs],
            "cancel": [int(i) for i in msg.cancel], "stop": bool(msg.stop)}


def decode_message(wire: dict) -> StepMessage:
    return StepMessage(subs=[Submission(*s) for s in wire["subs"]],
                       cancel=list(wire["cancel"]), stop=wire["stop"])


_ERRORS = {"ValueError": ValueError, "TimeoutError": TimeoutError}


def _error_event(rid: int, exc: BaseException) -> tuple:
    return ("error", rid, type(exc).__name__, str(exc))


def _rebuild_error(name: str, message: str) -> BaseException:
    return _ERRORS.get(name, RuntimeError)(message)


class LockstepRank:
    """One rank's side of the lockstep: its batcher, the host group that
    carries the messages and events, and its requests by id."""

    def __init__(self, batcher, group):
        self.batcher = batcher
        self.group = group
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        # id -> (local Future, stream segments not yet sent)
        self._local: Dict[int, tuple] = {}
        # the requests that finished in the last step: id -> _Request
        self.finished: Dict[int, object] = {}
        self.steps = 0
        self.cancelled = 0
        self.served = 0
        # this rank's summary at the stop (finish)
        self.final: Optional[dict] = None

    def exchange_message(self, msg: Optional[StepMessage]) -> StepMessage:
        """Rank 0 sends ``msg``; every rank returns it."""
        box = [encode_message(msg) if msg is not None else None]
        if self.group is not None:
            dist.broadcast_object_list(box, src=0, group=self.group)
        return decode_message(box[0])

    def apply(self, msg: StepMessage) -> None:
        for s in msg.subs:
            segs: list = []
            fut = self.batcher.submit(
                s.text_ids, s.n_text, seed=s.seed, max_tokens=s.max_tokens,
                on_chunk=segs.append if s.stream else None,
                ref_codes=s.ref_codes, n_target=s.n_target,
                priority=s.priority)
            self._local[s.id] = (fut, segs)
        for rid in msg.cancel:
            entry = self._local.get(rid)
            if entry is not None and not entry[0].done():
                entry[0].request.cancelled = True

    def step(self) -> bool:
        self.steps += 1
        return self.batcher.step()

    def events(self) -> list:
        """This step's events, in order: every new segment of a streaming
        request, then ("done", id, codes, audio) for a request this rank
        served or ("error", id, type, message) for one that failed
        here."""
        out = []
        self.finished = {}
        for rid in list(self._local):
            fut, segs = self._local[rid]
            out += [("seg", rid, seg) for seg in segs]
            segs.clear()
            if not fut.done():
                continue
            del self._local[rid]
            self.finished[rid] = fut.request
            exc = fut.exception()
            if exc is not None:
                if str(exc) == "request cancelled":
                    self.cancelled += 1
                out.append(_error_event(rid, exc))
                continue
            codes, audio = fut.result()
            if codes is not None:
                self.served += 1
                out.append(("done", rid, codes, audio))
        return out

    def gather_events(self, events: list) -> Optional[list]:
        """Every rank's events at rank 0 (in rank order); None
        elsewhere."""
        if self.group is None:
            return [events]
        box = ([None] * dist.get_world_size(self.group) if self.rank == 0
               else None)
        dist.gather_object(events, box, dst=0, group=self.group)
        return box

    def finish(self) -> Optional[list]:
        """After the stop message: this rank's summary as its batcher
        stands (every slot and page should be free), then the batcher
        stopped; every rank's summary at rank 0 (None elsewhere)."""
        b = self.batcher
        summary = {"rank": self.rank, "steps": self.steps,
                   "active_slots": sum(r is not None for r in b._slot_req),
                   "queued": b.occupancy()["queued"],
                   "cancelled": self.cancelled, "served": self.served}
        if b.paged:
            summary["free_pages"] = len(b._free_pages)
            summary["usable_pages"] = b.pool_pages - b._n_groups
        b.stop(drain=False)
        self.final = summary
        return self.gather_events(summary)

    def follow(self) -> dict:
        """A follower's loop: message, apply, step, events, until stop.
        Returns this rank's summary."""
        with torch.inference_mode():
            while True:
                msg = self.exchange_message(None)
                self.apply(msg)
                if msg.stop:
                    self.finish()
                    return self.final
                self.step()
                self.gather_events(self.events())


class _FrontRequest:
    """The request object that the daemon sees (``fut.request``): its
    ``cancelled`` flag is read by the lockstep thread, which broadcasts
    it."""

    def __init__(self, rid: int, on_chunk):
        self.id = rid
        self.on_chunk = on_chunk
        self.cancelled = False
        self.cancel_sent = False
        self.future: Future = Future()
        self.future.request = self
        self.t_submit = time.perf_counter()
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_first_audio: Optional[float] = None
        self.t_done: Optional[float] = None


class LockstepFront:
    """Rank 0's batcher as TTSDaemon uses it (submit, occupancy, start,
    stop) over a LockstepRank: a lockstep thread broadcasts each step's
    message, steps rank 0's batcher and resolves the clients' Futures
    from every rank's events. ``max_queue``: bound on requests waiting
    (not yet broadcast, or queued in the batchers), past which submit()
    raises OverloadedError. ``on_failure``: called once if a step or a
    collective fails; the front end then refuses everything."""

    def __init__(self, rank: LockstepRank, max_queue: Optional[int] = None,
                 mesh_shape: Optional[dict] = None):
        self._rank = rank
        self.max_queue = max_queue
        self.mesh_shape = mesh_shape
        self._cv = threading.Condition()
        self._pending: List[tuple] = []        # (Submission, _FrontRequest)
        self._live: Dict[int, _FrontRequest] = {}
        self._next_id = 0
        self._closed = False
        self._stop_now = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        self.on_failure: Optional[Callable[[], None]] = None
        # every rank's summary, gathered at the stop
        self.summaries: Optional[list] = None

    def submit(self, text_ids: np.ndarray, n_text: int, seed: int = 0,
               max_tokens: Optional[int] = None, on_chunk=None,
               ref_codes=None, n_target: Optional[int] = None,
               priority: int = 0) -> Future:
        """ContinuousBatcher.submit's contract; the request reaches every
        rank with the next message."""
        if (ref_codes is None) != (n_target is None):
            raise ValueError("ref_codes and n_target go together")
        with self._cv:
            if self.max_queue is not None:
                b = self._rank.batcher
                depth = len(self._pending) + b.occupancy()["queued"]
                if depth >= self.max_queue:
                    raise OverloadedError(
                        f"server overloaded: {depth} requests waiting "
                        f"(max_queue={self.max_queue}); retry later")
            req = _FrontRequest(self._next_id, on_chunk)
            if self._closed or self.error is not None:
                req.future.set_exception(
                    self.error or RuntimeError("batcher stopped"))
                return req.future
            sub = Submission(
                self._next_id, np.asarray(text_ids, np.int32), int(n_text),
                int(seed), None if max_tokens is None else int(max_tokens),
                int(priority), on_chunk is not None,
                None if ref_codes is None else np.asarray(ref_codes,
                                                          np.int32),
                None if n_target is None else int(n_target))
            self._next_id += 1
            self._pending.append((sub, req))
            self._cv.notify()
        return req.future

    def occupancy(self) -> dict:
        snap = self._rank.batcher.occupancy()
        snap["queued"] += len(self._pending)
        if self.mesh_shape is not None:
            snap["mesh"] = dict(self.mesh_shape)
        return snap

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._drive, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Refuse new requests, let the submitted ones finish (at most
        ``timeout`` seconds), then broadcast the stop; whatever is left
        fails with RuntimeError."""
        with self._cv:
            self._closed = True
        if drain:
            deadline = time.monotonic() + timeout
            while ((self._pending or self._live) and self.error is None
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        with self._cv:
            self._stop_now = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=max(timeout, 10.0))
        self._fail_all(RuntimeError("batcher stopped"))

    def take_message(self, idle_since: Optional[float] = None
                     ) -> StepMessage:
        """The next message: the pending submissions (a request cancelled
        before it was sent fails here and is not sent), the live requests
        cancelled since the last message, or the stop. With
        ``idle_since``, waits while there is nothing to send, at most
        until KEEPALIVE_S after that time (an empty message)."""
        with self._cv:
            while idle_since is not None and not self._has_news():
                left = idle_since + KEEPALIVE_S - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            msg = StepMessage(stop=self._stop_now)
            for sub, req in self._pending:
                if req.cancelled:
                    _resolve(req, exc=RuntimeError("request cancelled"))
                    continue
                msg.subs.append(sub)
                self._live[sub.id] = req
            self._pending = []
            for rid, req in self._live.items():
                if req.cancelled and not req.cancel_sent:
                    req.cancel_sent = True
                    msg.cancel.append(rid)
            return msg

    def _has_news(self) -> bool:
        return (self._stop_now or bool(self._pending)
                or any(r.cancelled and not r.cancel_sent
                       for r in self._live.values()))

    def _drive(self) -> None:
        rank = self._rank
        try:
            with torch.inference_mode():
                last = time.monotonic()
                while True:
                    idle = not rank.batcher.busy()
                    msg = rank.exchange_message(
                        self.take_message(last if idle else None))
                    last = time.monotonic()
                    rank.apply(msg)
                    if msg.stop:
                        self.summaries = rank.finish()
                        return
                    rank.step()
                    self._resolve_events(rank.gather_events(rank.events()))
        except Exception as e:
            traceback.print_exc()
            self.error = RuntimeError(f"lockstep thread failed: {e!r}")
            self._fail_all(self.error)
            if self.on_failure is not None:
                self.on_failure()

    def _resolve_events(self, by_rank: list) -> None:
        for events in by_rank:
            for ev in events:
                req = self._live.get(ev[1])
                if req is None or req.future.done():
                    continue
                if ev[0] == "seg":
                    if req.on_chunk is not None:
                        try:
                            req.on_chunk(ev[2])
                        except Exception as e:
                            self._done(req, exc=e)
                    continue
                if ev[0] == "done":
                    self._done(req, result=(ev[2], ev[3]))
                else:
                    self._done(req, exc=_rebuild_error(ev[2], ev[3]))

    def _done(self, req: _FrontRequest, result=None, exc=None) -> None:
        local = self._rank.finished.get(req.id)
        if local is not None:
            req.t_admit, req.t_first = local.t_admit, local.t_first
            req.t_first_audio, req.t_done = local.t_first_audio, local.t_done
        self._live.pop(req.id, None)
        _resolve(req, result, exc)

    def _fail_all(self, exc: BaseException) -> None:
        with self._cv:
            reqs = [r for _, r in self._pending] + list(self._live.values())
            self._pending, self._live = [], {}
        for r in reqs:
            _resolve(r, exc=exc)


def _resolve(req: _FrontRequest, result=None, exc=None) -> None:
    if req.future.done():
        return
    if exc is not None:
        req.future.set_exception(exc)
    else:
        req.future.set_result(result)


def rank_main(argv=None, backend: Optional[str] = None,
              device: Optional[str] = None,
              report: Optional[Callable[[dict], None]] = None) -> int:
    """One rank of the multi-rank batched daemon, in the world that
    daemon._launch_ranks (or a caller's multihost.spawn_ranks) set up
    through the QWEN3_TTS_* variables; ``argv`` is the daemon's command
    line. ``device``: this rank's device (``cpu`` with ``--device cpu``,
    else multihost.default_device); ``backend``: the world's backend
    (multihost.init_distributed's default; two ranks sharing one card
    need "gloo"). ``report`` is called on every rank with its summary
    before it leaves the world. Returns the exit code."""
    from qwen3_tts_tpu_torch.parallel import multihost as mh
    from qwen3_tts_tpu_torch.serve import daemon as dm
    args = dm.parser().parse_args(argv)
    if device is None and args.device == "cpu":
        device = "cpu"
    rc = 1
    try:
        if not mh.init_distributed(backend=backend, device=device):
            print("lockstep rank: not started in a world of several ranks "
                  "(QWEN3_TTS_NUM_PROCESSES)", file=sys.stderr)
            return 2
        mesh = mh.make_serving_mesh(tp=args.tp or 1,
                                    dp=args.dp if args.dp > 0 else None)
        group = dist.new_group(backend="gloo")
        engine, batcher = dm.build(args, mesh, max_queue=None)
        rank = LockstepRank(batcher, group)
        if mesh.rank == 0:
            print(f"mesh dp{mesh.shape['dp']}xtp{mesh.shape['tp']} over "
                  f"{mesh.devices.size} device(s)", flush=True)
            front = LockstepFront(
                rank, args.max_queue if args.max_queue > 0 else None,
                mesh.shape)
            rc = dm.serve_main(args, engine, front)
            if rc != 0:
                # the followers may wait in a collective that will not
                # come: leave at once, so that spawn_ranks ends them
                mh.shutdown_distributed()
                return rc
            print(f"lockstep ranks at stop: {front.summaries}", flush=True)
            summary = rank.final
        else:
            summary = rank.follow()
            rc = 0
        if report is not None:
            report(summary)
        mh.barrier("daemon_done")
    except Exception:
        traceback.print_exc()
        mh.shutdown_distributed()
        return 1
    mh.shutdown_distributed()
    return rc


if __name__ == "__main__":
    sys.exit(rank_main())
