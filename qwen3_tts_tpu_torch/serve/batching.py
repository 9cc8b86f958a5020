"""Continuous batching: many requests through one batched decode loop.
Twin of qwen3_tts_tpu/serve/batching.py.

- One batched ``GenState`` with B slots; the decode loop
  (engine/generate.run_steps) advances every slot in lockstep,
  ``decode_chunk`` tokens per scheduler step.
- Between chunks the scheduler admits queued requests into free slots (a
  batch-1 prefill, cached in a small prefix LRU, spliced into the slot in
  place) and harvests finished slots (EOS, the request's token budget or
  a full KV allocation): each is vocoded and its Future resolved.
- A request's codes depend only on its seed: its row key rides into the
  slot, and every draw hashes (key, token counter, site), so a request in
  a busy batch decodes exactly what it decodes alone.
- ``paged=True`` keeps the talker KV in a block-paged pool
  (models/transformer.PagedKV): slots own ``page_size``-row pages through
  a page table that the scheduler grows between chunks and recycles at
  harvest; the decode step's attention is then K4. Page 0 is reserved:
  a released slot's zeroed table points there.
- The talker is bf16 (the ``dtype``) by default, the code predictor int8
  (``quantize_cp``), so at batch <= 8 the 14 CP steps run on K2; with
  ``TalkerConfig(attention_impl="pallas")`` a dense step's attention runs
  on K5.
- A cloning request (``submit(ref_codes=..., n_target=...)``) admits with
  the cloned prefix that the engine builds for the same prompt
  (talker.cloned_ref_limit, bucket_ref_frames, request_prefix), and
  paces EOS on its target text's ``n_target`` tokens.
- A finished slot is vocoded through vocoder.synthesize_exact (one window
  up to 256 tokens, left-context chunks past that). A streaming request
  (``submit(on_chunk=...)``) instead advances its own incremental
  vocoder stream (models/vocoder_stream) over its new final tokens at
  every harvest, the steps launched before the codes are copied to the
  host; its segments concatenate to its audio within the stream
  contract (int16 +-1 LSB).

- ``pipeline_depth=2`` dispatches chunk k+1 before it harvests chunk k,
  so the harvest's host work (status read, stream segments, vocoding)
  overlaps the steps of chunk k+1 still queued on the device: at most
  DONE_CHECK_STRIDE, since the loop's host reads ``done`` that often.
  A slot that finished in chunk k is freed a chunk later than at depth
  1 (PERF.md has the H100's trade). Results equal depth 1's: a
  request's codes depend only on its seed.

- ``mesh`` (parallel/mesh.py): a dp x tp mesh, one rank a device. Every
  rank runs this scheduler in lockstep, with identical submissions in
  identical order and ``step()`` called the same number of times (the
  JAX batcher's multi-process contract), so every scheduling decision is
  the same everywhere. Dp group g holds only its contiguous slot block
  (multihost.host_slot_range): those slots' state, KV rows and, paged,
  its own sub-pool (local page 0 reserved); its tp ranks hold weight
  shards and kv-head shards. Once a chunk one all-gather over dp of the
  host status (done, n_codes, pos) gives every rank the whole batch's
  status. Only tp rank 0 of the owning group vocodes a slot, streams its
  segments and resolves its Future with (codes, audio); every other
  rank resolves it with the remote marker (None, None). The prefix LRU
  of a rank sees only its group's admissions. The daemon serves such a
  mesh through a rank-0 front end that broadcasts the submissions
  (serve/lockstep.py).
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
import traceback
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from qwen3_tts_tpu_torch.config import TTSConfig
from qwen3_tts_tpu_torch.engine import generate as gen
from qwen3_tts_tpu_torch.engine.engine import vocode
from qwen3_tts_tpu_torch.models import talker as tk
from qwen3_tts_tpu_torch.models import transformer as tfm
from qwen3_tts_tpu_torch.models import vocoder as voc
from qwen3_tts_tpu_torch.models import vocoder_stream as vstream
from qwen3_tts_tpu_torch.models.code_predictor import CodePredictor
from qwen3_tts_tpu_torch.ops import quant
from qwen3_tts_tpu_torch.ops import sampling as smp
from qwen3_tts_tpu_torch.ops.kernels import cp_decode as k_cp
from qwen3_tts_tpu_torch.ops.kernels import decode_attention as k_attn
from qwen3_tts_tpu_torch.ops.kernels import paged_attention as k_paged
from qwen3_tts_tpu_torch.ops.kernels import qmatmul as k_qmm
from qwen3_tts_tpu_torch.ops.kernels import talker_step as k_step
from qwen3_tts_tpu_torch.parallel import mesh as pmesh
from qwen3_tts_tpu_torch.parallel import multihost as mh
from qwen3_tts_tpu_torch.utils import profiling

# the kernels whose own ``.launches`` counters occupancy() reports
_KERNELS = {"K1": k_qmm.qmatmul, "K2": k_cp.cp_decode_steps,
            "K3": k_step.talker_decode_step_fused,
            "K4": k_paged.paged_decode_attention,
            "K5": k_attn.decode_attention}


def _counters() -> Dict[str, int]:
    """The process's cumulative counters: the recorder's (those the
    batchers count), each kernel's launches and the ring's dropped
    entries."""
    rec = profiling.snapshot()
    out = rec["counters"]
    out.update({f"launches_{k}": fn.launches for k, fn in _KERNELS.items()})
    out["spans_dropped"] = rec["dropped"]
    return out


class OverloadedError(RuntimeError):
    """submit() refused a request because the waiting pool is at
    ``max_queue``. Raised synchronously, so callers can shed load."""


class _Request:
    def __init__(self, text_ids: np.ndarray, n_text: int, seed: int,
                 max_tokens: Optional[int] = None, priority: int = 0,
                 order: int = 0, on_chunk=None, ref_codes=None,
                 n_target: Optional[int] = None):
        self.text_ids = text_ids
        self.n_text = int(n_text)
        self.seed = seed
        self.max_tokens = max_tokens
        # voice cloning: the reference frames (R, 16), the target text's
        # token count (EOS pacing), and (padded frames, n_ref) once the
        # admission has bucketed them
        self.ref_codes = ref_codes
        self.n_target = n_target
        self.cloned_prep: Optional[tuple] = None
        # streaming: called on the scheduler thread with each new int16
        # segment; it must queue the segment and return
        self.on_chunk = on_chunk
        # the incremental vocoder stream (its state, frames fed, samples
        # emitted) and the segments taken from it
        self.stream = vstream.Stream()
        self.audio_parts: List[np.ndarray] = []
        # a failed segment leaves a hole: no later segment is emitted and
        # the Future raises this
        self.stream_error: Optional[BaseException] = None
        # admission order among waiting requests: highest priority first,
        # FIFO (submit order) within a priority
        self.priority = priority
        self.order = order
        # set by the submitter to withdraw the request: skipped while
        # queued, freed at the next chunk boundary once admitted
        self.cancelled = False
        self.future: Future = Future()
        # latency (perf_counter s): queue wait t_admit - t_submit; first
        # token t_first (observed at chunk granularity); first segment
        # handed to on_chunk t_first_audio; audio t_done
        self.t_submit_ns = time.perf_counter_ns()
        self.t_submit = self.t_submit_ns / 1e9
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_first_audio: Optional[float] = None
        self.t_done: Optional[float] = None

    def finish(self, result=None, exc=None) -> None:
        """Stamp t_done, record the span ``request`` and resolve the
        Future."""
        end = time.perf_counter_ns()
        self.t_done = end / 1e9
        if exc is None:
            self.future.set_result(result)
        else:
            self.future.set_exception(exc)
        profiling.record("request", self.t_submit_ns, end, self.order,
                         outcome="ok" if exc is None else "error")


def _empty_state(cfg: TTSConfig, batch: int, dtype, device,
                 paged_kv: Optional[tfm.PagedKV] = None,
                 mesh=None) -> gen.GenState:
    geo = tfm.geometry_of(cfg.talker, mesh)
    i32 = dict(dtype=torch.int32, device=device)
    kv = paged_kv if paged_kv is not None else tfm.init_kv_cache(
        geo, batch, cfg.talker.max_seq_len, dtype=dtype, device=device)
    return gen.GenState(
        kv=kv,
        pos=torch.zeros((batch,), **i32),
        hidden=torch.zeros((batch, cfg.talker.hidden_size), dtype=dtype,
                           device=device),
        ring=torch.full((batch, cfg.sampling.repetition_window), -1, **i32),
        n_codes=torch.zeros((batch,), **i32),
        done=torch.ones((batch,), dtype=torch.bool, device=device),
        codes=torch.zeros((batch, cfg.max_tokens, 16), **i32),
        n_text=torch.zeros((batch,), **i32),
        budget=torch.full((batch,), cfg.max_tokens, **i32),
        key=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


def _insert_rows(state: gen.GenState, slot: int, sub: gen.GenState) -> None:
    """Write a batch-1 state's per-row fields into ``slot`` (in place);
    the request's key comes along, so its draws are its own."""
    state.pos[slot] = sub.pos[0]
    state.hidden[slot] = sub.hidden[0].to(state.hidden.dtype)
    state.ring[slot] = sub.ring[0]
    state.n_codes[slot] = 0
    state.done[slot] = False
    state.codes[slot] = 0
    state.n_text[slot] = sub.n_text[0]
    state.key[slot] = sub.key[0]
    state.budget[slot] = sub.budget[0]


def _insert_slot(state: gen.GenState, slot: int, sub: gen.GenState) -> None:
    """Splice a batch-1 post-prefill state into ``slot`` of the dense
    batch (in place)."""
    state.kv[:, :, slot] = sub.kv[:, :, 0].to(state.kv.dtype)
    _insert_rows(state, slot, sub)


def _insert_slot_paged(state: gen.GenState, slot: int, sub: gen.GenState,
                       table_row: torch.Tensor, capacity: int, *,
                       n_rows: int) -> None:
    """Paged _insert_slot: install the slot's page-table row and
    capacity, then write the first ``n_rows`` dense prefill rows into its
    pages (in place)."""
    state.kv.table[slot] = table_row
    state.kv.capacity[slot] = capacity
    tfm.paged_scatter_rows(state.kv, slot, sub.kv[:, :, 0, :n_rows])
    _insert_rows(state, slot, sub)


class ContinuousBatcher:
    """Fixed-slot continuous-batching scheduler over the decode loop, on
    one device (``device``, the card unless the caller passes "cpu") or
    on the rank's ``mesh.device`` of a dp x tp mesh (the module
    docstring's lockstep contract).

    ``params``: the port's weights (io/weights.py), talker, code
    predictor and vocoder. ``dtype``: the talker's working type (weights,
    KV, hidden). ``quantize_talker`` keeps the talker int8 (fused layout;
    K3 up to 8 rows, the per-layer step on K1 past that); otherwise an
    int8 talker is dequantized to ``dtype``; on a mesh the talker is
    always dense (the fused int8 layout has no sharding specs) and
    ``quantize_talker`` is ignored, as in the JAX batcher. A dp-only rank
    holds the whole code predictor (K2 up to 8 rows); under tp its int8
    products run on K1 over the shards. ``quantize_cp`` (default on)
    makes the code predictor int8. ``prefix_cache``: capacity of the
    admission prefix LRU (0 disables). ``max_queue``: bound on waiting
    requests, past which submit() raises OverloadedError."""

    def __init__(self, cfg: TTSConfig, params: Dict, batch_size: int = 4,
                 decode_chunk: int = 16, dtype=torch.bfloat16, mesh=None,
                 quantize_talker: bool = False, quantize_cp: bool = True,
                 paged: bool = False, page_size: int = 64,
                 pool_pages: Optional[int] = None,
                 max_pages_per_slot: Optional[int] = None,
                 pipeline_depth: int = 1, prefix_cache: int = 8,
                 max_queue: Optional[int] = None, device="cuda"):
        if pipeline_depth not in (1, 2):
            raise ValueError(f"pipeline_depth must be 1 or 2, "
                             f"got {pipeline_depth}")
        self.mesh = mesh
        self._n_groups = 1 if mesh is None else mesh.shape[pmesh.DP]
        if batch_size % self._n_groups:
            raise ValueError(f"batch_size {batch_size} not divisible by dp "
                             f"{self._n_groups}")
        # this rank's dp group holds slots [lo, hi); its tp rank 0 serves
        # their results
        self._lo, self._hi = ((0, batch_size) if mesh is None else
                              mh.host_slot_range(mesh, batch_size))
        self._serves = mesh is None or mesh.tp_index == 0
        if mesh is not None:
            device = mesh.device
        self.cfg = cfg
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.decode_chunk = decode_chunk
        self.dtype = dtype
        self.pipeline_depth = pipeline_depth

        with profiling.span("setup"):
            self._load_weights(params, quantize_talker, quantize_cp)
            with profiling.span("kv_init"):
                self._init_kv(paged, page_size, pool_pages,
                              max_pages_per_slot)
        self._slot_req: List[Optional[_Request]] = [None] * batch_size
        # (done, pos) host mirrors left by the harvest's status read: the
        # next step's admission uses them instead of a second device read
        self._status_mirror: Optional[tuple] = None
        # pipeline_depth=2: (state, status snapshot, chunk id) of the
        # chunk dispatched last step, harvested one step late
        self._pending: Optional[tuple] = None
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._waiting: List[_Request] = []   # scheduler-thread-only
        self._backlog: List[_Request] = []   # paged: waiting for pages
        self.max_queue = max_queue
        self._order = 0
        self._stop = threading.Event()
        self._draining = False
        self._closed = False
        self._submit_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.prefix_cache_size = prefix_cache
        self._prefix_lru: "OrderedDict[tuple, tuple]" = OrderedDict()
        # each slot's n_codes at the last harvested status (0 from its
        # admission): a chunk commits the rise over it
        self._harvested_n = np.zeros((batch_size,), np.int64)
        self._cid = 0      # chunks dispatched
        self._counters0 = _counters()   # occupancy() counts from here

    def _load_weights(self, params: Dict, quantize_talker: bool,
                      quantize_cp: bool) -> None:
        """The talker in ``dtype`` (int8 or dequantized as asked), the
        code predictor, the vocoder, sharded on a mesh and on the device;
        recorded as the spans ``cast``, ``quantize`` and ``to_device``."""
        cfg, mesh, dtype = self.cfg, self.mesh, self.dtype
        with profiling.span("cast"):
            talker = _cast(params["talker"], dtype)
        with profiling.span("quantize"):
            if quantize_talker and mesh is None:
                if "qkv_proj" not in talker["layers"]:
                    talker = quant.quantize_talker(talker)
            elif any(isinstance(v, quant.QTensor)
                     for v in talker["layers"].values()):
                talker = quant.dequantize_talker(talker, dtype)
            cpp = params["code_predictor"]
            if quantize_cp and not isinstance(cpp["lm_heads"],
                                              quant.QTensor):
                cpp = quant.quantize_code_predictor(cpp)
        with profiling.span("to_device"):
            if mesh is not None:
                local = pmesh.shard_params(
                    mesh, {"talker": talker, "code_predictor": cpp})
                talker, cpp = local["talker"], local["code_predictor"]
            self._tp = tk.Talker(cfg.talker, talker).to(
                self.device).weights()
            self._cpp = CodePredictor(cfg.code_predictor,
                                      cpp).to(self.device).weights()
            self._vp = voc.Vocoder(cfg.vocoder, params["vocoder"]).to(
                self.device).weights()
        self._stepper = vstream.StreamStepper(cfg.vocoder)

    def _init_kv(self, paged: bool, page_size: int,
                 pool_pages: Optional[int],
                 max_pages_per_slot: Optional[int]) -> None:
        """The batch's empty decode state: a dense KV cache, or the paged
        pool with its page table and free lists."""
        cfg, mesh, dtype = self.cfg, self.mesh, self.dtype
        self.paged = paged
        paged_kv = None
        local_b = self._hi - self._lo
        if paged:
            geo = tfm.geometry_of(cfg.talker, mesh)
            self.page_size = page_size
            # default pool: every slot can reach max_tokens after a
            # max-size prefix, plus the reserved page 0 of each dp group's
            # sub-pool. A slot only holds pages of its group's sub-pool,
            # and the table holds the sub-pool's local page ids.
            worst = cfg.max_tokens + 256 + tk.PREFIX_EXTRA + page_size
            per_slot = -(-worst // page_size)
            self.max_pages_per_slot = max_pages_per_slot or per_slot
            per_group = (-(-pool_pages // self._n_groups) if pool_pages
                         else local_b * per_slot + 1)
            self._pages_per_group = per_group
            self.pool_pages = per_group * self._n_groups
            paged_kv = tfm.init_paged_kv(
                geo, local_b, per_group, page_size,
                self.max_pages_per_slot, dtype=dtype, device=self.device)
            self._free_by_group: List[List[int]] = [
                list(range(1, per_group)) for _ in range(self._n_groups)]
            self._slot_pages: List[List[int]] = [[] for _ in
                                                 range(self.batch_size)]
        with torch.inference_mode():
            self._state = _empty_state(cfg, local_b, dtype, self.device,
                                       paged_kv, mesh)

    # -- public API ---------------------------------------------------------

    def submit(self, text_ids: np.ndarray, n_text: int, seed: int = 0,
               max_tokens: Optional[int] = None, on_chunk=None,
               ref_codes=None, n_target: Optional[int] = None,
               priority: int = 0) -> Future:
        """Queue a request; the Future resolves to (codes (T, 16) int32,
        audio int16 (T * 1920,)). ``max_tokens`` caps this request; a
        higher ``priority`` admits first (FIFO within a priority). Raises
        OverloadedError when ``max_queue`` waiting requests are queued.

        ``on_chunk``: streaming. Called FROM THE SCHEDULER THREAD (it must
        queue and return, never block) with each new int16 segment once
        its tokens are final: the first after ``stream_head_tokens``, then
        at least ``stream_emit_tokens`` new tokens a segment, the last
        when the request finishes. The segments come from the incremental
        vocoder stream and concatenate to the Future's audio, which equals
        the non-streaming audio within +-1 LSB. If a segment fails (its
        step or its fetch, or on_chunk raising), no later segment is
        emitted and the Future raises that error.

        ``ref_codes`` and ``n_target``: voice cloning. ``text_ids`` then
        hold the reference transcript followed by the target text (the
        engine's ``_encode_cloned``), ``ref_codes`` the (R, 16) reference
        codec frames of a prompt dir, ``n_target`` the target text's
        token count, on which EOS is paced."""
        if (ref_codes is None) != (n_target is None):
            raise ValueError("ref_codes and n_target go together")
        with self._submit_lock:
            if self.max_queue is not None:
                depth = (self._queue.qsize() + len(self._waiting)
                         + len(self._backlog))
                if depth >= self.max_queue:
                    raise OverloadedError(
                        f"server overloaded: {depth} requests waiting "
                        f"(max_queue={self.max_queue}); retry later")
            self._order += 1
            req = _Request(np.asarray(text_ids, np.int32), n_text, seed,
                           max_tokens, int(priority), self._order,
                           on_chunk,
                           ref_codes=(None if ref_codes is None else
                                      np.asarray(ref_codes, np.int32)),
                           n_target=n_target)
            req.future.request = req   # exposes the timings
            if self._closed:
                req.future.set_exception(RuntimeError("batcher stopped"))
                return req.future
            self._queue.put(req)
        return req.future

    def occupancy(self) -> dict:
        """Scheduler snapshot (read without pausing the scheduler), with
        the counters of utils/profiling under ``counters``, counted since
        this batcher was built (by every batcher of the process, and
        every kernel launch, engine calls included): the batchers' own,
        each kernel's launches (``launches_K1``..``K5``) and the
        recorder's dropped entries (``spans_dropped``). A counter appears
        once it has counted."""
        now = _counters()
        counters = {k: v - self._counters0.get(k, 0) for k, v in now.items()}
        snap = {
            "batch_size": self.batch_size,
            "active_slots": sum(r is not None for r in self._slot_req),
            "queued": (self._queue.qsize() + len(self._waiting)
                       + len(self._backlog)),
            "paged": self.paged,
            "prefix_cache": {"entries": len(self._prefix_lru),
                             "capacity": self.prefix_cache_size,
                             "hits": counters.get("prefix_hits", 0),
                             "misses": counters.get("prefix_misses", 0)},
            "counters": counters,
        }
        if self.paged:
            snap["free_pages"] = len(self._free_pages)
        return snap

    def busy(self) -> bool:
        """Whether a step has work: a slot is held or a request waits
        (read on the thread that steps)."""
        return (any(r is not None for r in self._slot_req)
                or bool(self._waiting) or bool(self._backlog)
                or not self._queue.empty())

    @property
    def _free_pages(self) -> List[int]:
        return ([p for free in self._free_by_group for p in free]
                if self.paged else [])

    def _holds(self, slot: int) -> bool:
        """Whether this rank's dp group holds ``slot``'s state."""
        return self._lo <= slot < self._hi

    def _serves_slot(self, slot: int) -> bool:
        """Whether this rank vocodes, streams and resolves ``slot``."""
        return self._serves and self._holds(slot)

    def _slot_group(self, slot: int) -> int:
        return slot // (self.batch_size // self._n_groups)

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            if self._closed:
                raise RuntimeError(
                    "batcher scheduler thread from a previous stop() is "
                    "still alive; cannot restart")
            return
        self._closed = False
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @torch.inference_mode()
    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the scheduler. ``drain=True`` admits nothing new but lets
        in-flight slots finish (bounded by ``timeout``); whatever is still
        unfinished then, queued or mid-decode, fails with RuntimeError.
        A cleanly stopped batcher can start() again."""
        if drain and self._thread is not None and self._thread.is_alive():
            self._draining = True
            deadline = time.monotonic() + timeout
            while (any(r is not None for r in self._slot_req)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        self._stop.set()
        joined = True
        if self._thread is not None:
            self._thread.join(timeout=max(timeout, 10.0))
            joined = not self._thread.is_alive()
        with self._submit_lock:
            self._closed = True
            leftovers = self._drain_queue()
        leftovers += self._waiting + self._backlog
        self._waiting, self._backlog = [], []
        if not joined:
            # the thread still owns the slots and the device state
            _fail(leftovers, RuntimeError("batcher stopped"))
            return
        inflight = [s for s in range(self.batch_size)
                    if self._slot_req[s] is not None]
        _fail(leftovers + [self._slot_req[s] for s in inflight],
              RuntimeError("batcher stopped"))
        self._status_mirror = None
        self._pending = None
        self._free_slots_on_device(inflight)
        self._draining = False
        self._stop.clear()
        self._thread = None
        with self._submit_lock:
            self._closed = False

    # -- scheduler ----------------------------------------------------------

    def _drain_queue(self) -> List[_Request]:
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    @staticmethod
    def _snapshot_status(state: gen.GenState) -> tuple:
        """(done, n_codes, pos) of ``state`` as they stand now in stream
        order, in one new device tensor whose copy to pinned host memory
        starts at once. On the card the copy is done when the chunk ends,
        so a depth-2 harvest does not wait for the steps of the next
        chunk queued behind it. Read it with _read_status."""
        st = torch.stack([state.done.to(torch.int32), state.n_codes,
                          state.pos])
        if st.device.type != "cuda":
            return st, None
        host = torch.empty(st.shape, dtype=st.dtype, pin_memory=True)
        host.copy_(st, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _read_status(self, snap: tuple) -> tuple:
        """(done, n_codes, pos) host arrays of a _snapshot_status, over
        the whole batch: on a mesh of dp groups the one collective of the
        scheduler, an all-gather over dp of the groups' host status."""
        host, ready = snap
        profiling.count("status_reads")
        with profiling.span("status_read"):
            if ready is not None:
                ready.synchronize()
            st = pmesh.dp_all_gather(host, self.mesh).numpy()
        return st[0].astype(bool), st[1].copy(), st[2].copy()

    def _fetch_status(self, state: gen.GenState) -> tuple:
        """(done, n_codes, pos) as host arrays, in one device read."""
        return self._read_status(self._snapshot_status(state))

    def _cloned_inputs(self, req: _Request, cap: int) -> tuple:
        """A cloning request's reference frames bucketed against ``cap``
        KV rows (dense: max_seq_len; paged: the slot's page capacity) with
        the engine's clamp (tk.cloned_ref_limit, tk.bucket_ref_frames).
        Returns (padded (b, 16), n_ref), kept on the request."""
        if req.cloned_prep is None:
            limit = tk.cloned_ref_limit(cap, len(req.text_ids))
            padded, n_ref = tk.bucket_ref_frames(limit, req.ref_codes)
            if n_ref < len(req.ref_codes):
                print(f"warning: reference audio truncated to {n_ref} "
                      f"frames (prefix budget {cap})", file=sys.stderr)
            req.cloned_prep = (padded, n_ref)
        return req.cloned_prep

    def _prefix_result(self, req: _Request, window: int) -> tuple:
        """(hidden, kv, plen) of a request's prefix: the dual-stream
        prefix (cloned when the request has reference frames) and a
        batch-1 talker prefill into a ``window``-row cache, through the
        LRU. Seed, budget and n_target are not part of it."""
        key = (req.text_ids.tobytes(), req.n_text, window)
        if req.cloned_prep is not None:
            padded, n_ref = req.cloned_prep
            key += (padded.tobytes(), n_ref)
        if self.prefix_cache_size > 0:
            hit = self._prefix_lru.get(key)
            if hit is not None:
                self._prefix_lru.move_to_end(key)
                profiling.count("prefix_hits")
                return hit
        prefix, plen = tk.request_prefix(self._tp, self._cpp["codec_embs"],
                                         req.text_ids, req.n_text,
                                         req.cloned_prep, self.mesh)
        pcfg = dataclasses.replace(self.cfg, talker=dataclasses.replace(
            self.cfg.talker, max_seq_len=window))
        hidden, kv = gen.prefill_state(self._tp, prefix[None], plen[None],
                                       pcfg, mesh=self.mesh)
        out = (hidden, kv, plen[None])
        profiling.count("prefix_misses")
        if self.prefix_cache_size > 0:
            self._prefix_lru[key] = out
            while len(self._prefix_lru) > self.prefix_cache_size:
                self._prefix_lru.popitem(last=False)
        return out

    def _sub_state(self, req: _Request, window: int) -> gen.GenState:
        """The request's batch-1 post-prefill state; a cloning request
        paces EOS on ``n_target``."""
        hidden, kv, plen = self._prefix_result(req, window)
        key = smp.batch_keys([req.seed], 1)
        n_pace = req.n_text if req.ref_codes is None else req.n_target
        return gen.assemble_state(
            hidden, kv, plen, torch.tensor([n_pace]), key, self.cfg,
            budget=self._req_budget(req))

    def _req_budget(self, req: _Request) -> int:
        if req.max_tokens is None:
            return self.cfg.max_tokens
        return min(int(req.max_tokens), self.cfg.max_tokens)

    def _next_request(self) -> Optional[_Request]:
        if self._draining:
            return None
        # a paged request waiting for pages keeps head-of-line
        if self._backlog:
            return self._backlog.pop(0)
        self._waiting += self._drain_queue()
        if not self._waiting:
            return None
        best = min(range(len(self._waiting)),
                   key=lambda i: (-self._waiting[i].priority,
                                  self._waiting[i].order))
        return self._waiting.pop(best)

    def _free_slots_on_device(self, slots: List[int]) -> None:
        """Mark ``slots`` done on the device, zero their page tables and
        only then return their pages: a frozen slot keeps rewriting K/V
        at its last position, which must land in reserved page 0 and not
        in a page handed to another slot."""
        for s in slots:
            if self._holds(s):
                self._state.done[s - self._lo] = True
            self._slot_req[s] = None
            if self.paged:
                self._release(s)

    def _release(self, slot: int) -> None:
        if self._holds(slot):
            self._state.kv.table[slot - self._lo] = 0
            self._state.kv.capacity[slot - self._lo] = 0
        self._free_by_group[self._slot_group(slot)].extend(
            self._slot_pages[slot])
        self._slot_pages[slot] = []

    def _evict_cancelled(self, done: np.ndarray) -> frozenset:
        """Free admitted slots whose request was withdrawn, and flip the
        host mirror so this step's admission can reuse them. Returns the
        slots (a depth-2 harvest skips them: its status predates the
        eviction)."""
        victims = [s for s in range(self.batch_size)
                   if self._slot_req[s] is not None
                   and self._slot_req[s].cancelled and not done[s]]
        _fail([self._slot_req[s] for s in victims],
              RuntimeError("request cancelled"), "cancelled")
        self._free_slots_on_device(victims)
        done[victims] = True
        return frozenset(victims)

    def _admit(self, done: np.ndarray, pos: np.ndarray) -> List[int]:
        """Admit queued requests into free slots; updates the host
        mirrors ``done``/``pos`` in place (both are known on the host), so
        the page top-up needs no device read. Returns the slots. Each
        admission is the span ``admit`` (its end is ``t_admit``), the wait
        before it the span ``queue``; an attempt that returns a paged
        request to the backlog is an ``admit`` span with outcome
        ``backlog``, inside the queue wait."""
        admitted: List[int] = []
        free = [s for s in range(self.batch_size)
                if done[s] and self._slot_req[s] is None]
        for slot in free:
            req = None
            while True:
                req = self._next_request()
                if req is None:
                    break
                if req.cancelled:
                    _fail([req], RuntimeError("request cancelled"),
                          "cancelled")
                    continue
                # a malformed request fails its own Future, on every rank
                # alike (the checks read only the host request); the slot
                # moves on to the next request
                with profiling.span("admit", req.order) as sp:
                    try:
                        placed = self._admit_one(slot, req)
                    except Exception as e:
                        sp.set(outcome="error")
                        _fail([req], e)
                        continue
                    sp.set(outcome="ok" if placed else "backlog")
                if not placed:
                    self._backlog.append(req)   # pool pressure
                    profiling.count("backlog_retries")
                    req = None
                break
            if req is None:
                break
            self._slot_req[slot] = req
            req.t_admit = sp.end / 1e9
            profiling.record("queue", req.t_submit_ns, sp.start, req.order)
            profiling.count("admissions")
            self._harvested_n[slot] = 0
            done[slot] = False
            # the prefill's prefix_len, reference frames included
            n_ref = req.cloned_prep[1] if req.cloned_prep else 0
            pos[slot] = req.n_text + tk.PREFIX_EXTRA + n_ref
            admitted.append(slot)
        return admitted

    def _admit_one(self, slot: int, req: _Request) -> bool:
        """Check ``req`` and place it in ``slot``: its prefill spliced in
        (on the rank that holds the slot). False when the paged pool
        cannot cover its prefix yet; raises for a malformed request."""
        vocab = self.cfg.talker.text_vocab_size
        if ((req.text_ids < 0) | (req.text_ids >= vocab)).any():
            raise ValueError(f"text ids out of the vocabulary [0, {vocab})")
        if self.paged:
            return self._admit_paged(slot, req)
        S = self.cfg.talker.max_seq_len
        p_pad = len(req.text_ids) + tk.PREFIX_EXTRA
        if req.ref_codes is not None:
            # after bucketing: even a reference cut to nothing pads to one
            # row
            p_pad += len(self._cloned_inputs(req, S)[0])
        if p_pad > S:
            raise ValueError(
                f"request prefix ({p_pad} rows incl. {tk.PREFIX_EXTRA} "
                f"special) exceeds the dense KV allocation (max_seq_len="
                f"{S}); shorten the text or use the paged batcher")
        if self._holds(slot):
            _insert_slot(self._state, slot - self._lo,
                         self._sub_state(req, S))
        return True

    def _admit_paged(self, slot: int, req: _Request) -> bool:
        """Allocate pages for the prefix plus one chunk of headroom,
        prefill into a page-aligned dense window, splice it into the
        slot. False when the pool cannot cover the prefix yet; raises
        when it never can."""
        psz = self.page_size
        p_pad = len(req.text_ids) + tk.PREFIX_EXTRA
        if req.ref_codes is not None:
            p_pad += len(self._cloned_inputs(
                req, self.max_pages_per_slot * psz)[0])
        if p_pad > self.max_pages_per_slot * psz:
            raise ValueError(
                f"request prefix ({p_pad} rows incl. {tk.PREFIX_EXTRA} "
                f"special) exceeds a slot's page capacity "
                f"({self.max_pages_per_slot} pages x {psz}); shorten the "
                f"text or raise max_pages_per_slot/page_size")
        need = min(-(-(p_pad + self.decode_chunk + 2) // psz),
                   self.max_pages_per_slot)
        usable = self._pages_per_group - 1
        if need > usable:
            raise ValueError(
                f"request prefix needs {need} pages but the pool has only "
                f"{usable} usable pages per dp group (pool_pages="
                f"{self.pool_pages}, page_size={psz}); raise pool_pages "
                f"or shorten the text")
        free = self._free_by_group[self._slot_group(slot)]
        if len(free) < need:
            return False
        s_pre = -(-p_pad // psz) * psz
        sub = self._sub_state(req, s_pre) if self._holds(slot) else None
        pages = [free.pop() for _ in range(need)]
        if sub is not None:
            table_row = torch.zeros((self.max_pages_per_slot,),
                                    dtype=torch.int32)
            table_row[:need] = torch.tensor(pages, dtype=torch.int32)
            try:
                _insert_slot_paged(self._state, slot - self._lo, sub,
                                   table_row.to(self.device), need * psz,
                                   n_rows=s_pre)
            except BaseException:
                free.extend(pages)
                raise
        self._slot_pages[slot] = pages
        return True

    def _top_up_pages(self, pos: np.ndarray, done: np.ndarray) -> None:
        """Grow page tables so that no active slot reaches its capacity
        inside the coming chunk; pages are allocated between chunks,
        never inside the loop. A slot at its page limit, or with the pool
        empty, finishes at its capacity."""
        psz = self.page_size
        while True:
            grows = []     # (slot, table index, page): one per slot
            for slot in range(self.batch_size):
                pages = self._slot_pages[slot]
                if self._slot_req[slot] is None or done[slot]:
                    continue
                if (len(pages) * psz - int(pos[slot])
                        >= self.pipeline_depth * self.decode_chunk + 2):
                    continue
                free = self._free_by_group[self._slot_group(slot)]
                if len(pages) >= self.max_pages_per_slot or not free:
                    continue
                page = free.pop()
                grows.append((slot, len(pages), page))
                pages.append(page)
            if not grows:
                return
            mine = [(s - self._lo, i, p) for s, i, p in grows
                    if self._holds(s)]
            if not mine:
                continue
            s, i, p = (torch.tensor(c, device=self.device)
                       for c in zip(*mine))
            kv = self._state.kv
            kv.table[s, i] = p.to(torch.int32)
            kv.capacity[s] += psz

    # minimum new tokens a streaming emission while the slot is live (the
    # last emission always flushes); the first emission waits only for
    # the head
    stream_emit_tokens = 48
    stream_head_tokens = 8

    def _dispatch_stream_windows(self, state: gen.GenState,
                                 done: np.ndarray, n_codes: np.ndarray,
                                 skip=frozenset()) -> list:
        """Launch each streaming slot's stream steps over its new final
        tokens (StreamStepper.advance): a live slot once min-emit tokens
        are new, its sub-quantum rest waiting for more; a finished slot
        through its end and the zero-code frame that flushes the stream's
        lag. The steps read the device codes row. Slots in ``skip``, and
        those this rank does not serve, are left out. Returns (request,
        segment, n_codes) jobs, not yet fetched."""
        jobs = []
        for slot in range(self.batch_size):
            req = self._slot_req[slot]
            if (req is None or req.on_chunk is None
                    or req.stream_error is not None or slot in skip
                    or not self._serves_slot(slot)):
                continue
            n = int(n_codes[slot])
            if not done[slot]:
                min_emit = (self.stream_head_tokens if req.stream.frames == 0
                            else self.stream_emit_tokens)
                if n - req.stream.frames < min_emit:
                    continue
            try:
                segs = self._stepper.advance(self._vp,
                                             state.codes[slot - self._lo],
                                             req.stream, n, bool(done[slot]))
            except Exception as e:
                req.stream_error = e
                continue
            jobs += [(req, seg, n) for seg in segs]
        return jobs

    def _harvest(self, state: gen.GenState, status: tuple, cid: int = 0,
                 skip=frozenset(), local_status=None) -> int:
        """Read a chunk's status snapshot (kept as the next step's
        mirrors), emit the streaming segments and resolve the finished
        slots. Stream steps are launched before the codes are copied to
        the host.

        At depth 1 ``state`` is the chunk just run. At depth 2 it is the
        chunk before, and the chunk after it is already queued. The two
        share the buffers that the loop writes in place (the codes, the
        KV, the page table); a row's codes below this chunk's n_codes are
        final, so they read the same whichever chunk wrote last.
        ``skip``: the slots admitted or evicted after this chunk was
        dispatched (their done/pos/n_codes were written in place into
        ``state``, and its status describes the slot's previous
        occupant); they keep their mirrors from ``local_status``, the
        admission's (done, pos).

        Recorded as the span ``harvest`` of chunk ``cid``, with the codes
        the chunk committed (each held slot's rise in n_codes since the
        last harvest), and its children ``status_read``, ``stream``,
        ``codes_read``, ``segment_read`` and ``vocode``; a request's first
        segment is the mark ``first_audio`` (``t_first_audio``)."""
        with profiling.span("harvest", cid=cid) as hv:
            done, n_codes, pos = self._read_status(status)
            m_done, m_pos = done.copy(), pos.copy()
            for s in skip:
                m_done[s], m_pos[s] = local_status[0][s], local_status[1][s]
            self._status_mirror = (m_done, m_pos)
            now = time.perf_counter()
            streaming = False
            committed = 0
            for s, r in enumerate(self._slot_req):
                if r is None or s in skip:
                    continue
                committed += int(n_codes[s]) - int(self._harvested_n[s])
                self._harvested_n[s] = n_codes[s]
                if r.t_first is None and n_codes[s] > 0:
                    r.t_first = now
                if r.on_chunk is not None and n_codes[s] > 0:
                    streaming = True
            hv.set(codes=committed)
            profiling.count("codes_committed", committed)
            finished = [s for s in range(self.batch_size)
                        if self._slot_req[s] is not None and done[s]
                        and s not in skip]
            if not finished and not streaming:
                return 0
            with profiling.span("stream"):
                jobs = self._dispatch_stream_windows(state, done, n_codes,
                                                     skip)
            # a copy: on the CPU .numpy() would share the buffer that the
            # slot's next request overwrites
            codes_all = None
            if any(self._serves_slot(s) for s in finished):
                with profiling.span("codes_read"):
                    codes_all = state.codes.cpu().numpy().copy()
            for req, seg, n in jobs:
                if req.stream_error is not None:
                    continue
                try:
                    with profiling.span("segment_read", req.order):
                        part = seg.take(n)
                    if len(part):
                        req.audio_parts.append(part)
                        profiling.count("segments")
                        if req.t_first_audio is None:
                            req.t_first_audio = profiling.mark(
                                "first_audio", req.order, cid=cid) / 1e9
                        req.on_chunk(part)
                except Exception as e:
                    req.stream_error = e
            for slot in finished:
                req = self._slot_req[slot]
                try:
                    if not self._serves_slot(slot):
                        # the owning group's tp rank 0 serves it: here the
                        # request resolves to the remote marker
                        result = (None, None)
                    else:
                        codes = codes_all[slot - self._lo,
                                          :int(n_codes[slot])]
                        if req.on_chunk is None:
                            with profiling.span("vocode", req.order):
                                audio = vocode(self._vp, codes,
                                               self.cfg.vocoder, self.device)
                        elif req.stream_error is not None:
                            raise req.stream_error
                        else:
                            audio = (np.concatenate(req.audio_parts)
                                     if req.audio_parts
                                     else np.zeros((0,), np.int16))
                        result = (codes, audio)
                    req.finish(result)
                except Exception as e:
                    req.finish(exc=e)
                self._slot_req[slot] = None
                if self.paged:
                    # at depth 2 the chunk queued after this one still
                    # writes this frozen slot's K/V at its last position
                    # through the old table row. The zeroing below is
                    # queued after that chunk, and the pages go to another
                    # slot only at a later admission, whose writes are
                    # queued later still: stream order keeps the stale
                    # write out of the pages' next owner.
                    self._release(slot)
            return len(finished)

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler iteration: evict cancelled slots, admit, grow
        pages, run one chunk, harvest. One blocking device read per chunk
        (the harvest's status, whose (done, pos) the next admission
        reuses). At pipeline_depth=2 the harvest is of the chunk before
        this one, which runs after this chunk is dispatched; it skips
        this step's admissions and evictions. Returns True if a chunk
        ran.

        Recorded as the span ``step`` with the children ``evict``,
        ``admissions``, ``top_up``, ``dispatch`` (the host enqueue of
        chunk ``cid``: its loop steps, rows, ``done`` reads and the steps
        whose code predictor prelude replayed a CUDA graph, ``cp_graph``)
        and ``harvest``; an idle step (nothing held, queued or pending)
        returns at once and records nothing."""
        if (self._status_mirror is not None and self._pending is None
                and not self.busy()):
            return False
        with profiling.span("step"):
            if self._status_mirror is not None:
                done, pos = self._status_mirror
                self._status_mirror = None
            else:
                done, _, pos = self._fetch_status(self._state)
            with profiling.span("evict"):
                cancelled = self._evict_cancelled(done)
            with profiling.span("admissions"):
                admitted = self._admit(done, pos)
            if not any(r is not None for r in self._slot_req):
                # idle: nothing ran, so the mirrors still hold; a pending
                # chunk only advanced frozen rows
                self._pending = None
                self._status_mirror = (done, pos)
                return False
            if self.paged:
                with profiling.span("top_up"):
                    self._top_up_pages(pos, done)
            self._cid += 1
            cid = self._cid
            with profiling.span("dispatch", cid=cid) as sp:
                run = {}
                self._state = gen.run_steps(self._tp, self._cpp, self._state,
                                            self.cfg, self.decode_chunk,
                                            self.mesh, stats=run)
                chunk = (self._state, self._snapshot_status(self._state), cid)
                sp.set(steps=run["steps"], rows=self.batch_size,
                       done_reads=run["done_reads"],
                       cp_graph=run["graph_steps"])
            profiling.count("chunks")
            profiling.count("loop_steps", run["steps"])
            profiling.count("cp_graph_steps", run["graph_steps"])
            profiling.count("row_steps", run["steps"] * self.batch_size)
            profiling.count("done_reads", run["done_reads"])
            if self.pipeline_depth == 1:
                self._harvest(*chunk)
            else:
                prev, self._pending = self._pending, chunk
                if prev is not None:
                    self._harvest(*prev,
                                  skip=frozenset(admitted) | cancelled,
                                  local_status=(done, pos))
            return True

    def _loop(self) -> None:
        # inference_mode is thread-local: the scheduler thread enters it.
        # A failing step fails the in-flight slots and goes on; after 3
        # failures in a row the fault is taken as persistent: everything
        # fails and the thread halts.
        consecutive = 0
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    worked = self.step()
                    consecutive = 0
                except Exception as e:
                    traceback.print_exc()
                    consecutive += 1
                    if consecutive >= 3:
                        with self._submit_lock:
                            self._closed = True
                        self._stop.set()
                        self._abort_inflight(e, drain_queue=True)
                        print("batcher: 3 consecutive scheduler failures; "
                              "halting", file=sys.stderr)
                        return
                    self._abort_inflight(e, drain_queue=False)
                    time.sleep(0.05)
                    continue
                if not worked:
                    time.sleep(0.002)

    def _abort_inflight(self, exc: Exception, drain_queue: bool) -> None:
        """After a failed step: fail the in-flight requests and free
        their slots (and pages); queued requests survive unless
        ``drain_queue``."""
        self._status_mirror = None
        self._pending = None
        inflight = [s for s in range(self.batch_size)
                    if self._slot_req[s] is not None]
        _fail([self._slot_req[s] for s in inflight], exc)
        try:
            self._free_slots_on_device(inflight)
        except Exception:
            # the device is gone: leak the pages rather than hand out
            # pages a stale table may still point at
            for s in inflight:
                self._slot_req[s] = None
                if self.paged:
                    self._slot_pages[s] = []
        if drain_queue:
            leftovers = self._waiting + self._backlog + self._drain_queue()
            self._waiting, self._backlog = [], []
            _fail(leftovers, exc)


def _fail(reqs, exc: BaseException, outcome: str = "error") -> None:
    """Fail the requests not yet resolved, each recorded as the span
    ``request`` with ``outcome`` (t_done stays None: no audio came)."""
    for r in reqs:
        if not r.future.done():
            r.future.set_exception(exc)
            profiling.record("request", r.t_submit_ns,
                             time.perf_counter_ns(), r.order,
                             outcome=outcome)


def _cast(tree: dict, dtype) -> dict:
    """Float weights to ``dtype`` (int8 weights and their scales stay)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _cast(v, dtype)
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            out[k] = v.to(dtype)
        elif k != "layers_list":
            out[k] = v
    return out

