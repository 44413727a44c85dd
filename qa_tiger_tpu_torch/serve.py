"""Persistent batch-serving surface: ``python -m qa_tiger_tpu_torch.serve``.

Port of ``src/serve.py``: one model at a fixed batch shape behind an HTTP
queue. A batcher thread drains the request queue, pads each flush to
``--batch-size`` and DISPATCHES it without waiting: the forward, the fp32
softmax and a non-blocking copy of the [B, num_labels] probabilities into
pinned host memory are queued on the card and an event is recorded after
them, so the batcher goes back to assembling the next batch while up to 3
batches are in flight; a completer thread waits on each batch's event in
FIFO order and fans the answers back out. Every question is 77 tokens and
every video T=60 frames, so a fixed shape loses nothing to padding but the
tail of a flush.

    python -m qa_tiger_tpu_torch.serve --config configs/qa-tiger/vitl14.py \\
        --weight best.npz --port 8765 --batch-size 256 --max-wait-ms 10

    POST /predict        {"question": "...", "video": "<vid>", "topk": 5}
    POST /predict_batch  {"items": [{"question", "video"}, ...], "topk": 1}
    GET  /health         readiness (warm-up finished; 500 if it failed)
    GET  /stats          served counts / batch fill / cached-batch count

All card work (warm-up, batches, device-cache inserts) runs on one CUDA
stream of the service's own, so an insert from a client thread is ordered
before every batch that reads it. The device is the one
``hyper_params.platform`` names (the card unless it says "cpu"), chosen
before the model is built or the socket bound; a kernel that fails to build
or launch fails the warm-up (``/health`` 500), with no fallback.

The BPE merges file comes from ``QA_TIGER_BPE_VOCAB`` (``data.tokenizer``).

Note on determinism: under the checkpoint-faithful default
``gather_mode="reference"`` the TempMoE batch-rotated gather
(``ops/tempmoe.py``) makes each row's output depend on its batch mates,
exactly as the reference's own batched eval does; a padded batch is padded
with its first row, as the JAX server pads it. Serving configs that need
batch-composition-independent answers set
``hyper_params.model.gather_mode='paper'``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from qa_tiger_tpu_torch.data.dataset import load_video_features
from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer
from qa_tiger_tpu_torch.models.qa_tiger import check_text_ctx
from qa_tiger_tpu_torch.models.registry import select_device
from qa_tiger_tpu_torch.predict import Predictor, answer_payload
from qa_tiger_tpu_torch.utils.config import load_config_module

ROOT = Path(__file__).resolve().parents[1]
# batches dispatched to the card and not yet materialised; the batcher
# stalls (backpressure) rather than piling work up
IN_FLIGHT = 3


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--weight", default="", help="best.npz or torch best.pt")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--batch-size", type=int, default=256,
                    help="fixed batch shape; requests are padded")
    ap.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="max time the batcher waits to fill a batch after "
                         "the first request arrives")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--device-cache", type=int, default=0,
                    help="keep up to N videos' features resident in device "
                         "memory; cached requests assemble their batch "
                         "on the card (only the 77 token ids cross the host "
                         "boundary)")
    return ap.parse_args(argv)


class FeatureStore:
    """Host-side cache over ``data.load_video_features`` (the one loading
    contract of the dataset, ``predict`` and this server)."""

    def __init__(self, cfg):
        self.cfg_data = cfg.data
        root = Path(cfg.data.root)
        if not root.is_absolute():
            root = ROOT / root
        self.dirs = {k: root / sub for k, sub in
                     (("audio", cfg.data.audio_feat),
                      ("video", cfg.data.video_feat),
                      ("patch", cfg.data.get("patch_feat"))) if sub}
        self._cache: dict = {}
        self._lock = threading.Lock()

    def get(self, video_id: str) -> dict:
        with self._lock:
            if video_id in self._cache:
                return self._cache[video_id]
        out = load_video_features(self.cfg_data, video_id, repo_root=ROOT)
        with self._lock:
            if len(self._cache) > 4096:  # bound host memory
                self._cache.clear()
            self._cache[video_id] = out
        return out


class Inflight:
    """A dispatched batch: its [B, num_labels] fp32 probabilities (on the
    card's machine a pinned host buffer that a queued copy fills), the event
    recorded after that copy, and the host tensors the batch's queued
    copies still read. ``np.asarray`` of it waits for the event: the one
    place the server waits for the card."""

    def __init__(self, probs: torch.Tensor, event=None, inputs=()):
        self.probs, self.event, self.inputs = probs, event, inputs

    def __array__(self, dtype=None, copy=None):
        if self.event is not None:
            self.event.synchronize()
        out = self.probs.numpy()
        return out if dtype is None else out.astype(dtype)


class Service:
    """Owns the model, the request queue, and the batcher and completer
    threads."""

    def __init__(self, args):
        start = time.perf_counter()
        cfg = load_config_module(args.config)
        if args.weight:
            cfg["weight"] = args.weight
        self.cfg = cfg
        self.device = select_device(cfg)  # no card: raise before any work
        self.batch_size = args.batch_size
        self.max_wait = args.max_wait_ms / 1e3
        self.dtype = getattr(torch, args.dtype)

        self.predictor = Predictor.from_config(cfg, self.device, self.dtype)
        self.model = self.predictor.model
        self.model_cfg = self.predictor.cfg
        self.ix2ans = self.predictor.ix2ans
        self.store = FeatureStore(cfg)
        self.tokenizer = ClipTokenizer()
        self._tok_cache: dict = {}
        self._tok_lock = threading.Lock()
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None

        # device-resident feature cache: the features of the first N videos
        # asked for stay on the card as [N, ...] buffers; a batch whose rows
        # all have a slot is gathered there by index, so per-request
        # host->card traffic is the 77 token ids, not ~MBs of features
        self.cache_cap = max(0, args.device_cache)
        self._dev_bufs: dict = {}
        self._dev_slots: dict = {}
        self._cache_lock = threading.Lock()

        self.queue: queue.Queue = queue.Queue()
        self.ready = threading.Event()
        self.failed: str | None = None
        self.stats = {"served": 0, "batches": 0, "rows": 0,
                      "cached_batches": 0}
        self.timings = {"init_s": time.perf_counter() - start}
        self._stop = threading.Event()
        self._inflight: queue.Queue = queue.Queue(maxsize=IN_FLIGHT)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._completer = threading.Thread(target=self._complete,
                                           daemon=True)
        self._thread.start()
        self._completer.start()

    # ------------------------------------------------------------------
    def _on_card(self):
        """The service's stream for the card work in this block."""
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _host(self, array) -> torch.Tensor:
        """A host tensor over ``array``, pinned where it feeds a copy to the
        card."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self._cuda else t

    def _example_rows(self):
        """One row for warm-up. Prefer a real feature file so the warm-up
        shape is exactly the serving shape; synthetic rows otherwise. The
        warm-up question skips the ``text_ctx`` check, as in the JAX
        server: the forward trims it."""
        tokens = self.tokenizer("warmup question", truncate=True)[0].astype(np.int32)
        for d in self.store.dirs.values():
            for f in sorted(d.glob("*.npy"))[:1]:
                try:
                    return self.store.get(f.stem), tokens
                except FileNotFoundError:
                    pass
        t = int(self.cfg.data.get("num_frames", 60) or 60)
        rng = np.random.default_rng(0)
        dims = {"audio": (t, self.model_cfg["audio_dim"]),
                "video": (t, self.model_cfg["video_dim"]),
                "patch": (t, 14, self.model_cfg["patch_dim"])}
        feats = {key: rng.standard_normal(dims[key]).astype(np.float32)
                 for key in self.store.dirs}
        return feats, tokens

    def _dispatch(self, rows) -> Inflight:
        """rows: list of dicts {tokens, video, slot, feats}. Pads to
        batch_size with the first row (its tokens, its features, its cache
        slot) and queues ONE forward, its fp32 softmax and the
        probabilities' copy to the host; returns the batch in flight WITHOUT
        waiting for it, so the batcher can assemble the next batch while
        this one runs."""
        pad = self.batch_size - len(rows)
        quest = np.stack([r["tokens"] for r in rows]
                         + [rows[0]["tokens"]] * pad)
        inputs = [self._host(quest)]
        with self._on_card(), torch.inference_mode():
            batch = {"quest": inputs[0].to(self.device, non_blocking=True).long()}
            if self.cache_cap and self._dev_slots \
                    and all(r["slot"] is not None for r in rows):
                # gather the batch from the card-resident feature buffers;
                # only the token ids and the slots crossed the host boundary
                idx = self._host(np.array([r["slot"] for r in rows]
                                          + [rows[0]["slot"]] * pad, np.int64))
                inputs.append(idx)
                with self._cache_lock:
                    bufs = dict(self._dev_bufs)
                slots = idx.to(self.device, non_blocking=True)
                for key, buf in bufs.items():
                    batch[key] = buf.index_select(0, slots)
                self.stats["cached_batches"] += 1
            else:
                feats = [r["feats"] or self.store.get(r["video"]) for r in rows]
                feats += [feats[0]] * pad
                for key in feats[0]:
                    # staged in the serving dtype (half the bytes of fp32
                    # in bf16), pinned, copied without waiting
                    stage = torch.empty((self.batch_size, *feats[0][key].shape),
                                        dtype=self.dtype, pin_memory=self._cuda)
                    for i, f in enumerate(feats):
                        stage[i].copy_(torch.from_numpy(f[key]))
                    inputs.append(stage)
                    batch[key] = stage.to(self.device, non_blocking=True)
            probs = torch.softmax(self.model(batch)["out"].float(), dim=-1)
            if not self._cuda:
                return Inflight(probs, None, inputs)
            host = torch.empty(probs.shape, dtype=torch.float32, pin_memory=True)
            host.copy_(probs, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return Inflight(host, event, inputs)

    def _step(self, rows):
        """Synchronous dispatch and materialisation (the warm-up path)."""
        return np.asarray(self._dispatch(rows))[:len(rows)]

    def _run(self):
        # warm-up with a full batch (the kernel library builds or loads at
        # its first launch here; the cached path runs the same kernels, so
        # unlike a compiled graph it needs no warm-up of its own), then open
        # for business. A failure here
        # (corrupt feature file, a kernel that does not build, no memory)
        # must not silently kill the thread: it is recorded, so /health and
        # every pending future report the error instead of hanging.
        try:
            start = time.perf_counter()
            feats, tokens = self._example_rows()
            self._step([{"tokens": tokens, "video": None, "slot": None,
                         "feats": feats}] * self.batch_size)
            self.timings["warmup_s"] = time.perf_counter() - start
        except Exception as exc:
            self.failed = f"{type(exc).__name__}: {exc}"
            self.ready.set()  # unblock health checks; they report failure
            while not self._stop.is_set():
                try:
                    _, futs = self._get_item(timeout=0.25)
                except queue.Empty:
                    continue
                for fut in futs:
                    fut["error"] = self.failed
                    fut["event"].set()
            self._fail_waiters([], self.failed)
            return
        self.ready.set()
        # rows accepted but not yet dispatched. A bulk enqueue
        # (predict_many) lands as ONE queue item, so a client-side batch
        # fills a device batch in a single get() instead of racing the fill
        # window one row at a time.
        pending_rows: list = []
        pending_futs: list = []
        while not self._stop.is_set():
            if not pending_rows:
                try:
                    rows, futs = self._get_item(timeout=0.25)
                except queue.Empty:
                    continue
                pending_rows.extend(rows)
                pending_futs.extend(futs)
            deadline = time.monotonic() + self.max_wait
            while len(pending_rows) < self.batch_size:
                if self._stop.is_set():
                    break
                remaining = min(deadline - time.monotonic(), 0.25)
                if remaining <= 0:
                    break
                try:
                    rows, futs = self._get_item(timeout=remaining)
                except queue.Empty:
                    if time.monotonic() >= deadline:
                        break
                    continue
                pending_rows.extend(rows)
                pending_futs.extend(futs)
            if self._stop.is_set():
                break  # pending rows fail fast via the drain below
            rows = pending_rows[:self.batch_size]
            futures = pending_futs[:self.batch_size]
            del pending_rows[:self.batch_size]
            del pending_futs[:self.batch_size]
            try:
                handle = self._dispatch(rows)
            except Exception as exc:
                for fut in futures:
                    fut["error"] = str(exc)
                    fut["event"].set()
                continue
            # hand the batch in flight to the completer and go straight back
            # to assembling the next one: the card's work and the result
            # fetch overlap with the host's batch assembly
            placed = False
            while not self._stop.is_set():
                try:
                    self._inflight.put((handle, futures), timeout=0.25)
                    placed = True
                    break
                except queue.Full:
                    continue
            if not placed:  # stopped mid-handoff: the completer will never
                pending_futs.extend(futures)  # see this batch; fail it too
        # shutdown: fail fast everything still waiting on this thread, rows
        # buffered here and items still in the queue alike
        self._fail_waiters(pending_futs, "shutting down")

    def _fail_waiters(self, futs, reason):
        """Complete the given futures AND everything left in the request
        queue with an error, so that predict/predict_many callers unblock at
        once instead of riding out the 120 s _await timeout."""
        futs = list(futs)
        while True:
            try:
                _, more = self._get_item(timeout=0)
            except queue.Empty:
                break
            futs.extend(more)
        for fut in futs:
            fut.setdefault("error", reason)
            fut["event"].set()

    def _get_item(self, timeout):
        """Pop one queue item as (rows, futures) lists. Accepts both the
        bulk form ([rows], [futs]) that predict/predict_many enqueue and a
        bare (row_dict, fut) pair."""
        rows, futs = self.queue.get(timeout=timeout)
        if isinstance(rows, dict):
            return [rows], [futs]
        return rows, futs

    def _complete(self):
        """Materialise the batches in flight in FIFO order and fan the
        answers out. ``np.asarray`` waits for the batch's event; it runs
        OFF the batcher thread, which keeps the card fed meanwhile, and
        queues no card work of its own."""
        while not self._stop.is_set():
            try:
                handle, futures = self._inflight.get(timeout=0.25)
            except queue.Empty:
                continue
            # stats BEFORE the events: a client that polls /stats right
            # after its answer arrives must see its own batch counted
            self.stats["served"] += len(futures)
            self.stats["batches"] += 1
            self.stats["rows"] += self.batch_size
            try:
                probs = np.asarray(handle)
                for i, fut in enumerate(futures):
                    fut["probs"] = probs[i]
                    fut["event"].set()
            except Exception as exc:  # a device-side error surfaces here
                for fut in futures:
                    fut["error"] = str(exc)
                    fut["event"].set()
        # shutdown: batches still in flight never materialise; unblock their
        # waiters instead of stranding them on the _await timeout
        while True:
            try:
                _, futures = self._inflight.get_nowait()
            except queue.Empty:
                break
            for fut in futures:
                fut.setdefault("error", "shutting down")
                fut["event"].set()

    # ------------------------------------------------------------------
    def _tokens(self, question: str) -> np.ndarray:
        """The question's 77 token ids as int32 (the BPE vocabulary fits),
        cached; ``ValueError`` if it does not fit ``text_ctx``."""
        with self._tok_lock:
            hit = self._tok_cache.get(question)
        if hit is not None:
            return hit
        tokens = self.tokenizer(question, truncate=True)[0].astype(np.int32)
        check_text_ctx(tokens[None], self.model_cfg.get("text_ctx"))
        with self._tok_lock:
            if len(self._tok_cache) > 65536:
                self._tok_cache.clear()
            self._tok_cache[question] = tokens
        return tokens

    def _slot_for(self, video_id: str):
        """Device-cache slot for a video (inserted on first use; None when
        the cache is full or off). The insert is queued on the service's
        stream, ahead of every batch that can name the slot."""
        if not self.cache_cap:
            return None
        with self._cache_lock:
            if video_id in self._dev_slots:
                return self._dev_slots[video_id]
        feats = self.store.get(video_id)  # host load outside the lock
        with self._cache_lock:
            if video_id in self._dev_slots:
                return self._dev_slots[video_id]
            if len(self._dev_slots) >= self.cache_cap:
                return None
            slot = len(self._dev_slots)
            with self._on_card():
                if not self._dev_bufs:
                    self._dev_bufs = {
                        k: torch.zeros((self.cache_cap, *v.shape), dtype=self.dtype,
                                       device=self.device) for k, v in feats.items()}
                for k, v in feats.items():
                    src = torch.from_numpy(v).to(self.dtype)
                    if self._cuda:
                        src = src.pin_memory()
                    self._dev_bufs[k][slot].copy_(src, non_blocking=True)
            self._dev_slots[video_id] = slot
            return slot

    def _make_row(self, question: str, video_id: str) -> dict:
        tokens = self._tokens(question)
        slot = self._slot_for(video_id)
        feats = None if slot is not None else self.store.get(video_id)
        return {"tokens": tokens, "video": video_id, "slot": slot,
                "feats": feats}

    def _await(self, fut):
        if not fut["event"].wait(timeout=120):
            raise TimeoutError("batcher did not answer within 120s")
        if "error" in fut:
            raise RuntimeError(fut["error"])
        return fut["probs"]

    def _topk_payload(self, question, video_id, probs, topk):
        return {"question": question, "video": video_id,
                **answer_payload(probs, self.ix2ans, topk)}

    def predict(self, question: str, video_id: str, topk: int):
        fut = {"event": threading.Event()}
        self.queue.put(([self._make_row(question, video_id)], [fut]))
        return self._topk_payload(question, video_id, self._await(fut), topk)

    def predict_many(self, items, topk: int):
        """Enqueue a client-side batch as ONE queue item: the batcher sees
        the whole chunk at once instead of draining it row by row against
        its fill window."""
        rows = [self._make_row(it["question"], it["video"]) for it in items]
        futs = [{"event": threading.Event()} for _ in items]
        self.queue.put((rows, futs))
        return [self._topk_payload(it["question"], it["video"],
                                   self._await(fut), topk)
                for it, fut in zip(items, futs)]

    def shutdown(self):
        """Stop both threads; every waiter left gets an error."""
        self._stop.set()
        for thread in (self._thread, self._completer):
            if thread is not threading.current_thread():
                thread.join(10)


def make_handler(service: Service):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                if service.failed:
                    self._send(500, {"status": "failed",
                                     "error": service.failed})
                elif service.ready.is_set():
                    self._send(200, {"status": "ok",
                                     "batch_size": service.batch_size})
                else:
                    self._send(503, {"status": "compiling"})
            elif self.path == "/stats":
                s = dict(service.stats)
                s["avg_fill"] = round(
                    s["served"] / max(1, s["rows"]), 4)
                self._send(200, s)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                if self.path == "/predict":
                    out = service.predict(
                        req["question"], req["video"],
                        int(req.get("topk", 1)))
                elif self.path == "/predict_batch":
                    out = {"results": service.predict_many(
                        req["items"], int(req.get("topk", 1)))}
                else:
                    self._send(404, {"error": "not found"})
                    return
                self._send(200, out)
            except FileNotFoundError as exc:
                self._send(404, {"error": f"unknown video: {exc}"})
            except Exception as exc:
                self._send(500, {"error": str(exc)})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def _exit_on_sigterm(signum, frame):
    raise SystemExit(0)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    service = Service(args)
    server = ThreadingHTTPServer((args.host, args.port),
                                 make_handler(service))
    if threading.current_thread() is threading.main_thread():
        # SIGTERM ends serve_forever through the finally below
        signal.signal(signal.SIGTERM, _exit_on_sigterm)
    print(json.dumps({"serving": f"http://{args.host}:{args.port}",
                      "batch_size": args.batch_size,
                      "dtype": str(args.dtype)}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
