"""The serving surface of the port (``python -m qa_tiger_tpu_torch.serve``,
``.predict``, ``.bench_serve``) on the CPU at a tiny config
(``platform='cpu'``, a 2-layer text tower registered as ``tiny-serve``),
over real MUSIC-AVQA questions with synthetic features and a merges file the
test writes, held to the JAX package's ``src/serve.py`` and
``src/predict.py`` on a ``best.npz`` the JAX package writes.

Tolerances: probabilities within rtol 1e-4 / atol 1e-5 (``TOY_TOL``, fp32 on
both sides; summation order only); a printed probability (rounded to 4
places) within 1e-4 of the other package's. Every wait is bounded."""
import importlib.util
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from qa_tiger_tpu.data.tokenizer import ClipTokenizer as JClipTokenizer
from qa_tiger_tpu.models import build_model as j_build_model
from qa_tiger_tpu.models import clip_text as j_clip_text
from qa_tiger_tpu.models.qa_tiger import qa_tiger_config as j_config
from qa_tiger_tpu.models.qa_tiger import qa_tiger_init
from qa_tiger_tpu.parallel import make_mesh
from qa_tiger_tpu.training import save_checkpoint as j_save_checkpoint
from qa_tiger_tpu.training.loop import AVQARunner as JRunner
from qa_tiger_tpu.training.loop import merge_params
from qa_tiger_tpu.utils import load_config_module as j_load_config
from qa_tiger_tpu_torch import bench_serve, predict, serve
from qa_tiger_tpu_torch.data.tokenizer import ClipTokenizer
from qa_tiger_tpu_torch.models import clip_text as t_clip_text
from qa_tiger_tpu_torch.predict import Predictor, top_indices
from torch_corpus import val_questions, write_config, write_corpus, write_merges

REPO = Path(__file__).resolve().parents[1]
TOWER = dict(width=32, heads=4, layers=2, embed_dim=32)
MODEL = dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16, topK=2, num_experts=4,
             encoder_type="tiny-serve")
T, P = 8, 3
DIMS = {"vggish": (T, 16), "clip": (T, 32), "tome": (T, P, 24)}
N_QUESTIONS = 24
TOY_TOL = dict(rtol=1e-4, atol=1e-5)
LONG_QUESTION = ("How many types of musical instruments sound in the video? "
                 "Is the <Object> louder than the <Object>?")
TEXT_CTX = 16
WAIT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 val questions on their videos, a merges file, and a best.npz the
    JAX package writes from its own init of the tiny model."""
    root = tmp_path_factory.mktemp("serve")
    write_corpus(root / "data", {"serve": (0, N_QUESTIONS)}, DIMS)
    write_merges(root / "vocab.txt.gz", [q["question_content"] for q in val_questions()], 300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-serve", TOWER)
        params = qa_tiger_init(jax.random.PRNGKey(7), j_config(num_labels=42, **MODEL))
    j_save_checkpoint(params, root / "best.npz")
    return root


@pytest.fixture(autouse=True)
def _tiny(corpus, monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-serve", TOWER)
    monkeypatch.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-serve", TOWER)
    monkeypatch.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))


def config(corpus, name, subprocess_tower=False, **model) -> Path:
    """A config over the corpus (platform 'cpu' unless ``platform=None`` is
    given); with ``subprocess_tower`` the file itself registers the tiny
    tower, for a server in another process."""
    platform = model.pop("platform", "cpu")
    path = write_config(corpus / f"{name}.py", corpus / "data", corpus / f"out_{name}",
                        {**MODEL, **model}, platform=platform)
    if subprocess_tower:
        path.write_text("import qa_tiger_tpu_torch.models.clip_text as _ct\n"
                        f"_ct.CLIP_TEXT_CONFIGS.setdefault('tiny-serve', {TOWER!r})\n"
                        + path.read_text())
    return path


def requests(n, start=0):
    """(question, video) pairs of the corpus: mixed questions and videos."""
    qs = val_questions()[:N_QUESTIONS]
    return [(qs[(start + i) % N_QUESTIONS]["question_content"],
             qs[(start + 7 * i) % N_QUESTIONS]["video_id"]) for i in range(n)]


def port_service(cfg, weight="", batch_size=4, device_cache=0, max_wait_ms=5.0):
    svc = serve.Service(SimpleNamespace(config=str(cfg), weight=str(weight),
                                        batch_size=batch_size, max_wait_ms=max_wait_ms,
                                        dtype="float32", device_cache=device_cache))
    assert svc.ready.wait(timeout=WAIT_S), "the port's service never became ready"
    return svc


def jax_service(cfg, weight="", batch_size=4):
    spec = importlib.util.spec_from_file_location("qa_serve_jax", REPO / "src" / "serve.py")
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    svc = entry.Service(SimpleNamespace(config=str(cfg), weight=str(weight),
                                        batch_size=batch_size, max_wait_ms=5.0,
                                        dtype="float32", device_cache=0))
    assert svc.ready.wait(timeout=WAIT_S), "the JAX service never became ready"
    assert svc.failed is None, svc.failed
    return svc


def jax_direct_probs(cfg_path, weight, pairs):
    """The JAX model on ``weight``, one jitted forward per request (a batch
    of 1): its fp32 probabilities."""
    from qa_tiger_tpu.training import load_checkpoint

    cfg = j_load_config(str(cfg_path))
    model_cfg, init_fn, forward_fn, frozen = j_build_model(
        cfg.hyper_params.model_type, cfg.hyper_params.model, num_labels=42)
    runner = JRunner(cfg, model_cfg, init_fn, forward_fn, frozen,
                     mesh=make_mesh(1, devices=jax.devices("cpu")), seed=int(cfg.seed))
    params, _, _ = load_checkpoint(str(weight), runner.params)
    runner.load_params(params)
    params = merge_params(runner.trainable, runner.frozen)
    fwd = jax.jit(lambda p, b: jax.nn.softmax(
        forward_fn(p, b, runner.model_cfg, train=False)["out"].astype(np.float32)))
    tok = JClipTokenizer()
    data = corpus_root(cfg_path) / "data"
    out = []
    for question, video in pairs:
        batch = {"audio": np.load(data / "vggish" / f"{video}.npy")[None],
                 "video": np.load(data / "clip" / f"{video}.npy")[None],
                 "patch": np.load(data / "tome" / f"{video}.npy")[None],
                 "quest": tok(question, truncate=True).astype(np.int64)}
        out.append(np.asarray(fwd(params, runner._device_batch(batch)))[0])
    return out


def corpus_root(cfg_path) -> Path:
    return Path(cfg_path).parent


# ---------------------------------------------------------------------------
# (1) the HTTP round trip against python -m qa_tiger_tpu_torch.serve
# ---------------------------------------------------------------------------

def _post(base, path, payload):
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


def test_http_round_trip_matches_jax_direct_forward(corpus):
    """8 concurrent /predict and one /predict_batch against the port's
    server (gather_mode 'paper': a row's answer does not depend on its batch
    mates) on the JAX package's best.npz: the answers and probabilities of
    JAX's direct batch-of-1 forward; /stats shows batching; an unknown video
    answers 404; SIGTERM ends the server."""
    cfg = config(corpus, "http", subprocess_tower=True, gather_mode="paper")
    port = _free_port()
    env = dict(os.environ, QA_TIGER_BPE_VOCAB=str(corpus / "vocab.txt.gz"),
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "qa_tiger_tpu_torch.serve", "--config", str(cfg),
         "--weight", str(corpus / "best.npz"), "--port", str(port), "--batch-size", "4",
         "--max-wait-ms", "200"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + WAIT_S
        while True:
            assert proc.poll() is None, f"server died: {proc.stdout.read()[-3000:]}"
            assert time.monotonic() < deadline, "server never became healthy"
            try:
                with urllib.request.urlopen(base + "/health", timeout=5) as r:
                    if r.status == 200:
                        break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)

        pairs = requests(8)
        results, errors = [None] * len(pairs), []

        def worker(i):
            try:
                results[i] = _post(base, "/predict", {"question": pairs[i][0],
                                                      "video": pairs[i][1], "topk": 3})
            except Exception as exc:  # pragma: no cover
                errors.append((i, exc))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(pairs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not errors, errors
        batch = _post(base, "/predict_batch", {"items": [{"question": q, "video": v}
                                                         for q, v in pairs[:3]], "topk": 3})
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["served"] == len(pairs) + 3
        assert stats["batches"] >= 3 and stats["avg_fill"] > 0

        want = jax_direct_probs(cfg, corpus / "best.npz", pairs)
        names = json.loads((corpus / "data" / "answer2idx.json").read_text())["ans2ix"]
        ix2ans = {i: a for a, i in names.items()}
        for res, (q, v), p in zip(results + batch["results"], pairs + pairs[:3],
                                  want + want[:3]):
            assert (res["question"], res["video"]) == (q, v)
            assert res["answer"] == ix2ans[int(np.argmax(p))]
            for item in res["topk"]:
                i = names[item["answer"]]
                assert abs(item["prob"] - p[i]) <= 1e-4, (item, p[i])

        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/predict", {"question": "q", "video": "nope"})
        assert err.value.code == 404
        proc.terminate()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()


# ---------------------------------------------------------------------------
# (2) the port's Service._step against the JAX Service._step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_pair(corpus):
    """The two packages' services on one best.npz, gather_mode 'reference'
    (the default), fp32, batch 6."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-serve", TOWER)
        mp.setitem(j_clip_text.CLIP_TEXT_CONFIGS, "tiny-serve", TOWER)
        mp.setenv("QA_TIGER_BPE_VOCAB", str(corpus / "vocab.txt.gz"))
        cfg = config(corpus, "reference")
        port = port_service(cfg, corpus / "best.npz", batch_size=6)
        jsvc = jax_service(cfg, corpus / "best.npz", batch_size=6)
    yield port, jsvc
    port.shutdown()
    jsvc.shutdown()


@pytest.mark.parametrize("n_rows", [6, 4], ids=["full", "padded"])
def test_step_matches_jax_service(reference_pair, n_rows):
    """A full and a padded batch of mixed questions and videos: the same
    tokens, and probabilities within TOY_TOL, padding rule included (under
    'reference' a row's output depends on its batch mates)."""
    port, jsvc = reference_pair
    pairs = requests(n_rows, start=3)
    p_rows = [port._make_row(q, v) for q, v in pairs]
    j_rows = [jsvc._make_row(q, v) for q, v in pairs]
    for a, b in zip(p_rows, j_rows):
        assert a["tokens"].dtype == np.int32 and np.array_equal(a["tokens"], b["tokens"])
    got, want = port._step(p_rows), jsvc._step(j_rows)
    assert got.shape == want.shape == (n_rows, 42)
    np.testing.assert_allclose(got, want, **TOY_TOL)
    # and the padding matters: the rows alone in a batch of their own differ
    alone = port._step(p_rows[1:2])
    assert not np.allclose(alone[0], got[1], **TOY_TOL)


# ---------------------------------------------------------------------------
# (3) device cache against host path
# ---------------------------------------------------------------------------

def test_device_cache_path_equals_host_path(corpus):
    """Rows that all have a cache slot take the gather path; it gives the
    host path's probabilities bitwise, on a full and a padded batch. A video
    past the cache's capacity gets no slot, and its batch takes the host
    path (``cached_batches`` counts only gathered batches)."""
    svc = port_service(config(corpus, "cache"), corpus / "best.npz", batch_size=4,
                       device_cache=2)
    try:
        vids = sorted({q["video_id"] for q in val_questions()[:N_QUESTIONS]})[:3]
        qs = [q["question_content"] for q in val_questions()[:4]]
        cached = [svc._make_row(qs[i], vids[i % 2]) for i in range(4)]
        assert [r["slot"] for r in cached] == [0, 1, 0, 1]
        assert svc._dev_bufs["patch"].shape == (2, T, P, 24)
        host = [dict(r, slot=None, feats=svc.store.get(r["video"])) for r in cached]
        for n in (4, 3):
            before = svc.stats["cached_batches"]
            got = svc._step(cached[:n])
            assert svc.stats["cached_batches"] == before + 1
            want = svc._step(host[:n])
            assert svc.stats["cached_batches"] == before + 1
            assert np.array_equal(got, want), n
        full = svc._make_row(qs[0], vids[2])
        assert full["slot"] is None and full["feats"] is not None
        before = svc.stats["cached_batches"]
        mixed = svc._step([cached[0], full])
        assert svc.stats["cached_batches"] == before
        assert np.array_equal(mixed, svc._step([host[0], dict(full)]))
        out = svc.predict_many([{"question": qs[i], "video": vids[i % 3]} for i in range(4)],
                               topk=2)
        assert len(out) == 4 and svc.stats["served"] == 4
    finally:
        svc.shutdown()


# ---------------------------------------------------------------------------
# (4)-(7) the batcher: ports of tests/test_serve.py's internals tests
# ---------------------------------------------------------------------------

def _tiny_service(tmp_path, batch_size=2):
    """A ready port Service over a 1-layer tower (CPU platform), cheap
    enough for the batcher's internals."""
    data = tmp_path / "data"
    rng = np.random.default_rng(0)
    for sub, shape in DIMS.items():
        (data / sub).mkdir(parents=True)
        np.save(data / sub / "va.npy", rng.standard_normal(shape).astype(np.float32))
    (data / "answer2idx.json").write_text(json.dumps(
        {"ans2ix": {"one": 0, "two": 1}, "max_que_len": 24}))
    cfg = write_config(tmp_path / "cfg.py", data, tmp_path / "out",
                       {**MODEL, "encoder_type": "tiny-serve-p"}, platform="cpu")
    svc = port_service(cfg, batch_size=batch_size)
    assert svc.failed is None, svc.failed
    return svc


@pytest.fixture
def tiny_tower(monkeypatch):
    monkeypatch.setitem(t_clip_text.CLIP_TEXT_CONFIGS, "tiny-serve-p",
                        dict(width=32, heads=4, layers=1, embed_dim=32))


def test_warmup_failure_surfaces(tmp_path, tiny_tower):
    """A corrupt feature file during warm-up does not kill the batcher
    silently: the Service records the error, /health reports 'failed' (500),
    and a queued request fails fast instead of hanging."""
    data = tmp_path / "data"
    (data / "vggish").mkdir(parents=True)
    (data / "vggish" / "va.npy").write_bytes(b"not an npy file")
    (data / "answer2idx.json").write_text(json.dumps(
        {"ans2ix": {"one": 0, "two": 1}, "max_que_len": 24}))
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
config = dict(
    type='qa-tiger', seed=3, num_labels=2, weight='',
    data=dict(root='{data.as_posix()}', num_frames={T}, frame_sample_rate=1,
              ans_quelen='answer2idx.json', audio_feat='vggish',
              video_feat=None, patch_feat=None),
    hyper_params=dict(platform='cpu', model_type='QA-TIGER_tiny',
        model=dict(d_model=32, video_dim=32, patch_dim=24, audio_dim=16,
                   topK=2, num_experts=3, encoder_type='tiny-serve-p'),
        optim=dict(lr=1e-3, betas=(0.95, 0.999), weight_decay=0),
        sched=dict(name='StepLR', step_size=8, gamma=0.1)),
)
""")
    svc = port_service(cfg, batch_size=2)
    try:
        assert svc.failed is not None
        handler = serve.make_handler(svc)
        sent = {}
        fake = SimpleNamespace(path="/health", _send=lambda code, payload: sent.update(
            code=code, payload=payload))
        handler.do_GET(fake)
        assert sent["code"] == 500 and sent["payload"]["status"] == "failed"
        fut = {"event": threading.Event()}
        svc.queue.put(({"tokens": np.zeros(77, np.int32), "video": "va", "slot": None,
                        "feats": None}, fut))
        start = time.perf_counter()
        with pytest.raises(RuntimeError):
            svc._await(fut)
        assert time.perf_counter() - start < 5
    finally:
        svc.shutdown()


def test_bulk_enqueue_fills_batches(tmp_path, tiny_tower):
    """predict_many lands its whole chunk as ONE queue item, and the batcher
    carves full batches out of its pending rows: 5 rows at batch_size 2 give
    dispatches of 2/2/1 even with a zero fill window, and FIFO answers."""
    svc = _tiny_service(tmp_path, batch_size=2)
    try:
        svc.max_wait = 0.0
        dispatched = []

        def fake_dispatch(rows):
            dispatched.append(len(rows))
            base = sum(dispatched[:-1])
            out = np.zeros((svc.batch_size, 2), np.float32)
            for i in range(len(rows)):
                out[i, (base + i) % 2] = 1.0
            return serve.Inflight(torch.from_numpy(out))

        svc._dispatch = fake_dispatch
        out = svc.predict_many([{"question": f"q{i}", "video": "va"} for i in range(5)],
                               topk=1)
        assert [len(r["topk"]) for r in out] == [1] * 5
        assert dispatched == [2, 2, 1], dispatched
        assert [r["answer"] for r in out] == ["one", "two", "one", "two", "one"]
    finally:
        svc.shutdown()


def test_shutdown_fails_pending_waiters_fast(tmp_path, tiny_tower):
    """Rows buffered in the batcher (a partial batch in its fill window) or
    still in the queue at shutdown are completed with an error at once."""
    svc = _tiny_service(tmp_path, batch_size=4)
    svc.max_wait = 30.0
    futs = [{"event": threading.Event()} for _ in range(3)]
    row = {"tokens": np.zeros(77, np.int32), "video": "va", "slot": None, "feats": None}
    svc.queue.put(([row], [futs[0]]))
    time.sleep(0.6)  # the batcher is in its fill window now
    svc.queue.put(([row, row], futs[1:]))
    start = time.perf_counter()
    svc.shutdown()
    for f in futs:
        assert f["event"].wait(timeout=5), "waiter stranded at shutdown"
        assert f.get("error"), f
    assert time.perf_counter() - start < 5


def test_pipelined_batcher_overlap_order_and_errors(tmp_path, tiny_tower):
    """The batcher keeps dispatching while earlier batches wait to be
    materialised (up to 3 in flight), answers come back in FIFO row order,
    and an error that surfaces only at materialisation fails exactly that
    batch's futures."""
    svc = _tiny_service(tmp_path, batch_size=2)
    try:
        svc.max_wait = 5.0
        gate = threading.Event()
        dispatched = []

        class Deferred:
            """The handle's materialisation, faked: blocks until the gate
            opens, or raises (tag 'boom')."""

            def __init__(self, tag, batch_size):
                self.tag, self.n = tag, batch_size

            def __array__(self, dtype=None, copy=None):
                if not gate.wait(timeout=60):  # pragma: no cover
                    raise TimeoutError("gate never opened")
                if self.tag == "boom":
                    raise RuntimeError("device exploded at fetch")
                return np.full((self.n, 2), float(self.tag), np.float32)

        def fake_dispatch(rows):
            tag = "boom" if rows[0]["tokens"][0] == 99 else len(dispatched)
            dispatched.append(len(rows))
            return Deferred(tag, svc.batch_size)

        svc._dispatch = fake_dispatch

        def enqueue(first_token=0):
            fut = {"event": threading.Event()}
            svc.queue.put(({"tokens": np.full(77, first_token, np.int32), "video": "va",
                            "slot": None, "feats": None}, fut))
            return fut

        futs = [enqueue() for _ in range(6)]
        deadline = time.monotonic() + 30
        while len(dispatched) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert len(dispatched) == 3, f"batcher stalled behind the completer: {dispatched}"
        assert not any(f["event"].is_set() for f in futs)
        gate.set()
        probs = [svc._await(f) for f in futs]
        for i, p in enumerate(probs):
            assert p[0] == float(i // 2), (i, p)
        bad = [enqueue(first_token=99) for _ in range(2)]
        good = [enqueue() for _ in range(2)]
        with pytest.raises(RuntimeError, match="device exploded"):
            svc._await(bad[0])
        with pytest.raises(RuntimeError):
            svc._await(bad[1])
        for f in good:
            assert svc._await(f)[0] == 4.0
        assert svc.stats["batches"] == 5 and svc.stats["served"] == 10
    finally:
        svc.shutdown()


def test_inflight_handle_materialises_the_probabilities():
    """On the CPU the handle holds the probabilities themselves (no event);
    ``np.asarray`` gives them, in the asked dtype."""
    probs = torch.softmax(torch.randn(4, 42), -1)
    handle = serve.Inflight(probs)
    assert np.array_equal(np.asarray(handle), probs.numpy())
    assert np.asarray(handle, dtype=np.float64).dtype == np.float64


# ---------------------------------------------------------------------------
# (8) text_ctx, (9) ranking, (10) predict.main, (11) no card, (12) bench
# ---------------------------------------------------------------------------

def _jax_predict_entry():
    spec = importlib.util.spec_from_file_location("qa_predict_jax", REPO / "src" / "predict.py")
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    return entry


def test_text_ctx_is_refused_where_jax_refuses(corpus, monkeypatch):
    """text_ctx=16: a question whose EOT sits at or past position 16 raises
    ValueError in Predictor (before the forward), in the Service's
    tokenizer and in predict.main, as in the JAX server and src/predict.py;
    a question that fits is answered."""
    cfg = config(corpus, "ctx", text_ctx=TEXT_CTX)
    video = val_questions()[0]["video_id"]
    tokens = ClipTokenizer()(LONG_QUESTION, truncate=True)
    assert int(tokens.argmax(-1)[0]) >= TEXT_CTX
    short = ClipTokenizer()("where?", truncate=True)
    assert int(short.argmax(-1)[0]) < TEXT_CTX

    pred = Predictor(cfg, device="cpu", dtype=torch.float32)
    feats = predict.load_features(j_load_config(str(cfg)), video)
    with pytest.raises(ValueError, match=f"text_ctx={TEXT_CTX}"):
        pred.answer({**feats, "quest": tokens})
    assert len(pred.answer({**feats, "quest": short})) == 1

    svc = port_service(cfg, batch_size=2)
    jsvc = jax_service(cfg, batch_size=2)
    try:
        with pytest.raises(ValueError, match=f"text_ctx={TEXT_CTX}"):
            svc._make_row(LONG_QUESTION, video)
        with pytest.raises(ValueError, match=f"text_ctx={TEXT_CTX}"):
            jsvc._make_row(LONG_QUESTION, video)
        assert svc._make_row("where?", video)["tokens"].shape == (77,)
    finally:
        svc.shutdown()
        jsvc.shutdown()

    argv = ["--config", str(cfg), "--video", video, "--question", LONG_QUESTION]
    with pytest.raises(ValueError, match=f"text_ctx={TEXT_CTX}"):
        predict.main(argv)
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    with pytest.raises(ValueError, match=f"text_ctx={TEXT_CTX}"):
        _jax_predict_entry().main()


def test_ranking_puts_the_lower_index_first_on_ties(corpus, monkeypatch):
    """Equal probabilities rank by index (np.argmax's top-1) in
    ``top_indices``, ``Predictor.answer`` and the server's payload."""
    probs = np.array([0.1, 0.3, 0.3, 0.1, 0.2], np.float32)
    assert top_indices(probs, 5).tolist() == [1, 2, 4, 0, 3]
    assert top_indices(np.stack([probs, probs[::-1]]), 2).tolist() == [[1, 2], [2, 3]]

    pred = Predictor(config(corpus, "ties"), device="cpu", dtype=torch.float32)
    tied = torch.zeros(3, 42)
    tied[1, [5, 9, 30]] = 2.0
    monkeypatch.setattr(pred, "logits", lambda batch: tied)
    out = pred.answer({}, topk=4)
    ranked = [[pred.ix2ans[i] for i in ids] for ids in ([0, 1, 2, 3], [5, 9, 30, 0],
                                                        [0, 1, 2, 3])]
    assert [[t["answer"] for t in row["topk"]] for row in out] == ranked
    assert [row["answer"] for row in out] == [pred.ix2ans[int(np.argmax(r))]
                                              for r in tied.numpy()]
    payload = serve.Service._topk_payload(SimpleNamespace(ix2ans=pred.ix2ans), "q", "v",
                                          torch.softmax(tied[1], -1).numpy(), 4)
    assert [t["answer"] for t in payload["topk"]] == ranked[1]


def test_predict_main_matches_jax_predict(corpus, capsys, monkeypatch):
    """python -m qa_tiger_tpu_torch.predict and src/predict.py on the same
    best.npz, question and video: the same JSON line, probabilities within
    1e-4."""
    cfg = config(corpus, "predict")
    q = val_questions()[2]
    argv = ["--config", str(cfg), "--weight", str(corpus / "best.npz"),
            "--video", q["video_id"], "--question", q["question_content"], "--topk", "5"]
    got = predict.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    monkeypatch.setattr(sys, "argv", ["predict.py", *argv])
    _jax_predict_entry().main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [got[k] for k in ("question", "video", "answer")] == \
        [want[k] for k in ("question", "video", "answer")]
    assert [t["answer"] for t in got["topk"]] == [t["answer"] for t in want["topk"]]
    for a, b in zip(got["topk"], want["topk"]):
        assert abs(a["prob"] - b["prob"]) <= 1e-4, (a, b)


def _tiny_bench(monkeypatch, cfg):
    """bench_serve's module constants at a tiny size, over ``cfg``'s model."""
    for name, value in (("CONFIG", cfg), ("T", 4), ("P", 3), ("N_VIDEOS", 3)):
        monkeypatch.setattr(bench_serve, name, value)


def test_without_a_card_serve_and_predict_raise_first(corpus, monkeypatch):
    """No platform and no CUDA device: serve.main raises before the socket
    is bound (the port stays free), predict.main before it builds a model;
    bench_serve likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config(corpus, "nocard", platform=None)
    _tiny_bench(monkeypatch, cfg)
    port = _free_port()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--config", str(cfg), "--port", str(port)])
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))  # nothing holds it
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.main(["--config", str(cfg), "--video", "v", "--question", "q"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_serve.main(["--batch", "2", "--requests", "2"])


def test_bench_serve_prints_its_line(corpus, capsys, monkeypatch):
    """bench_serve at a tiny size on the CPU (its constants patched to a
    tiny config with platform 'cpu'): one JSON line, every request
    answered, batches full, the device cache used."""
    _tiny_bench(monkeypatch, config(corpus, "bench"))
    got = bench_serve.main(["--batch", "4", "--requests", "16", "--threads", "2",
                            "--dtype", "float32", "--device-cache", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got
    assert got["requests"] == 16 and got["batches"] == 4 and got["avg_fill"] == 1.0
    assert got["cached_batches"] == 4 and got["cached_videos"] == 3
    assert got["value"] > 0 and got["server_side_qps"] > 0 and got["dtype"] == "float32"
